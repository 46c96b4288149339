"""featurerecon: feature triangulation for scenes with known cameras
(reference: apps/featurerecon/featurerecon.cc; port of
mve_tpu/apps/featurerecon.py).

Detects features view by view (Features.compute_viewport), matches pairs
with the per-pair matcher (kernel B1 on the card: bf16 for 128-D SIFT,
float32 for 64-D SURF), builds tracks and triangulates them with the
existing per-view cameras (no pose estimation), ending with points-only
bundle adjustment, and writes a new bundle. The guided-matching use case
for pre-calibrated rigs.

    python -m mve_tpu_torch.apps.featurerecon [--device cpu] <scene>
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .. import resolve_device
from ..core import Scene
from ..sfm.bundler import (Features, FeaturesOptions, Matching,
                           BundlerMatchingOptions, Tracks, TracksOptions, Viewport,
                           load_prebundle, save_prebundle)
from ..sfm.bundler.incremental import Incremental, IncrementalOptions
from ..sfm.pose import CameraPose


def feature_reconstruct(scene_path: str, *, image_name: str = "undistorted",
                        max_pixels: int = 6_000_000,
                        prebundle_path: str = "", verbose: bool = True,
                        device="cuda"):
    dev = resolve_device(device)
    scene = Scene(scene_path)
    views = scene.get_views()

    if prebundle_path and os.path.isfile(prebundle_path):
        if verbose:
            print(f"Loading prebundle {prebundle_path}...")
        viewports, pairwise = load_prebundle(prebundle_path)
    else:
        viewports = [Viewport() for _ in views]
        features = Features(FeaturesOptions(max_image_size=max_pixels,
                                            verbose=verbose), dev)
        for i, view in enumerate(views):
            if view is None or not view.has_image(image_name):
                continue
            features.compute_viewport(view.get_image(image_name), viewports[i])
            view.cache_cleanup()

        matcher = Matching(BundlerMatchingOptions(verbose=verbose), dev)
        pairwise = matcher.compute(viewports)
        if prebundle_path:
            save_prebundle(viewports, pairwise, prebundle_path)
    tracks = Tracks(TracksOptions(verbose=verbose)).compute(pairwise, viewports)
    if verbose:
        print(f"Created {len(tracks)} tracks.")

    # Install known poses from the views.
    for i, view in enumerate(views):
        if view is None or not view.camera.valid:
            continue
        cam = view.camera
        pose = CameraPose()
        pose.set_k_matrix(float(cam.flen), 0.0, 0.0)
        pose.R = cam.rot.astype(np.float64)
        pose.t = cam.trans.astype(np.float64)
        viewports[i].pose = pose
        viewports[i].focal_length = float(cam.flen)
        viewports[i].radial_distortion[:] = cam.dist

    inc = Incremental(IncrementalOptions(verbose_output=verbose), dev)
    inc.initialize(viewports, tracks)
    inc.triangulate_new_tracks(2)
    inc.invalidate_large_error_tracks()
    inc.bundle_adjustment_points_only()

    bundle = inc.create_bundle()
    scene.set_bundle(bundle)
    scene.save_bundle()
    if verbose:
        print(f"Saved bundle with {bundle.get_num_features()} features.")
    return bundle


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="featurerecon",
                                description="Triangulate features with known cameras.")
    p.add_argument("scene", help="Scene directory")
    p.add_argument("-i", "--image", "-o", "--original", dest="image",
                   default="undistorted",
                   help="Image embedding name [undistorted]")
    p.add_argument("-m", "--max-pixels", type=int, default=6_000_000,
                   help="Limit image size for feature detection")
    p.add_argument("--prebundle", type=str, default="",
                   help="Load/store matching from/to prebundle file")
    p.add_argument("--device", default="cuda",
                   help="Device to run on: cuda or cpu [cuda]")
    args = p.parse_args(argv)
    feature_reconstruct(args.scene, image_name=args.image,
                        max_pixels=args.max_pixels,
                        prebundle_path=args.prebundle, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
