"""sfmrecon up to the prebundle (reference: apps/sfmrecon/sfmrecon.cc;
port of mve_tpu/apps/sfmrecon.py, lines 102-250).

features -> all-pairs matching with RANSAC -> prebundle.sfm. A scene
that already has a prebundle is left alone. Incremental SfM (skip_sfm
False) is not ported yet: ROADMAP.md, queue A items 5-7 (the next slice)
port it, starting from this prebundle.

    python -m mve_tpu_torch.apps.sfmrecon --skip-sfm <scene> [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys

from .. import resolve_device
from ..core import Scene
from ..utils.timer import WallTimer
from ..sfm.bundler import (
    BatchedMatching, BundlerMatchingOptions, Features, FeaturesOptions,
    Viewport, save_prebundle)

RAND_SEED_MATCHING = 0

# Per-run stage timings and counters (the reference prints these at
# sfmrecon.cc:100-131): features_ms, matching_ms, n_features, plus the
# matcher's stage sizes and RANSAC times.
LAST_TIMINGS: dict = {}


def sfm_reconstruct(scene_path: str, *, max_pixels: int = 6_000_000,
                    video_matching: int = 0,
                    use_lowres_matching: bool = True,
                    skip_sfm: bool = False,
                    original_name: str = "original",
                    undistorted_name: str = "undistorted",
                    prebundle_name: str = "prebundle.sfm",
                    log_file: str = "",
                    verbose: bool = True,
                    device="cuda") -> None:
    """Compute features and verified pairwise matches of a scene and
    write them to <scene>/prebundle.sfm (or an absolute prebundle_name)."""
    if not skip_sfm:
        raise NotImplementedError(
            "incremental SfM is not ported yet (ROADMAP.md queue A items 5-7); "
            "run with skip_sfm=True / --skip-sfm")
    dev = resolve_device(device)
    LAST_TIMINGS.clear()
    scene = Scene(scene_path)
    views = scene.get_views()
    if len(views) < 2:
        raise RuntimeError("Scene has too few views")

    prebundle_path = prebundle_name
    if not os.path.isabs(prebundle_path):
        prebundle_path = os.path.join(scene_path, prebundle_name)
    if os.path.isfile(prebundle_path):
        if verbose:
            print("Prebundle exists; skipping SfM (--skip-sfm).")
        return None
    timer = WallTimer()

    def log_timing(name, ms):
        if log_file:
            # Append-only timing log (sfmrecon.cc:66-85 log_message).
            import time as _time

            with open(log_file, "a") as f:
                f.write(f"{int(_time.time())} {name} {int(ms)}\n")

    viewports = [Viewport() for _ in views]
    if verbose:
        print("Computing image features...")
    features = Features(FeaturesOptions(max_image_size=max_pixels, verbose=verbose), dev)
    imgs, idxs = [], []
    for i, view in enumerate(views):
        if view is None:
            continue
        name = original_name if view.has_image(original_name) else undistorted_name
        img = view.get_image(name)
        if img is None:
            continue
        imgs.append(img)
        idxs.append(i)
    features.compute_batched(imgs, [viewports[i] for i in idxs])
    for i in idxs:
        views[i].cache_cleanup()
    if verbose:
        print(f"Computed features in {timer.get_elapsed()}ms.")
    log_timing("features", timer.get_elapsed())
    LAST_TIMINGS["features_ms"] = timer.get_elapsed()
    LAST_TIMINGS["n_features"] = int(sum(len(vp.positions) for vp in viewports))

    timer.reset()
    if verbose:
        print("Performing feature matching...")
    matcher = BatchedMatching(BundlerMatchingOptions(
        use_lowres_matching=use_lowres_matching,
        max_num_pairs_per_view=video_matching,
        verbose=verbose), dev)
    pairwise_matching = matcher.compute(viewports, seed=RAND_SEED_MATCHING)
    if verbose:
        print(f"Matching took {timer.get_elapsed()}ms; "
              f"{len(pairwise_matching)} connected pairs.")
    log_timing("matching", timer.get_elapsed())
    LAST_TIMINGS["matching_ms"] = timer.get_elapsed()
    LAST_TIMINGS.update(matcher.last_stats)
    LAST_TIMINGS["n_connected_pairs"] = len(pairwise_matching)
    save_prebundle(viewports, pairwise_matching, prebundle_path)
    if verbose:
        print("Prebundle computed; skipping SfM (--skip-sfm).")
    return None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="sfmrecon", description="Features and pairwise matching up to "
                                     "the prebundle (incremental SfM is not ported yet).")
    p.add_argument("scene", help="Scene directory")
    p.add_argument("-o", "--original", default="original",
                   help="Original image embedding [original]")
    p.add_argument("-m", "--max-pixels", type=int, default=6_000_000,
                   help="Limit image size for feature detection")
    p.add_argument("-u", "--undistorted", default="undistorted",
                   help="Undistorted image embedding [undistorted]")
    p.add_argument("--prebundle", default="prebundle.sfm",
                   help="Load/store pre-bundle file [prebundle.sfm]")
    p.add_argument("--log-file", default="", help="Log some timings to file []")
    p.add_argument("--no-prediction", action="store_true",
                   help="Disable low-res matchability prediction")
    p.add_argument("--skip-sfm", action="store_true",
                   help="Compute prebundle, skip SfM reconstruction")
    p.add_argument("--video-matching", type=int, default=0,
                   help="Only match to ARG previous frames")
    p.add_argument("--device", default="cuda",
                   help="Device to run on: cuda or cpu [cuda]")
    args = p.parse_args(argv)
    sfm_reconstruct(
        args.scene, max_pixels=args.max_pixels,
        video_matching=args.video_matching,
        use_lowres_matching=not args.no_prediction,
        skip_sfm=args.skip_sfm, original_name=args.original,
        undistorted_name=args.undistorted, prebundle_name=args.prebundle,
        log_file=args.log_file, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
