"""sfmrecon: incremental SfM on a scene (reference: apps/sfmrecon/sfmrecon.cc;
port of the single-process path of mve_tpu/apps/sfmrecon.py).

features -> all-pairs matching with RANSAC (cached in prebundle.sfm; a
scene that already has one loads it) -> intrinsics from EXIF or the views
-> tracks -> initial pair -> incremental SfM with bundle adjustment ->
synth_0.out, each view's camera and the undistorted images. With
--skip-sfm it stops at the prebundle.

    python -m mve_tpu_torch.apps.sfmrecon [--device cpu] <scene>

Not ported yet: cascade hashing and the multi-process sharding of
features and pairs (ROADMAP.md queue A item 13), and BA over several
devices (item 14).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from .. import resolve_device
from ..core import Scene
from ..core import image_tools
from ..utils.timer import WallTimer
from ..sfm.bundler import (
    BatchedMatching, BundlerMatchingOptions, Features, FeaturesOptions,
    Intrinsics, IntrinsicsOptions, Viewport, load_prebundle, save_prebundle)
from ..sfm.bundler.common import load_survey
from ..sfm.bundler.intrinsics import IntrinsicsSource
from ..sfm.bundler.pipeline import LAST_PHASE_MS, SfmOptions, run_incremental_sfm

RAND_SEED_MATCHING = 0

# Per-run stage timings and counters (the reference prints these at
# sfmrecon.cc:100-131): features_ms, matching_ms, n_features and the
# matcher's stage sizes and RANSAC times; then incremental_ms,
# incremental_phases, ba_totals, undistort_ms, n_cameras and n_tracks.
LAST_TIMINGS: dict = {}


def _compute_prebundle(views, max_pixels, video_matching, use_lowres_matching,
                       original_name, undistorted_name, dev, verbose, log_timing):
    viewports = [Viewport() for _ in views]
    timer = WallTimer()
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
    return viewports, pairwise_matching


def _undistort_and_save(views, bundle, original_name, undistorted_name, dev):
    """Apply the cameras to the views and write the undistorted images
    (sfmrecon.cc:400-444): one batched warp per image shape; a view
    without distortion copies its original."""
    groups: dict = {}
    for i, view in enumerate(views):
        if view is None:
            continue
        cam = bundle.cameras[i]
        if view.camera.flen == 0.0 and cam.flen == 0.0:
            continue
        view.set_camera(cam)
        if undistorted_name and cam.flen > 0:
            if float(cam.dist[0]) == 0.0 and float(cam.dist[1]) == 0.0:
                # The identity warp: duplicate the original's file.
                if not view.copy_image_file(original_name, undistorted_name):
                    original = view.get_byte_image(original_name)
                    if original is not None:
                        view.set_image(undistorted_name, original)
            else:
                original = view.get_byte_image(original_name)
                if original is not None:
                    groups.setdefault(original.shape, []).append((view, cam, original))
                    continue  # saved after the batched warp
        view.save_view()
        view.cache_cleanup()
    for items in groups.values():
        und = image_tools.image_undistort_k2k4_batch(
            np.stack([orig for _, _, orig in items]),
            [float(c.flen) for _, c, _ in items],
            [float(c.dist[0]) for _, c, _ in items],
            [float(c.dist[1]) for _, c, _ in items], device=dev)
        for (view, _, _), u in zip(items, und):
            view.set_image(undistorted_name, u)
            view.save_view()
            view.cache_cleanup()


def sfm_reconstruct(scene_path: str, *, max_pixels: int = 6_000_000,
                    initial_pair=(-1, -1), video_matching: int = 0,
                    use_lowres_matching: bool = True,
                    fixed_intrinsics: bool = False,
                    intrinsics_from_views: bool = False,
                    always_full_ba: bool = False,
                    normalize: bool = False,
                    skip_sfm: bool = False,
                    track_error_thres_factor: float = 10.0,
                    new_track_error_thres: float = 0.01,
                    min_views_per_track: int = 3,
                    undistorted_name: str = "undistorted",
                    original_name: str = "original",
                    exif_name: str = "exif",
                    prebundle_name: str = "prebundle.sfm",
                    survey_file: str = "",
                    log_file: str = "",
                    verbose_ba: bool = False,
                    verbose: bool = True,
                    device="cuda"):
    """Reconstruct the cameras of a scene. Returns the Incremental (None
    with skip_sfm)."""
    dev = resolve_device(device)
    LAST_TIMINGS.clear()
    scene = Scene(scene_path)
    views = scene.get_views()
    if len(views) < 2:
        raise RuntimeError("Scene has too few views")

    prebundle_path = prebundle_name
    if not os.path.isabs(prebundle_path):
        prebundle_path = os.path.join(scene_path, prebundle_name)
    total_timer = WallTimer()

    def log_timing(name, ms):
        if log_file:
            # Append-only timing log (sfmrecon.cc:66-85 log_message).
            with open(log_file, "a") as f:
                f.write(f"{int(time.time())} {name} {int(ms)}\n")

    if os.path.isfile(prebundle_path):
        if verbose:
            print("Loading prebundle...")
        viewports, pairwise_matching = load_prebundle(prebundle_path)
    else:
        viewports, pairwise_matching = _compute_prebundle(
            views, max_pixels, video_matching, use_lowres_matching, original_name,
            undistorted_name, dev, verbose, log_timing)
        save_prebundle(viewports, pairwise_matching, prebundle_path)

    if skip_sfm:
        if verbose:
            print("Prebundle computed; skipping SfM (--skip-sfm).")
        return None
    if not pairwise_matching:
        raise RuntimeError("No matching image pairs")

    Intrinsics(IntrinsicsOptions(
        intrinsics_source=(IntrinsicsSource.FROM_VIEWS if intrinsics_from_views
                           else IntrinsicsSource.FROM_EXIF),
        exif_embedding=exif_name)).compute(scene, viewports)

    survey_points = None
    if survey_file:
        survey_points = load_survey(survey_file)
        if verbose:
            print(f"Loaded {len(survey_points)} survey points.")

    timer = WallTimer()
    opts = SfmOptions(
        initial_pair=initial_pair,
        min_views_per_track=min_views_per_track,
        always_full_ba=always_full_ba,
        normalize_scene=normalize,
        survey_points=survey_points,
        verbose=verbose)
    opts.incremental_opts.track_error_threshold_factor = track_error_thres_factor
    opts.incremental_opts.new_track_error_threshold = new_track_error_thres
    opts.incremental_opts.ba_fixed_intrinsics = fixed_intrinsics
    opts.incremental_opts.verbose_output = verbose
    opts.incremental_opts.verbose_ba = verbose_ba
    incremental = run_incremental_sfm(viewports, pairwise_matching, opts, dev)
    if verbose:
        print(f"SfM reconstruction took {timer.get_elapsed()}ms.")
    log_timing("sfm", timer.get_elapsed())
    log_timing("total", total_timer.get_elapsed())
    LAST_TIMINGS["incremental_ms"] = timer.get_elapsed()
    LAST_TIMINGS["incremental_phases"] = {
        k: int(v) for k, v in sorted(LAST_PHASE_MS.items())}
    LAST_TIMINGS["ba_totals"] = dict(incremental.ba_totals)

    timer.reset()
    bundle = incremental.create_bundle()
    scene.set_bundle(bundle)
    scene.save_bundle()
    _undistort_and_save(views, bundle, original_name, undistorted_name, dev)
    n_valid = sum(1 for c in bundle.cameras if c.flen > 0)
    LAST_TIMINGS["undistort_ms"] = timer.get_elapsed()
    LAST_TIMINGS["n_cameras"] = int(n_valid)
    LAST_TIMINGS["n_tracks"] = int(bundle.get_num_features())
    if verbose:
        print(f"SfM done: {n_valid}/{len(views)} cameras, "
              f"{bundle.get_num_features()} tracks.")
    return incremental


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sfmrecon",
                                description="Incremental structure-from-motion.")
    p.add_argument("scene", help="Scene directory")
    p.add_argument("-o", "--original", default="original",
                   help="Original image embedding [original]")
    p.add_argument("-e", "--exif", default="exif",
                   help="EXIF data embedding [exif]")
    p.add_argument("-m", "--max-pixels", type=int, default=6_000_000,
                   help="Limit image size for feature detection")
    p.add_argument("-u", "--undistorted", default="undistorted",
                   help="Undistorted image embedding [undistorted]")
    p.add_argument("--prebundle", default="prebundle.sfm",
                   help="Load/store pre-bundle file [prebundle.sfm]")
    p.add_argument("--survey", default="",
                   help="Load survey (ground control points) from file []")
    p.add_argument("--log-file", default="", help="Log some timings to file []")
    p.add_argument("--no-prediction", action="store_true",
                   help="Disable low-res matchability prediction")
    p.add_argument("--skip-sfm", action="store_true",
                   help="Compute prebundle, skip SfM reconstruction")
    p.add_argument("--initial-pair", type=str, default="-1,-1",
                   help="Initial pair view IDs, e.g. 0,5")
    p.add_argument("--video-matching", type=int, default=0,
                   help="Only match to ARG previous frames")
    p.add_argument("--fixed-intrinsics", action="store_true",
                   help="Do not optimize camera intrinsics")
    p.add_argument("--intrinsics-from-views", action="store_true",
                   help="Use intrinsics from the views (meta.ini)")
    p.add_argument("--always-full-ba", action="store_true",
                   help="Run full bundle adjustment after every view")
    p.add_argument("--normalize", action="store_true",
                   help="Normalize scene after reconstruction")
    p.add_argument("--verbose-ba", action="store_true",
                   help="Print the status of every BA")
    # Reference names (sfmrecon.cc:506-507): --track-error-thres is the
    # NEW-track error threshold, --track-thres-factor the median factor.
    p.add_argument("--track-error-thres", type=float, default=0.01,
                   help="Error threshold for new tracks [0.01]")
    p.add_argument("--track-thres-factor", type=float, default=10.0,
                   help="Error threshold factor [10]")
    p.add_argument("--use-2cam-tracks", action="store_true",
                   help="Triangulate tracks from only two cameras")
    p.add_argument("--min-views-per-track", type=int, default=3)
    p.add_argument("--device", default="cuda",
                   help="Device to run on: cuda or cpu [cuda]")
    args = p.parse_args(argv)
    sfm_reconstruct(
        args.scene, max_pixels=args.max_pixels,
        initial_pair=tuple(int(x) for x in args.initial_pair.split(",")),
        video_matching=args.video_matching,
        use_lowres_matching=not args.no_prediction,
        fixed_intrinsics=args.fixed_intrinsics,
        intrinsics_from_views=args.intrinsics_from_views,
        always_full_ba=args.always_full_ba, normalize=args.normalize,
        skip_sfm=args.skip_sfm,
        track_error_thres_factor=args.track_thres_factor,
        new_track_error_thres=args.track_error_thres,
        min_views_per_track=2 if args.use_2cam_tracks else args.min_views_per_track,
        original_name=args.original, undistorted_name=args.undistorted,
        exif_name=args.exif, prebundle_name=args.prebundle,
        survey_file=args.survey, log_file=args.log_file,
        verbose_ba=args.verbose_ba, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
