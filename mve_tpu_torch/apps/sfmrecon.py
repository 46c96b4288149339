"""sfmrecon: incremental SfM on a scene (reference: apps/sfmrecon/sfmrecon.cc;
port of the single-process path of mve_tpu/apps/sfmrecon.py).

features -> all-pairs matching with RANSAC (cached in prebundle.sfm; a
scene that already has one loads it) -> intrinsics from EXIF or the views
-> tracks -> initial pair -> incremental SfM with bundle adjustment ->
synth_0.out, each view's camera and the undistorted images. With
--skip-sfm it stops at the prebundle.

The matcher is the batched all-pairs one; --cascade-hashing selects the
per-pair matcher with the cascade-hashing SIFT block. With
--num-processes N (default: JAX_NUM_PROCESSES, as in mve_tpu) N processes
share the prebundle over the scene directory: each computes the features
of its share of the views and writes features.part{k}.npz, reads the
others', matches its share of the pairs with the batched matcher and
writes matches.part{k}.npz; process 0 merges them into prebundle.sfm,
removes the part files and goes on to SfM, the others stop there.
Several processes may share one card. On a CUDA device with several
local cards, every BA shards its observations over all of them
(parallel/distributed_ba.py), as mve_tpu does over its local devices.

    python -m mve_tpu_torch.apps.sfmrecon [--device cpu] <scene>
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np
import torch

from .. import resolve_device
from ..core import Scene
from ..core import image_tools
from ..utils.timer import WallTimer
from ..parallel.mesh import get_mesh
from ..parallel.multihost import my_shard, num_processes_from_env, process_id_from_env
from ..sfm.bundler import (
    BatchedMatching, BundlerMatchingOptions, Features, FeaturesOptions,
    Intrinsics, IntrinsicsOptions, Matching, Viewport, load_prebundle, save_prebundle)
from ..sfm.bundler.common import TwoViewMatching, load_survey
from ..sfm.bundler.intrinsics import IntrinsicsSource
from ..sfm.bundler.matching import all_pairs
from ..sfm.bundler.pipeline import LAST_PHASE_MS, SfmOptions, run_incremental_sfm

RAND_SEED_MATCHING = 0

# Per-run stage timings and counters (the reference prints these at
# sfmrecon.cc:100-131): features_ms, matching_ms, n_features and the
# matcher's stage sizes and RANSAC times; then incremental_ms,
# incremental_phases, ba_totals, undistort_ms, n_cameras and n_tracks.
LAST_TIMINGS: dict = {}


def _save_features_part(path: str, idxs, viewports) -> None:
    """Publish one process's freshly computed viewport features."""
    arrays = {"idxs": np.asarray(idxs, np.int64)}
    for i in idxs:
        vp = viewports[i]
        arrays[f"v{i}_positions"] = vp.positions
        arrays[f"v{i}_colors"] = vp.colors
        arrays[f"v{i}_descriptors"] = vp.descriptors
        arrays[f"v{i}_surf"] = vp.surf_descriptors
        arrays[f"v{i}_meta"] = np.asarray([vp.num_sift, vp.width, vp.height], np.int64)
    _publish_npz(path, arrays)


def _load_features_part(path: str, viewports) -> None:
    with np.load(path) as data:
        for i in data["idxs"]:
            i = int(i)
            vp = viewports[i]
            vp.positions = data[f"v{i}_positions"]
            vp.colors = data[f"v{i}_colors"]
            vp.descriptors = data[f"v{i}_descriptors"]
            vp.surf_descriptors = data[f"v{i}_surf"]
            vp.num_sift, vp.width, vp.height = (int(v) for v in data[f"v{i}_meta"])
            vp.track_ids = np.full(len(vp.positions), -1, np.int32)


def _publish_npz(path: str, arrays: dict) -> None:
    """Write then rename, so that a waiting process never reads a partial file."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _wait_for_files(paths, timeout_s: float = 3600.0) -> None:
    t0 = time.time()
    while not all(os.path.isfile(p) for p in paths):
        if time.time() - t0 > timeout_s:
            missing = [p for p in paths if not os.path.isfile(p)]
            raise RuntimeError(f"Timed out waiting for {missing}")
        time.sleep(1.0)


def _merge_matches(parts):
    """The pairs of every matches.part file, sorted by view ids."""
    merged = []
    for path in parts:
        with np.load(path) as data:
            ids = data["ids"].reshape(-1, 2)
            for j in range(int(data["n"])):
                merged.append(TwoViewMatching(int(ids[j, 0]), int(ids[j, 1]), data[f"m{j}"]))
    merged.sort(key=lambda m: (m.view_1_id, m.view_2_id))
    return merged


def _compute_prebundle(scene_path, views, max_pixels, video_matching, use_lowres_matching,
                       use_cascade_hashing, process_id, num_processes,
                       original_name, undistorted_name, dev, verbose, log_timing):
    """(viewports, pairwise matching); None on a process other than 0 of
    several, once its share of the matching is published."""
    viewports = [Viewport() for _ in views]
    timer = WallTimer()
    if verbose:
        print("Computing image features...")
    features = Features(FeaturesOptions(max_image_size=max_pixels, verbose=verbose), dev)

    def image_name(view):
        return original_name if view.has_image(original_name) else undistorted_name

    all_idxs = [i for i, view in enumerate(views)
                if view is not None and view.has_image(image_name(view))]
    # The views this process detects features in: the view list partitions
    # across processes as the reference's OpenMP-dynamic view loop
    # partitions across threads (bundler_features.cc:40).
    mine = my_shard(all_idxs, process_id, num_processes) if num_processes > 1 else all_idxs
    imgs, idxs = [], []
    for i in mine:
        img = views[i].get_image(image_name(views[i]))
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

    if num_processes > 1:
        # Exchange features over shared storage.
        part = os.path.join(scene_path, f"features.part{process_id}.npz")
        _save_features_part(part, idxs, viewports)
        parts = [os.path.join(scene_path, f"features.part{k}.npz")
                 for k in range(num_processes)]
        _wait_for_files(parts)
        for k, path in enumerate(parts):
            if k != process_id:
                _load_features_part(path, viewports)

    timer.reset()
    if verbose:
        print("Performing feature matching...")
    mopts = BundlerMatchingOptions(
        use_lowres_matching=use_lowres_matching,
        use_cascade_hashing=use_cascade_hashing,
        max_num_pairs_per_view=video_matching,
        verbose=verbose)
    if num_processes > 1:
        # The pair list shards across processes (the distributed analog of
        # OpenMP-dynamic over pairs, bundler_matching.cc:74), each matched
        # with the batched matcher from its own RandomState.
        my_pairs = my_shard(all_pairs(len(viewports), video_matching), process_id,
                            num_processes)
        matcher = BatchedMatching(mopts, dev)
        matches = matcher.compute(viewports, seed=RAND_SEED_MATCHING, pairs=my_pairs)
        _publish_npz(os.path.join(scene_path, f"matches.part{process_id}.npz"), dict(
            n=len(matches),
            ids=np.asarray([[m.view_1_id, m.view_2_id] for m in matches], np.int64),
            **{f"m{j}": m.matches for j, m in enumerate(matches)}))
        if process_id != 0:
            if verbose:
                print(f"Process {process_id}: matching shard done.")
            return None
        mparts = [os.path.join(scene_path, f"matches.part{k}.npz")
                  for k in range(num_processes)]
        _wait_for_files(mparts)
        pairwise_matching = _merge_matches(mparts)
        for path in mparts + parts:
            with contextlib.suppress(OSError):
                os.remove(path)
    elif use_cascade_hashing:
        # Matcher selection (sfmrecon.cc:141-153): the cascade runs pair
        # by pair; the default matcher batches all pairs.
        matcher = Matching(mopts, dev)
        pairwise_matching = matcher.compute(viewports, seed=RAND_SEED_MATCHING)
    else:
        matcher = BatchedMatching(mopts, dev)
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
                    use_cascade_hashing: bool = False,
                    process_id: int = 0, num_processes: int = 1,
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
    with skip_sfm, and on a process other than 0 of several)."""
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
        prebundle = _compute_prebundle(
            scene_path, views, max_pixels, video_matching, use_lowres_matching,
            use_cascade_hashing, process_id, num_processes, original_name,
            undistorted_name, dev, verbose, log_timing)
        if prebundle is None:
            return None
        viewports, pairwise_matching = prebundle
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
    # Several local cards: shard BA's observations over all of them. One
    # card gets no mesh (a one-shard mesh computes the same bits).
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        opts.incremental_opts.ba_mesh = get_mesh()
        if verbose:
            print(f"BA: sharding observations over {torch.cuda.device_count()} devices.")
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
    p.add_argument("--lowres-matching", action="store_true",
                   help="(deprecated) low-res matching is on by default; "
                        "use --no-prediction to disable")
    p.add_argument("--skip-sfm", action="store_true",
                   help="Compute prebundle, skip SfM reconstruction")
    p.add_argument("--initial-pair", type=str, default="-1,-1",
                   help="Initial pair view IDs, e.g. 0,5")
    p.add_argument("--video-matching", type=int, default=0,
                   help="Only match to ARG previous frames")
    p.add_argument("--cascade-hashing", action="store_true",
                   help="Use cascade hashing for matching")
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
    p.add_argument("--process-id", type=int, default=process_id_from_env(),
                   help="This process's index for sharding features and "
                        "matching [JAX_PROCESS_ID or 0]")
    p.add_argument("--num-processes", type=int, default=num_processes_from_env(),
                   help="Total processes sharing features and matching "
                        "[JAX_NUM_PROCESSES or 1]")
    p.add_argument("--device", default="cuda",
                   help="Device to run on: cuda or cpu [cuda]")
    args = p.parse_args(argv)
    sfm_reconstruct(
        args.scene, max_pixels=args.max_pixels,
        initial_pair=tuple(int(x) for x in args.initial_pair.split(",")),
        video_matching=args.video_matching,
        use_lowres_matching=not args.no_prediction,
        use_cascade_hashing=args.cascade_hashing,
        process_id=args.process_id, num_processes=args.num_processes,
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
