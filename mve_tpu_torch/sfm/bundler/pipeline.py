"""End-to-end incremental SfM (reference: apps/sfmrecon/sfmrecon.cc
sfm_reconstruct, :230-400).

Given viewports with features + pairwise matching, runs: tracks ->
initial pair -> incremental loop (resection, single-cam BA, periodic full
BA with triangulation/restore/pruning) -> returns the Incremental object
ready for create_bundle(). Port of mve_tpu/sfm/bundler/pipeline.py: the
initial pair and the incremental loop run on the given device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from .common import TwoViewMatching, Viewport
from .incremental import Incremental, IncrementalOptions
from .init_pair import InitialPair, InitialPairOptions
from .tracks import Tracks, TracksOptions


@dataclasses.dataclass
class SfmOptions:
    initial_pair: tuple = (-1, -1)
    min_views_per_track: int = 3  # sfmrecon.cc conf default
    always_full_ba: bool = False
    normalize_scene: bool = False
    survey_points: Optional[list] = None  # bundler::SurveyPoint list
    incremental_opts: IncrementalOptions = dataclasses.field(default_factory=IncrementalOptions)
    init_pair_opts: InitialPairOptions = dataclasses.field(
        default_factory=lambda: InitialPairOptions(max_homography_inliers=0.8))
    verbose: bool = False


#: Per-phase wall-clock of the last run_incremental_sfm call (ms).
LAST_PHASE_MS: dict = {}


def run_incremental_sfm(viewports: List[Viewport],
                        pairwise_matching: List[TwoViewMatching],
                        opts: Optional[SfmOptions] = None,
                        device="cuda") -> Incremental:
    import time as _time
    from collections import defaultdict

    phase_ms = defaultdict(float)
    LAST_PHASE_MS.clear()
    LAST_PHASE_MS.update(phase_ms)

    def timed(name, fn, *a, **kw):
        t0 = _time.perf_counter()
        out = fn(*a, **kw)
        phase_ms[name] += (_time.perf_counter() - t0) * 1000.0
        LAST_PHASE_MS.update(phase_ms)
        return out

    opts = opts or SfmOptions()

    tracks = Tracks(TracksOptions(verbose=opts.verbose)).compute(
        pairwise_matching, viewports)
    if opts.verbose:
        print(f"Created a total of {len(tracks)} tracks.")

    init_pair = InitialPair(opts.init_pair_opts, device)
    init_pair.initialize(viewports, tracks)
    if opts.initial_pair[0] >= 0 and opts.initial_pair[1] >= 0:
        result = init_pair.compute_pair_fixed(*opts.initial_pair)
    else:
        result = init_pair.compute_pair()
    if result.view_1_id < 0 or result.view_2_id < 0:
        raise RuntimeError("Error finding initial pair")
    if opts.verbose:
        print(f"Using views {result.view_1_id} and {result.view_2_id} as initial pair.")

    viewports[result.view_1_id].pose = result.view_1_pose
    viewports[result.view_2_id].pose = result.view_2_pose

    incremental = Incremental(opts.incremental_opts, device)
    incremental.initialize(viewports, tracks, opts.survey_points)
    timed('triangulate', incremental.triangulate_new_tracks, 2)
    timed('invalidate', incremental.invalidate_large_error_tracks)
    timed('ba_full', incremental.bundle_adjustment_full)

    num_cameras_reconstructed = 2
    full_ba_num_skipped = 0
    while True:
        next_views = timed('find_next_views', incremental.find_next_views)
        next_view_id = -1
        for vid in next_views:
            if opts.verbose:
                print(f"Adding next view ID {vid} "
                      f"({num_cameras_reconstructed + 1} of {len(viewports)})...")
            if timed('resection', incremental.reconstruct_next_view, vid):
                next_view_id = vid
                break
        if next_view_id < 0:
            if full_ba_num_skipped == 0:
                if opts.verbose:
                    print("No valid next view. SfM reconstruction finished.")
                break
            timed('triangulate', incremental.triangulate_new_tracks, opts.min_views_per_track)
            timed('ba_full', incremental.bundle_adjustment_full)
            timed('invalidate', incremental.invalidate_large_error_tracks)
            full_ba_num_skipped = 0
            continue

        timed('ba_single', incremental.bundle_adjustment_single_cam, next_view_id)
        num_cameras_reconstructed += 1

        full_ba_skip_views = 0 if opts.always_full_ba else min(
            100, num_cameras_reconstructed // 10)
        if full_ba_num_skipped < full_ba_skip_views:
            full_ba_num_skipped += 1
        else:
            timed('triangulate', incremental.triangulate_new_tracks, opts.min_views_per_track)
            timed('restore', incremental.try_restore_tracks_for_views)
            timed('ba_full', incremental.bundle_adjustment_full)
            timed('invalidate', incremental.invalidate_large_error_tracks)
            full_ba_num_skipped = 0

    if opts.normalize_scene:
        incremental.normalize_scene()
    return incremental
