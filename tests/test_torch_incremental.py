"""The port's incremental SfM against mve_tpu's, on the CPU, on MVE's
golden prebundle (tests/golden/prebundle_ref_seed7.sfm: the reference
sfmrecon's features and verified matches of the 4-view 480x360 seed-7
two-plane scene), with each viewport's focal length at sfmrecon's EXIF
fallback, 1.0.

Tolerances: tracks identical (the same references in the same order);
the initial pair the same views, poses within 1e-4; a whole run the same
registered views, track counts within 1%, camera centres within 1% of
their extent after a similarity alignment. Step by step from one shared
state (handed over with mve_tpu_torch.interop): triangulated points
within 1e-6, a resection's inliers at least 99% shared and its pose
within 1e-3 (float32 P3P, see test_torch_geometry.py), BA poses within
1e-4 and points within 1e-3 (float32 LM).
"""

import copy
import os

import numpy as np
import pytest
import torch

from mve_tpu.sfm.bundler import common as jcommon
from mve_tpu.sfm.bundler import incremental as jinc, init_pair as jinit, pipeline as jpipe
from mve_tpu.sfm.bundler import tracks as jtracks

from mve_tpu_torch import interop
from mve_tpu_torch.sfm.bundler import common as tcommon
from mve_tpu_torch.sfm.bundler import incremental as tinc, init_pair as tinit
from mve_tpu_torch.sfm.bundler import pipeline as tpipe, tracks as ttracks

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "prebundle_ref_seed7.sfm")


def _load(common):
    vps, matching = common.load_prebundle(GOLDEN)
    for vp in vps:
        vp.focal_length = 1.0
    return vps, matching


def _pairs_opts(mod):
    return mod.InitialPairOptions(max_homography_inliers=0.8)  # SfmOptions' default


@pytest.fixture(scope="module")
def tracks():
    jv, jm = _load(jcommon)
    tv, tm = _load(tcommon)
    return (jv, jtracks.Tracks().compute(jm, jv)), (tv, ttracks.Tracks().compute(tm, tv))


def test_tracks_compute_identical(tracks):
    (jv, jt), (tv, tt) = tracks
    assert len(tt) == len(jt) > 100
    for a, b in zip(jt, tt):
        assert [(r.view_id, r.feature_id) for r in a.features] == \
            [(r.view_id, r.feature_id) for r in b.features]
        np.testing.assert_array_equal(a.color, b.color)
    for a, b in zip(jv, tv):
        np.testing.assert_array_equal(a.track_ids, b.track_ids)


@pytest.fixture(scope="module")
def init_pairs(tracks):
    (jv, jt), (tv, tt) = tracks
    a = jinit.InitialPair(_pairs_opts(jinit))
    a.initialize(jv, jt)
    b = tinit.InitialPair(_pairs_opts(tinit), device="cpu")
    b.initialize(tv, tt)
    return a.compute_pair(), b.compute_pair()


def test_initial_pair(init_pairs):
    a, b = init_pairs
    assert (b.view_1_id, b.view_2_id) == (a.view_1_id, a.view_2_id) != (-1, -1)
    for pa, pb in ((a.view_1_pose, b.view_1_pose), (a.view_2_pose, b.view_2_pose)):
        np.testing.assert_allclose(pb.R, pa.R, atol=1e-4)
        np.testing.assert_allclose(pb.t, pa.t, atol=1e-4)
        np.testing.assert_allclose(pb.K, pa.K, atol=0)


def _two_plane_state(near_share, n_views=8, n_points=400):
    """mve_tpu viewports and tracks of the synthetic two-plane scene's
    cameras (tests/synthetic.py, seed 7): each track is one point, seen
    with 1e-4 noise in every view whose image holds it; a share near_share
    of the points lie on the near patch (z = 3.5), the rest on the
    background plane (z = 5). Phase 9 of chip_smoke.py runs the rendered
    40-view scene, where most features lie on the background too."""
    from tests import synthetic as test_synthetic

    rng = np.random.RandomState(0)
    n_near = int(round(near_share * n_points))
    x0, x1, y0, y1 = test_synthetic.NEAR_BOUNDS
    pts = np.concatenate([
        np.stack([rng.uniform(-2.0, 2.0, n_points - n_near), rng.uniform(-1.5, 1.5, n_points - n_near),
                  np.full(n_points - n_near, test_synthetic.PLANE_Z)], axis=1),
        np.stack([rng.uniform(x0, x1, n_near), rng.uniform(y0, y1, n_near),
                  np.full(n_near, test_synthetic.NEAR_Z)], axis=1)])
    tracks = []
    for p in pts:
        t = jcommon.Track()
        t.pos = p.copy()
        tracks.append(t)
    vps = []
    for v, cam in enumerate(test_synthetic.make_cameras(n_views, spread=0.55, seed=7)):
        pc = pts @ cam.rot.astype(np.float64).T + cam.trans.astype(np.float64)
        uv = cam.flen * pc[:, :2] / pc[:, 2:] + rng.randn(len(pts), 2) * 1e-4
        seen = np.nonzero((np.abs(uv[:, 0]) < 0.5) & (np.abs(uv[:, 1]) < 0.375))[0]
        vp = jcommon.Viewport()
        vp.positions = uv[seen].astype(np.float32)
        vp.colors = np.zeros((len(seen), 3), np.uint8)
        vp.track_ids = seen.astype(np.int32)
        vp.focal_length = float(cam.flen)
        for f, tid in enumerate(seen):
            tracks[tid].features.append(jcommon.FeatureReference(v, f))
        vps.append(vp)
    return vps, tracks


@pytest.mark.parametrize("near_share,found", [(0.12, False), (0.4, True)])
def test_initial_pair_rejects_the_same_candidates(near_share, found, monkeypatch):
    """On a scene whose matches lie mostly on one plane (the degeneracy of
    chip_smoke.py's 40-view scene), every candidate has more than 80%
    homography inliers and both packages find no initial pair; with more
    of the near patch both find the same one. Candidate by candidate,
    both test the same pairs in the same order and keep the same
    homography inliers."""
    tested = {"jax": [], "port": []}

    def recording(mod, key):
        real = mod.ransac_homography

        def wrapper(p1, p2, *args, **kwargs):
            res = real(p1, p2, *args, **kwargs)
            tested[key].append((len(p1), len(res.inliers)))
            return res
        monkeypatch.setattr(mod, "ransac_homography", wrapper)

    recording(jinit, "jax")
    recording(tinit, "port")
    jv, jt = _two_plane_state(near_share)
    a = jinit.InitialPair(_pairs_opts(jinit))
    a.initialize(jv, jt)
    b = tinit.InitialPair(_pairs_opts(tinit), device="cpu")
    b.initialize(*_to_port(jv, jt))
    ra, rb = a.compute_pair(), b.compute_pair()
    assert (rb.view_1_id, rb.view_2_id) == (ra.view_1_id, ra.view_2_id)
    assert (ra.view_1_id >= 0) == found
    assert len(tested["port"]) == len(tested["jax"]) > 0
    for (mj, ij), (mt, it) in zip(tested["jax"], tested["port"]):
        assert mt == mj and abs(it - ij) <= 0.01 * mj
        assert (it / mt > 0.8) == (ij / mj > 0.8)
    if not found:
        # All 28 pairs of the 8 views were tested and each was rejected.
        assert len(tested["port"]) == 28
        assert all(i / m > 0.8 for m, i in tested["port"])
    else:
        np.testing.assert_allclose(rb.view_2_pose.R, ra.view_2_pose.R, atol=1e-4)
        np.testing.assert_allclose(rb.view_2_pose.t, ra.view_2_pose.t, atol=1e-4)


def _centres(vps):
    return np.array([vp.pose.fill_camera_pos() for vp in vps if vp.pose.is_valid()])


def _aligned_error(est, ref):
    """Largest centre distance after a similarity alignment of est onto
    ref, as a share of ref's extent."""
    R, s, t = jinc._determine_similarity(est, ref)
    aligned = (s * (R @ est.T)).T + t
    extent = np.linalg.norm(ref.max(0) - ref.min(0))
    return np.linalg.norm(aligned - ref, axis=1).max() / extent


def _run(pkg, survey=None):
    if pkg == "jax":
        vps, matching = _load(jcommon)
        inc = jpipe.run_incremental_sfm(vps, matching, jpipe.SfmOptions(survey_points=survey))
    else:
        vps, matching = _load(tcommon)
        inc = tpipe.run_incremental_sfm(vps, matching, tpipe.SfmOptions(survey_points=survey),
                                        device="cpu")
    return vps, inc


@pytest.fixture(scope="module")
def runs():
    return _run("jax"), _run("port")


def test_run_incremental_sfm(runs):
    (jv, ji), (tv, ti) = runs
    assert [vp.pose.is_valid() for vp in tv] == [vp.pose.is_valid() for vp in jv] == [True] * 4
    nj = ji.create_bundle().get_num_features()
    nt = ti.create_bundle().get_num_features()
    assert abs(nt - nj) <= 0.01 * nj and nj > 100
    assert _aligned_error(_centres(tv), _centres(jv)) < 0.01
    assert ti.ba_totals["n_ba"] > 0 and ti.ba_totals["lm_iters"] > 0


def _write_survey(path, points, observations):
    with open(path, "w") as f:
        f.write(f"MVE_SURVEY\n{len(points)} {len(observations)}\n")
        for p in points:
            f.write(f"{p[0]:.17g} {p[1]:.17g} {p[2]:.17g}\n")
        for pid, vid, xy in observations:
            f.write(f"{pid} {vid} {xy[0]:.9g} {xy[1]:.9g}\n")


def test_survey_registration(runs, tmp_path):
    """Survey points, in a frame a known similarity away from mve_tpu's
    reconstruction and observed where that reconstruction's tracks were:
    both packages register to it (try_registration) and end with the same
    cameras in the survey's frame."""
    (jv, ji), _ = runs
    rng = np.random.RandomState(0)
    valid = [t for t in ji.tracks if t.is_valid() and len(t.features) >= 3]
    pick = [valid[i] for i in rng.choice(len(valid), 6, replace=False)]
    from mve_tpu_torch.math.rotation import rodrigues_to_matrix

    Rs, s, ts = rodrigues_to_matrix(np.array([0.3, -0.2, 0.1])), 2.5, np.array([1.0, -2.0, 0.5])
    points = [s * Rs @ t.pos + ts for t in pick]
    obs = [(k, r.view_id, jv[r.view_id].positions[r.feature_id])
           for k, t in enumerate(pick) for r in t.features]
    path = str(tmp_path / "survey.txt")
    _write_survey(path, points, obs)
    (jv2, ji2) = _run("jax", jcommon.load_survey(path))
    (tv2, ti2) = _run("port", tcommon.load_survey(path))
    assert ji2.registered and ti2.registered
    cj, ct = _centres(jv2), _centres(tv2)
    assert len(ct) == len(cj) == 4
    extent = np.linalg.norm(cj.max(0) - cj.min(0))
    assert np.linalg.norm(ct - cj, axis=1).max() < 0.01 * extent
    # In the survey's frame: the first camera sits where the similarity
    # takes mve_tpu's first run's camera.
    want = s * Rs @ jv[0].pose.fill_camera_pos() + ts
    assert np.linalg.norm(ct[0] - want) < 0.02 * extent


def _to_port(jv, jt):
    """mve_tpu's viewports and tracks as the port's, through interop."""
    views = []
    for vp in jv:
        d = {k: getattr(vp, k) for k in ("positions", "colors", "focal_length",
                                         "radial_distortion", "track_ids", "backup_tracks")}
        d.update(K=vp.pose.K, R=vp.pose.R, t=vp.pose.t)
        views.append(d)
    tt = interop.tracks_from_numpy([t.pos for t in jt], [t.color for t in jt],
                                   [[(r.view_id, r.feature_id) for r in t.features] for t in jt])
    return interop.viewports_from_numpy(views), tt


@pytest.fixture(scope="module")
def shared_state(tracks, init_pairs):
    """mve_tpu's state after the initial pair, and the same state handed
    to the port."""
    (jv, jt), _ = tracks
    a, _ = init_pairs
    jv, jt = copy.deepcopy(jv), copy.deepcopy(jt)
    jv[a.view_1_id].pose = a.view_1_pose
    jv[a.view_2_id].pose = a.view_2_pose
    ji = jinc.Incremental()
    ji.initialize(jv, jt)
    ti = tinc.Incremental(device="cpu")
    ti.initialize(*_to_port(jv, jt))
    return ji, ti


def _compare_tracks(ji, ti, atol):
    assert len(ti.tracks) == len(ji.tracks)
    for a, b in zip(ji.tracks, ti.tracks):
        assert a.is_valid() == b.is_valid()
        assert [(r.view_id, r.feature_id) for r in a.features] == \
            [(r.view_id, r.feature_id) for r in b.features]
        if a.is_valid():
            np.testing.assert_allclose(b.pos, a.pos, atol=atol)


def _compare_poses(ji, ti, atol):
    for a, b in zip(ji.viewports, ti.viewports):
        assert a.pose.is_valid() == b.pose.is_valid()
        if a.pose.is_valid():
            np.testing.assert_allclose(b.pose.R, a.pose.R, atol=atol)
            np.testing.assert_allclose(b.pose.t, a.pose.t, atol=atol)
            np.testing.assert_allclose(b.radial_distortion, a.radial_distortion, atol=atol)


def test_step_by_step_from_shared_state(shared_state):
    ji, ti = shared_state
    # Triangulation (host numpy in both) and pruning.
    ji.triangulate_new_tracks(2)
    ti.triangulate_new_tracks(2)
    _compare_tracks(ji, ti, 1e-6)
    ji.invalidate_large_error_tracks()
    ti.invalidate_large_error_tracks()
    _compare_tracks(ji, ti, 1e-6)
    # Full BA.
    ji.bundle_adjustment_full()
    ti.bundle_adjustment_full()
    _compare_poses(ji, ti, 1e-4)
    _compare_tracks(ji, ti, 1e-3)
    assert abs(ti.last_ba_status.num_lm_iterations - ji.last_ba_status.num_lm_iterations) <= 1
    # One resection from the same state (the port takes mve_tpu's BA).
    ti.viewports, ti.tracks = _to_port(ji.viewports, ji.tracks)
    nxt = ji.find_next_views()
    assert ti.find_next_views() == nxt and nxt
    view = nxt[0]
    assert ji.reconstruct_next_view(view) and ti.reconstruct_next_view(view)
    a, b = ji.viewports[view], ti.viewports[view]
    np.testing.assert_allclose(b.pose.R, a.pose.R, atol=1e-3)
    np.testing.assert_allclose(b.pose.t, a.pose.t, atol=1e-3)
    kept_j = set(np.nonzero(a.track_ids >= 0)[0])
    kept_t = set(np.nonzero(b.track_ids >= 0)[0])
    assert len(kept_j & kept_t) >= 0.99 * max(len(kept_j), len(kept_t))
    # Single-camera BA of the new view, then its new tracks.
    ti.viewports, ti.tracks = _to_port(ji.viewports, ji.tracks)
    ji.bundle_adjustment_single_cam(view)
    ti.bundle_adjustment_single_cam(view)
    _compare_poses(ji, ti, 1e-4)
    ji.triangulate_new_tracks(3)
    ti.triangulate_new_tracks(3)
    _compare_tracks(ji, ti, 1e-3)
