"""The street of forward-motion drives (mve_tpu_torch/synthetic_street.py)
and the port's dmrecon on it, on the CPU.

The generator's truth is the first hit of each pixel's ray, checked
against a brute-force float64 ray/plane intersection written here, and
its images repeat from a seed. On a small street (10 frames of 248x76,
KITTI's aspect and focal length) no neighbour pair rectifies, so every
view goes to the warp solver; reconstruct_views(scale=0) there writes
depth, conf and dz maps held to the truth on the resolvable pixels. The
warp solver's phases open once a view, in order, and the mvs.solve span
counts its views by solver, here and on the plane scene (sweep solver).
SfM points are listed only by the frames within the track range, and
pixels beyond it are not resolvable.

Tolerances, from the program's and the control's readings at this size
(views 4 and 5, seeds 5-7, reduced sweep settings): the share of the
resolvable pixels with no depth or one more than 5% off is 0.31-0.36
(the control, camera-z depth, 0.87-0.89), so at most 0.5; accepted
depths more than 5% off 2.6-3.7% (control 67%), so at most 0.1; the
median relative error of accepted depths 0.0063-0.0067 (control 0.091),
so at most 0.02. Confidence is above 0 exactly where a depth is, and dz
is 0 where none is (exact).
"""

import math

import numpy as np
import pytest
import torch

from mve_tpu_torch import synthetic_street as st
from mve_tpu_torch.apps import dmrecon as app
from mve_tpu_torch.core import Bundle, CameraInfo, Feature2D, Feature3D, Scene, View
from mve_tpu_torch.mvs import Settings
from mve_tpu_torch.mvs import dmrecon as mvs
from mve_tpu_torch.mvs.sweep_solver import rectify_pair
from mve_tpu_torch.utils import tracing

from tests.synthetic import make_plane_scene

torch.set_num_threads(1)

W, H, FRAMES, SEED = 248, 76, 10, 5
SMALL = Settings(num_sweep_planes=8, num_propagation_iters=2, num_refine_steps=1,
                 max_iterations=4)
WARP_PHASES = ["mvs.solve.warp_sweep", "mvs.solve.warp_propagate", "mvs.solve.warp_refine",
               "mvs.solve.warp_plane", "mvs.solve.warp_accept"]
SWEEP_PHASES = ["mvs.solve.cube", "mvs.solve.lookup", "mvs.solve.exact",
                "mvs.solve.center_plane", "mvs.solve.accept"]


def camera_info(cam) -> CameraInfo:
    info = CameraInfo(flen=cam.flen)
    info.rot = cam.R.astype(np.float32)
    info.trans = cam.t.astype(np.float32)
    return info


def write_street(path: str, n: int, w: int, h: int, seed: int, n_points: int) -> list:
    """The street as an MVE scene (undistorted images and a bundle)."""
    cams = st.make_cameras(n, st.rng_for(seed, 0))
    textures = st.textures_for(seed)
    scene = Scene.create(path)
    infos = [camera_info(c) for c in cams]
    for i, cam in enumerate(cams):
        view = View.create(scene.view_dir_for_id(i), i)
        view.set_camera(infos[i])
        gray = st.render_gray(textures, cam, w, h, st.cross_wall_z(n), torch, "cpu")
        view.set_image("undistorted", np.repeat(gray[:, :, None], 3, axis=2))
        scene.add_view(view)
    scene.save_views()
    pts, vis = st.bundle_points(n_points, cams, w, h, st.rng_for(seed, 3), torch)
    bundle = Bundle()
    bundle.cameras = infos
    for pi, p in enumerate(pts):
        refs = [Feature2D(int(v), pi, np.zeros(2, np.float32)) for v in np.nonzero(vis[:, pi])[0]]
        bundle.features.append(Feature3D(p.astype(np.float32), np.full(3, 0.5, np.float32), refs))
    scene.set_bundle(bundle)
    scene.save_scene()
    return cams


def traced_call(path, view_ids, settings=None):
    """reconstruct_views at scale 0 under a CPU profiler: the span records."""
    tracing.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        n = app.reconstruct_views(path, scale=0, view_ids=set(view_ids), force=True,
                                  verbose=False, device="cpu", settings=settings)
    assert n == len(view_ids)
    recs = list(tracing.records())
    tracing.clear()
    return recs


@pytest.fixture(scope="module")
def street(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("street") / "scene")
    cams = write_street(path, FRAMES, W, H, SEED, 400)
    recs = traced_call(path, [4, 5], SMALL)
    return path, cams, recs, list(mvs.LAST_TIMINGS["batches"])


def brute_force_depth(cam, wall_z, x, y, w, h):
    """Ray length from cam's centre through pixel (x, y) to the nearest of
    the four bounded planes, in plain float64 numpy."""
    d = cam.R.T @ np.linalg.solve(cam.K(w, h), [x + 0.5, y + 0.5, 1.0])
    d /= np.linalg.norm(d)
    c = cam.centre
    best = math.inf
    for axis, value, bounded in ((0, st.LEFT_X, True), (0, st.RIGHT_X, True),
                                 (1, st.ROAD_Y, False), (2, wall_z, False)):
        if d[axis] == 0:
            continue
        s = (value - c[axis]) / d[axis]
        if s <= 0:
            continue
        if bounded and c[1] + s * d[1] < st.ROAD_Y - st.WALL_HEIGHT:
            continue
        best = min(best, s)
    return best


@pytest.mark.parametrize("seed", [1, 2**31 + 7])
def test_truth_is_the_first_ray_plane_hit(seed):
    cams = st.make_cameras(12, st.rng_for(seed, 0))
    wall_z = st.cross_wall_z(12)
    rng = np.random.default_rng(seed)
    for v in (0, 6, 11):
        truth = st.truth_depth(cams[v], 1241, 376, wall_z, torch, "cpu")
        assert truth.shape == (376, 1241) and np.isfinite(truth).all()
        for x, y in zip(rng.integers(0, 1241, 200), rng.integers(0, 376, 200)):
            want = brute_force_depth(cams[v], wall_z, x, y, 1241, 376)
            assert truth[y, x] == pytest.approx(want, rel=1e-12)


def test_images_repeat_from_a_seed():
    cams = st.make_cameras(3, st.rng_for(11, 0))
    tex = st.textures_for(11, 256)
    a, b = (st.render_gray(tex, cams[1], W, H, st.cross_wall_z(3), torch, "cpu")
            for _ in range(2))
    other = st.render_gray(st.textures_for(12, 256), st.make_cameras(3, st.rng_for(12, 0))[1],
                           W, H, st.cross_wall_z(3), torch, "cpu")
    assert a.dtype == np.uint8 and np.array_equal(a, b) and not np.array_equal(a, other)
    assert a.std() > 20   # textured everywhere: every ray ends on a surface


def test_forward_pairs_do_not_rectify():
    cams = st.make_cameras(FRAMES, st.rng_for(SEED, 0))
    for i, ci in enumerate(cams):
        for j, cj in enumerate(cams):
            if i != j:
                assert rectify_pair(ci.K(W, H), ci.R, ci.t, cj.K(W, H), cj.R, cj.t,
                                    image_wh=(W, H)) is None, (i, j)


def test_every_batch_goes_to_the_warp_solver(street):
    assert street[3] == [(2, "warp", H, W, FRAMES - 1)]


@pytest.mark.parametrize("v", [4, 5])
def test_maps_against_the_truth(street, v):
    path, cams, _, _ = street
    view = Scene(path).get_views()[v]
    depth = view.get_image("depth-L0")[..., 0].astype(np.float64)
    conf = view.get_image("conf-L0")[..., 0]
    dz = view.get_image("dz-L0")
    truth = st.truth_depth(cams[v], W, H, st.cross_wall_z(FRAMES), torch, "cpu")
    resolvable = st.resolvable(cams, v, W, H, torch, "cpu")
    assert depth.shape == truth.shape and dz.shape == (H, W, 2) and resolvable.mean() > 0.5
    filled = depth > 0
    rel = np.abs(depth - truth) / truth
    good = filled & (rel <= 0.05)
    assert 1.0 - good[resolvable].mean() <= 0.5
    assert (filled & ~good).sum() / filled.sum() <= 0.1
    assert np.median(rel[filled]) <= 0.02
    assert np.array_equal(conf > 0, filled) and np.all(conf >= 0)
    assert np.all(dz[~filled] == 0)


def test_warp_phases_open_once_a_view_in_order(street):
    recs = street[2]
    (solve,) = [r for r in recs if r.name == "mvs.solve"]
    inner = [r.name for r in sorted(recs, key=lambda r: r.start_ns) if r.parent == solve.id]
    assert inner == ["mvs.pack", "mvs.upload"] + WARP_PHASES * 2 + ["mvs.readback"]
    assert solve.counters.get("views_warp") == 2 and "views_sweep" not in solve.counters


def test_plane_scene_counts_sweep_views(tmp_path):
    make_plane_scene(str(tmp_path), n_views=5, width=96, height=72)
    recs = traced_call(str(tmp_path), [0], SMALL)
    (solve,) = [r for r in recs if r.name == "mvs.solve"]
    assert solve.counters.get("views_sweep") == 1 and "views_warp" not in solve.counters
    inner = [r.name for r in sorted(recs, key=lambda r: r.start_ns) if r.parent == solve.id]
    assert inner == ["mvs.pack", "mvs.upload"] + SWEEP_PHASES + ["mvs.readback"]


def test_resolvable_leaves_out_the_focus_of_expansion():
    """Near the image centre (the direction of travel) no frame sees a
    point with 2 degrees of parallax; at the facades near the edges the
    frames behind do."""
    cams = st.make_cameras(FRAMES, st.rng_for(SEED, 0))
    mask = st.resolvable(cams, 9, W, H, torch, "cpu")
    assert not mask[H // 2 - 3:H // 2 + 3, W // 2 - 6:W // 2 + 6].any()
    assert mask[H // 2, :10].all() and mask[H // 2, -10:].all()


def test_bundle_tracks_end_at_the_track_range():
    """Every frame that lists a point lies within TRACK_RANGE of it, so on
    a 100-frame stretch a middle frame shares points only with the frames
    at most 37 ahead or behind (30 m over 0.8 m a frame), and with some of
    each side."""
    cams = st.make_cameras(100, st.rng_for(SEED, 0))
    pts, vis = st.bundle_points(3000, cams, W, H, st.rng_for(SEED, 3), torch)
    centres = np.stack([c.centre for c in cams])
    dist = np.linalg.norm(pts[None] - centres[:, None], axis=-1)
    assert vis.sum(0).min() >= 2 and np.all(dist[vis] <= st.TRACK_RANGE)
    shared = np.nonzero((vis & vis[50]).any(axis=1))[0] - 50
    assert shared.min() >= -37 and shared.max() <= 37
    assert shared.min() < -20 and shared.max() > 20


def test_resolvable_ends_at_the_track_range():
    """No pixel whose surface lies beyond TRACK_RANGE is resolvable: no SfM
    point seeds dmrecon's depth range there."""
    cams = st.make_cameras(60, st.rng_for(SEED, 0))
    truth = st.truth_depth(cams[30], W, H, st.cross_wall_z(60), torch, "cpu")
    mask = st.resolvable(cams, 30, W, H, torch, "cpu")
    far = truth > st.TRACK_RANGE
    assert far.any() and not mask[far].any() and mask[~far].mean() > 0.5
