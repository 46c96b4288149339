"""The community photo collection (harness/collection.py, the landmark36
configuration), its check (reference/dmrecon_collection.py) and the
readers of the neighbour tensor's counters, on the CPU.

The writer repeats from a seed; the formats, orientations and max-pixels
levels are the configuration's table; two consecutive chunks hold every
format once and one portrait view each; every view sees texture. The
check passes the truth and fails a map at another level, a missing map,
depths 6% or 2% off, confidence where no depth is, two thirds of the
depths dropped, and the control (camera-z depth); the readers of mvs.pack's counters give their values on
hand-built records and nothing without them."""

import copy
import struct

import numpy as np
import pytest
import torch

from mvebench.harness import bench, collection
from mvebench.harness import scene as gen
from mvebench.harness.trace import Trace
from mvebench.reference import dmrecon_collection as ref
from mvebench.reference.dmrecon import MVEI_SIGNATURE

torch.set_num_threads(1)
CFG = bench.load_json(bench.HERE / "configs" / "landmark36.json")
WORKLOAD = bench.load_json(bench.HERE / "workloads" / "landmark36-dmrecon-maxpx.json")
BIG_SEED = 2**31 + 4321
# A small collection: six views at a tenth of the formats' sides, and a
# max_pixels that gives them levels 1 to 3.
SMALL = dict(CFG, views=6, width=400, height=300, bundle_points=400, texture_size=512)
SMALL_WORKLOAD = dict(WORKLOAD, max_pixels=5000)


def test_formats_orientations_and_levels_as_tabled():
    sizes = collection.view_formats(CFG)
    assert len(sizes) == CFG["views"] == 36
    table = {(4000, 3000): 3, (3264, 2448): 2, (3072, 2048): 2, (2048, 1536): 2,
             (1600, 1200): 1, (1024, 768): 1}
    landscape = {fmt: 0 for fmt in table}
    portrait = {fmt: 0 for fmt in table}
    for w, h in sizes:
        fmt = (max(w, h), min(w, h))
        (portrait if h > w else landscape)[fmt] += 1
        s = collection.level_for(w, h, WORKLOAD["max_pixels"])
        assert s == table[fmt]
        assert (w >> s) * (h >> s) <= 500000 < (w >> (s - 1)) * (h >> (s - 1))
    assert all(portrait[f] == 2 and landscape[f] == 4 for f in table)
    for (s, w, h), (fw, fh) in zip(ref.levels(CFG, WORKLOAD["max_pixels"]), sizes):
        assert (w, h) == (fw >> s, fh >> s)     # every format halves evenly at its level
    assert sorted({(w * h) >> (2 * s) for (s, _, _), (w, h) in
                   zip(ref.levels(CFG, 500000), sizes)}) == [187500, 196608, 393216, 480000,
                                                               499392]


def test_two_consecutive_chunks_hold_every_format_once():
    sizes = collection.view_formats(CFG)
    k = WORKLOAD["views_per_call"]
    chunks = [sizes[i:i + k] for i in range(0, len(sizes), k)]
    assert len(chunks) == 12
    for a, b in zip(chunks, chunks[1:] + chunks[:1]):
        fmts = sorted((max(w, h), min(w, h)) for w, h in a + b)
        assert fmts == sorted(tuple(f) for f in CFG["formats"])
        assert sum(h > w for w, h in a) == sum(h > w for w, h in b) == 1


def test_every_view_sees_texture_within_the_extent():
    """At the bounds of every draw: the farthest band's far end, the arc's
    ends, the aim's offset and roll at their bounds, the widest zoom."""
    import itertools
    import math

    worst = 0.0
    for (w, h), band, a, e, ax, ay, r in itertools.product(
            [(4, 3), (3, 4), (3, 2), (2, 3)], CFG["distance_bands"], (-1, 1), (-1, 1),
            (-1, 1), (-1, 1), (-1, 1)):
        az, el = (math.radians(x) for x in CFG["arc_degrees"])
        for dist in band:
            c = collection.TARGET + dist * np.array([
                math.sin(a * az) * math.cos(e * el), math.sin(e * el),
                -math.cos(a * az) * math.cos(e * el)])
            aim = collection.TARGET + np.r_[np.array([ax, ay]) * CFG["aim_offset"], 0.0]
            R = collection._look_at(c, aim, r * math.radians(CFG["roll_degrees"])
                                    + (math.pi / 2 if h > w else 0.0))
            cam = gen.Camera(R, -R @ c, CFG["flen_range"][0])
            worst = max(worst, collection.background_reach(cam, w, h))
    assert worst < CFG["extent"]


def test_writer_repeats_from_a_seed(tmp_path):
    a = collection.write_scene(str(tmp_path / "a"), SMALL, BIG_SEED, torch, "cpu", threads=2)
    b = collection.write_scene(str(tmp_path / "b"), SMALL, BIG_SEED, torch, "cpu", threads=2)
    c = collection.make_cameras(SMALL, gen.rng_for(BIG_SEED + 1, 0))
    for x, y, z in zip(a, b, c):
        assert np.array_equal(x.R, y.R) and np.array_equal(x.t, y.t) and x.flen == y.flen
        assert not np.array_equal(x.t, z.t)
    for name in ("synth_0.out", "views/view_0001.mve/undistorted.png",
                 "views/view_0004.mve/meta.ini"):
        assert (tmp_path / "a" / name).read_bytes() == (tmp_path / "b" / name).read_bytes()
    flens = [cam.flen for cam in a]
    assert min(flens) >= CFG["flen_range"][0] and max(flens) <= CFG["flen_range"][1]


def test_scene_loads_in_the_program(tmp_path):
    from mve_tpu_torch.core import Scene

    cams = collection.write_scene(str(tmp_path), SMALL, BIG_SEED, torch, "cpu", threads=2)
    views = Scene(str(tmp_path)).get_views()
    for view, cam, (w, h) in zip(views, cams, collection.view_formats(SMALL)):
        img = view.get_image("undistorted")
        assert img.shape == (h, w, 3)
        np.testing.assert_allclose(view.camera.calibration(w, h), cam.K(w, h))
        for strip in (img[:4, :, 0], img[-4:, :, 0], img[:, :4, 0], img[:, -4:, 0]):
            assert strip.std() > 5            # texture out to the edges
    bundle = Scene(str(tmp_path)).get_bundle()
    assert len(bundle.features) == SMALL["bundle_points"]
    seen = np.zeros(len(views), int)
    for f in bundle.features:
        assert len(f.refs) >= 2
        for r in f.refs:
            seen[r.view_id] += 1
    assert seen.min() >= 3


@pytest.fixture(scope="module")
def small_scene(tmp_path_factory):
    path = tmp_path_factory.mktemp("collection")
    cams = collection.write_scene(str(path), SMALL, BIG_SEED, torch, "cpu", threads=2)
    return str(path), cams


def truth_maps(cams, workload=SMALL_WORKLOAD):
    maps = {}
    for v, (s, w, h) in enumerate(ref.levels(SMALL, workload["max_pixels"])):
        depth = ref.truth(cams[v], w, h).astype(np.float32)
        maps[v] = (depth, np.ones_like(depth))
    return maps


def test_sees_is_scene_seen_by(small_scene):
    """The check's visibility (torch, on the run's device) is
    harness/scene.seen_by's, point for point."""
    _, cams = small_scene
    sizes = collection.view_formats(SMALL)
    rng = np.random.default_rng(3)
    xy = rng.uniform(-6, 6, (20000, 2))
    x0, x1, y0, y1 = gen.NEAR_BOUNDS
    on_near = (xy[:, 0] >= x0) & (xy[:, 0] <= x1) & (xy[:, 1] >= y0) & (xy[:, 1] <= y1)
    pts = np.c_[xy, np.where(on_near, gen.NEAR_Z, gen.PLANE_Z)]
    for cam, (w, h) in zip(cams, sizes):
        want = gen.seen_by(cam, pts, on_near, w, h)
        got = ref.sees(cam, torch.from_numpy(pts), torch.from_numpy(on_near), w, h).numpy()
        assert np.array_equal(got, want) and 0 < want.mean() < 1


def test_levels_of_the_small_collection():
    assert sorted({s for s, _, _ in ref.levels(SMALL, SMALL_WORKLOAD["max_pixels"])}) == [1, 2, 3]


def test_truth_passes_the_check(small_scene):
    scene, cams = small_scene
    checks, attempted, failed, per_view = ref.judge(scene, cams, SMALL, SMALL_WORKLOAD,
                                                    list(range(6)), truth_maps(cams))
    assert attempted == 6 and failed == 0
    assert checks["median_err"]["value"] < 1e-6          # the truth rounded to float32
    assert all(checks[k]["value"] == 0.0 for k in ("seen_bad_1pct_pooled", "gross_share",
                                                   "conf_bad"))
    assert all(nums["fill"] == 1.0 for nums in per_view.values())


def write_mvei(path, img):
    h, w = img.shape
    with open(path, "wb") as f:
        f.write(MVEI_SIGNATURE)
        f.write(struct.pack("<iiii", w, h, 1, 9))
        f.write(np.ascontiguousarray(img, np.float32).tobytes())


def test_the_check_reads_each_view_at_its_own_level(small_scene, tmp_path):
    """Maps on disk at each view's level pass; written one level finer
    (the name and the size of another level), or missing, they fail."""
    import shutil

    scene, cams = small_scene
    maps = truth_maps(cams)
    for shift in (0, -1):
        work = tmp_path / f"shift{shift}"
        shutil.copytree(scene, work)
        for v, (s, w, h) in enumerate(ref.levels(SMALL, SMALL_WORKLOAD["max_pixels"])):
            if shift:
                wl, hl = gen.level_dims(*collection.view_formats(SMALL)[v], s + shift)
                depth = ref.truth(cams[v], wl, hl).astype(np.float32)
                conf = np.ones_like(depth)
            else:
                depth, conf = maps[v]
            d = gen.view_dir(str(work), v)
            write_mvei(f"{d}/depth-L{s + shift}.mvei", depth)
            write_mvei(f"{d}/conf-L{s + shift}.mvei", conf)
        _, attempted, failed, _ = ref.judge(str(work), cams, SMALL, SMALL_WORKLOAD, list(range(6)))
        assert attempted == 6 and failed == (6 if shift else 0)
    _, _, failed, per_view = ref.judge(scene, cams, SMALL, SMALL_WORKLOAD, [0, 1])
    assert failed == 2 and per_view == {0: None, 1: None}


@pytest.mark.parametrize("fault", ["depths 6% off", "depths 2% off",
                                   "confidence where no depth is",
                                   "two thirds of each view's depths dropped",
                                   "a map of another size", "the control"])
def test_the_check_catches(small_scene, fault):
    scene, cams = small_scene
    maps = copy.deepcopy(truth_maps(cams))
    if fault == "depths 6% off":
        maps = {v: (d * 1.06, c) for v, (d, c) in maps.items()}
    elif fault == "depths 2% off":
        maps = {v: (d * 1.02, c) for v, (d, c) in maps.items()}
    elif fault == "confidence where no depth is":
        for d, c in maps.values():
            d[: d.shape[0] // 3] = 0.0
    elif fault == "two thirds of each view's depths dropped":
        for d, c in maps.values():
            keep = np.arange(d.shape[0]) % 3 == 0
            d[~keep] = 0.0
            c[~keep] = 0.0
    elif fault == "a map of another size":
        maps[2] = (maps[2][0][:-1], maps[2][1][:-1])
    else:
        maps = {}
        for v, (s, w, h) in enumerate(ref.levels(SMALL, SMALL_WORKLOAD["max_pixels"])):
            depth = ref.z_depth_control(cams[v], w, h)
            maps[v] = (depth, np.ones_like(depth))
    checks, attempted, failed, _ = ref.judge(scene, cams, SMALL, SMALL_WORKLOAD, list(range(6)),
                                             maps)
    if fault == "two thirds of each view's depths dropped":
        # No view is past a per-view limit; the pooled coverage is.
        assert failed == 0 and checks["seen_bad_1pct_pooled"]["value"] > 0.6
    else:
        assert failed > 0
    if fault == "depths 2% off":
        # Within 5% (no gross depth), but none within 1%.
        assert checks["gross_share"]["value"] == 0.0
        assert checks["seen_bad_1pct_pooled"]["value"] == 1.0
    if fault != "a map of another size":
        assert any(c["value"] > c["limit"] for c in checks.values())


# ---------------------------------------------------------------------------
# the readers of mvs.pack's counters
# ---------------------------------------------------------------------------

def run_of(records, monkeypatch):
    from mve_tpu_torch.utils import tracing

    monkeypatch.setattr(tracing, "records", lambda: records)
    spans = {"bench.call": [(0, 10_000)], "mvs.prepare": [(100, 200)]}
    trace = Trace(window_s=1e-5, kernels=[], spans=spans, host_ops=[])
    calls = [bench.Call(spec=(0, 1, 2), seconds=1e-5, work=3, counters={"views": 3})]
    return bench.Run(calls=calls, trace=trace, window_peak_bytes=0, extra={})


def test_readers_on_hand_built_records(monkeypatch):
    from mve_tpu_torch.utils.tracing import SpanRecord as R

    records = [
        R("dmrecon.call", 1, None, 1, 100, 9_000),
        R("mvs.solve", 2, 1, 1, 200, 4_000, {"views_warp": 2}),
        R("mvs.pack", 3, 2, 1, 300, 400, {"neigh_px": 3_000_000, "neigh_px_padded": 8_000_000}),
        R("mvs.solve", 4, 1, 1, 4_000, 8_000, {"views_sweep": 1}),
        R("mvs.pack", 5, 4, 1, 4_100, 4_200, {"neigh_px": 1_000_000,
                                              "neigh_px_padded": 1_000_000}),
        # A call outside the window's bench.call ranges: left out.
        R("dmrecon.call", 6, None, 6, 20_000, 30_000),
        R("mvs.pack", 7, 6, 6, 21_000, 22_000, {"neigh_px": 1, "neigh_px_padded": 5}),
    ]
    run = run_of(records, monkeypatch)
    mpx = bench.load_module("metrics", "mvs.neighbour_mpx_per_view").read(run)
    pad = bench.load_module("metrics", "mvs.neighbour_pad_pct").read(run)
    assert mpx == pytest.approx(9.0 / 3)
    assert pad == pytest.approx(100.0 * (1 - 4.0 / 9.0))


def test_readers_without_the_counters(monkeypatch):
    """A program whose mvs.pack counts neither (the parent of this
    change): both readers give nothing; so does a run without a trace."""
    from mve_tpu_torch.utils.tracing import SpanRecord as R

    records = [R("dmrecon.call", 1, None, 1, 100, 9_000),
               R("mvs.pack", 2, 1, 1, 300, 400, {"bytes_h2d": 10})]
    for name in ("mvs.neighbour_mpx_per_view", "mvs.neighbour_pad_pct"):
        run = run_of(records, monkeypatch)
        reader = bench.load_module("metrics", name)
        assert reader.read(run) is None
        run.trace = None
        assert reader.read(run) is None
