"""The street cell (kitti00-dmrecon-s0): its frozen generator against the
program's reference, its driver's chunks, its check against injected
faults and the control, and its warp-solver reader on hand-built
records.

- harness/street.py reproduces mve_tpu_torch/synthetic_street.py
  (cameras, textures, images, truth, resolvable pixels, SfM points) for
  3 seeds, on the CPU;
- the driver reconstructs only the frames between the lead frames;
- reference/dmrecon_street.judge passes the truth written as the
  program's maps and fails a missing map, a view's depths scaled by 1.1,
  three quarters of a view's depths left out and the control (camera-z
  depth), under the committed limits;
- a small run of the cell (bench.run_cell on the CPU) passes limits set
  from its own readings, and comes out not correct with the warp solver
  returning its seed depths, with an answer altered and with half of
  each view's depths dropped;
- with marker `chip`, the program passes and the control fails at the
  cell's own size.
"""

import contextlib
import os
import time

import numpy as np
import pytest
import torch

from mvebench import controls
from mvebench.harness import bench, street
from mvebench.reference import dmrecon_street as ref
from mve_tpu_torch import synthetic_street as program_street
from mve_tpu_torch.utils import tracing
from mve_tpu_torch.utils.tracing import SpanRecord

torch.set_num_threads(4)
CELL = "kitti00-dmrecon-s0"
MANIFEST = bench.load_json(bench.ROOT / "BENCHMARK.json")
WORKLOAD = bench.load_json(bench.HERE / "workloads" / f"{CELL}.json")
CONFIG = bench.load_json(bench.HERE / "configs" / "kitti00.json")
W, H = 248, 76


@pytest.mark.parametrize("seed", [1, 20261018, 2**31 + 99])
def test_frozen_copy_matches_the_program_reference(seed):
    n = 8
    a_cams = street.make_cameras(n, street.rng_for(seed, 0))
    b_cams = program_street.make_cameras(n, program_street.rng_for(seed, 0))
    for a, b in zip(a_cams, b_cams):
        assert np.array_equal(a.R, b.R) and np.array_equal(a.t, b.t) and a.flen == b.flen
    a_tex, b_tex = street.textures_for(seed), program_street.textures_for(seed)
    assert all(np.array_equal(x, y) for x, y in zip(a_tex, b_tex))
    wall_z = street.cross_wall_z(n)
    assert wall_z == program_street.cross_wall_z(n)
    for v in (0, 3, 7):
        assert np.array_equal(street.render_gray(a_tex, a_cams[v], W, H, wall_z, torch, "cpu"),
                              program_street.render_gray(b_tex, b_cams[v], W, H, wall_z, torch,
                                                         "cpu"))
        assert np.array_equal(street.truth_depth(a_cams[v], W, H, wall_z, torch, "cpu"),
                              program_street.truth_depth(b_cams[v], W, H, wall_z, torch, "cpu"))
        assert np.array_equal(street.resolvable(a_cams, v, W, H, torch, "cpu"),
                              program_street.resolvable(b_cams, v, W, H, torch, "cpu"))
    pa, va = street.bundle_points(300, a_cams, W, H, street.rng_for(seed, 3), torch)
    pb, vb = program_street.bundle_points(300, b_cams, W, H, program_street.rng_for(seed, 3),
                                          torch)
    assert np.array_equal(pa, pb) and np.array_equal(va, vb)


@pytest.fixture(scope="module")
def small_street(tmp_path_factory):
    cfg = dict(CONFIG, views=6, width=W, height=H, bundle_points=400, lead_frames=1)
    path = str(tmp_path_factory.mktemp("street") / "scene")
    cams = street.write_scene(path, cfg, 7, torch, "cpu", threads=2)
    return path, cams, cfg


def write_maps(path, cams, due, scale=None, leave_out=None, thin=None):
    """The truth written as the program's depth-L0 and conf-L0 maps; view
    `thin` keeps only every fourth row."""
    from mve_tpu_torch.core import image_io

    wall_z = street.cross_wall_z(len(cams))
    for v in due:
        d = street.view_dir(path, v)
        for name in ("depth-L0", "conf-L0"):
            if os.path.exists(os.path.join(d, f"{name}.mvei")):
                os.remove(os.path.join(d, f"{name}.mvei"))
        if v == leave_out:
            continue
        depth = street.truth_depth(cams[v], W, H, wall_z, torch, "cpu").astype(np.float32)
        if v == scale:
            depth *= 1.1
        if v == thin:
            depth[np.arange(H) % 4 != 0] = 0
        image_io.save_mvei(depth[..., None], os.path.join(d, "depth-L0.mvei"))
        image_io.save_mvei((depth > 0).astype(np.float32)[..., None],
                           os.path.join(d, "conf-L0.mvei"))


def judge(small, **faults):
    path, cams, cfg = small
    due = [1, 2, 3]
    write_maps(path, cams, due, **faults)
    checks, attempted, failed, _ = ref.judge(path, cams, cfg, WORKLOAD, due)
    return failed == 0 and all(c["value"] <= c["limit"] for c in checks.values()), failed


def test_the_truth_passes(small_street):
    assert judge(small_street) == (True, 0)


@pytest.mark.parametrize("fault", [{"leave_out": 2}, {"scale": 3}, {"thin": 1}])
def test_the_check_catches(small_street, fault):
    assert judge(small_street, **fault) == (False, 1)


def test_the_control_fails(small_street):
    path, cams, cfg = small_street
    maps = {}
    for v in (1, 2, 3):
        depth = ref.z_depth_control(cams, v, W, H)
        maps[v] = (depth, np.ones_like(depth))
    checks, attempted, failed, _ = ref.judge(path, cams, cfg, WORKLOAD, [1, 2, 3], maps)
    assert failed == attempted == 3
    for name in ("median_err", "gross_share"):
        assert checks[name]["value"] > checks[name]["limit"]


def test_the_driver_reconstructs_only_between_the_lead_frames(tmp_path):
    driver = bench.load_module("drivers", "dmrecon_street").Driver(
        WORKLOAD, CONFIG, 2**31 + 5, "cpu", str(tmp_path), False)
    lead, n = CONFIG["lead_frames"], CONFIG["views"]
    assert [v for c in driver.chunks for v in c] == list(range(lead, n - lead))
    assert all(len(c) == WORKLOAD["views_per_call"] for c in driver.chunks)
    first = next(driver.specs())
    assert first == tuple(driver.chunks[driver.start]) and 0 <= driver.start < len(driver.chunks)


# ---------------------------------------------------------------------------
# a small run of the cell on the CPU, sound and broken
# ---------------------------------------------------------------------------

def run_small(workdir, limits):
    cell = bench.find_entry(MANIFEST["workloads"], CELL, "workload")
    config = dict(CONFIG, views=6, width=W, height=H, bundle_points=400, lead_frames=1)
    workload = dict(WORKLOAD, views_per_call=2, limits=limits)
    workdir.mkdir()
    return bench.run_cell(cell, workload, config, MANIFEST, 20261018, 1e-3, False, "cpu",
                          str(workdir), time.perf_counter())


@contextlib.contextmanager
def patched(module, name, make):
    real = getattr(module, name)
    setattr(module, name, make(real))
    try:
        yield
    finally:
        setattr(module, name, real)


def faults():
    from mve_tpu_torch.mvs import dmrecon as mvs
    from mve_tpu_torch.mvs import solver

    def unchanged(real):
        def solve(ref_img, neigh, nvalid, T, tvec, ray_z, init, *args, **kwargs):
            B, Hs, Ws = init.shape
            return (init, torch.ones_like(init), torch.zeros(B, Hs, Ws, 2),
                    torch.full((B,), Hs * Ws))
        return solve

    def altered(real):
        def run_batch(prepared, *args, **kwargs):
            depth, conf, dz, n = real(prepared, *args, **kwargs)
            for b, p in enumerate(prepared):
                if p["view_id"] % 2 == 1:
                    depth[b] *= 1.1
            return depth, conf, dz, n
        return run_batch

    def dropped(real):
        def run_batch(prepared, *args, **kwargs):
            depth, conf, dz, n = real(prepared, *args, **kwargs)
            depth[:, ::2] = 0
            conf[:, ::2] = 0
            return depth, conf, dz, n
        return run_batch

    return {"state unchanged": (solver, "solve_batch", unchanged),
            "an answer altered": (mvs, "_run_batch", altered),
            "half of each view's depths dropped": (mvs, "_run_batch", dropped)}


SHARES = ("res_bad_share", "gross_share")


def test_faults_come_out_not_correct(tmp_path):
    """Limits from the sound run's readings, as test_bench_faults sets
    them: a quarter of the way to 1 for a share of pixels, twice the
    reading otherwise, 0 where the committed limit is 0."""
    sound = run_small(tmp_path / "sound", dict.fromkeys(WORKLOAD["limits"], 1.0))
    assert sound["failed"] == 0 and sound["attempted"] == 2
    limits = {k: 0.0 if WORKLOAD["limits"][k] == 0
              else c["value"] + (1.0 - c["value"]) / 4 if k in SHARES
              else max(2.0 * c["value"], 1e-3)
              for k, c in sound["checks"].items()}
    assert run_small(tmp_path / "again", limits)["correct"]
    for name, (module, attr, make) in faults().items():
        with patched(module, attr, make):
            broken = run_small(tmp_path / name.replace(" ", "_"), limits)
        assert not broken["correct"], (name, broken["checks"], limits)


# ---------------------------------------------------------------------------
# the warp-solver readers
# ---------------------------------------------------------------------------

RECORDS = [
    SpanRecord("dmrecon.call", 1, None, 1, 100, 9_900),
    SpanRecord("mvs.solve", 2, 1, 1, 1_000, 5_000, {"views_warp": 2}),
    SpanRecord("mvs.solve.warp_sweep", 3, 2, 1, 1_100, 1_500, device_ms=1.5),
    SpanRecord("mvs.solve.warp_accept", 4, 2, 1, 1_500, 2_000, device_ms=0.5),
    SpanRecord("mvs.solve.warp_sweep", 5, 2, 1, 2_100, 2_500, device_ms=2.0),
    SpanRecord("mvs.solve", 6, 1, 1, 6_000, 7_000, {"views_sweep": 1}),
    SpanRecord("mvs.solve.cube", 7, 6, 1, 6_100, 6_500, device_ms=9.0),
    SpanRecord("dmrecon.call", 8, None, 8, 40_000, 50_000),
    SpanRecord("mvs.solve", 9, 8, 8, 41_000, 49_000, {"views_warp": 5}),
]
READER = "mvs.warp_device_ms_per_view"


def run_of(records, monkeypatch, spans=None):
    from mvebench.harness.trace import Trace

    monkeypatch.setattr(tracing, "records", lambda: records)
    spans = spans or {"bench.call": [(0, 10_000)], "dmrecon.call": [(100, 9_900)],
                      "mvs.prepare": [(200, 900)]}
    trace = Trace(window_s=1e-5, kernels=[], spans=spans, host_ops=[])
    call = bench.Call(spec=(0, 1, 2), seconds=1e-5, work=3,
                      counters={"views": 3, "views_warp": 2, "views_sweep": 1})
    return bench.Run(calls=[call], trace=trace, window_peak_bytes=0, extra={})


def test_warp_reader_on_hand_built_records(monkeypatch):
    """The warp phases' device time of the calls in the window (the first
    call's records), over the warp views its mvs.solve records count."""
    reader = bench.load_module("metrics", READER)
    assert reader.read(run_of(RECORDS, monkeypatch)) == pytest.approx(4.0 / 2, rel=1e-12)


def test_warp_reader_without_the_programs_spans(monkeypatch):
    """A program from before the warp spans: no views_warp counter and no
    mvs.solve.warp_* records, or no records() at all."""
    reader = bench.load_module("metrics", READER)
    old = [r for r in RECORDS[:8] if not r.name.startswith("mvs.solve")]
    assert reader.read(run_of(old, monkeypatch)) is None
    run = run_of(RECORDS, monkeypatch)
    monkeypatch.delattr(tracing, "records")
    assert reader.read(run) is None


def test_solve_readers_read_the_warp_solver(monkeypatch):
    """mvs.solve_ms_per_view and mvs.solve_device_busy_pct read whatever
    solver ran inside mvs.solve: the driver's solve_ms counter and the
    kernels inside the mvs.solve spans."""
    from mvebench.harness.trace import Trace

    run = run_of(RECORDS, monkeypatch)
    run.calls[0].counters["solve_ms"] = 600.0
    assert bench.load_module("metrics", "mvs.solve_ms_per_view").read(run) == 200.0
    trace = Trace(window_s=1e-5, kernels=[(1_000, 3_000, "k")],
                  spans={"mvs.solve": [(1_000, 5_000)]}, host_ops=[])
    run = bench.Run(calls=run.calls, trace=trace, window_peak_bytes=0, extra={})
    busy = bench.load_module("metrics", "mvs.solve_device_busy_pct").read(run)
    assert busy == pytest.approx(50.0)


def test_entries_of_the_cell():
    per_layer = {m["name"]: m for m in MANIFEST["per_layer"]}
    assert per_layer[READER]["workloads"] == [CELL]
    assert per_layer[READER]["layer"] == "MVS warp solver"
    assert not {"mvs.warp_solve_ms_per_view", "mvs.warp_view_share_pct"} & set(per_layer)
    for name in ("mvs.prepare_ms_per_view", "mvs.image_load_ms_per_view",
                 "mvs.images_decoded_per_view", "mvs.geometry_ms_per_view",
                 "mvs.write_ms_per_view", "device_idle_pct.dmrecon", "device_peak_gb.dmrecon",
                 "device_idle_unattributed_pct.dmrecon", "mvs.solve_ms_per_view",
                 "mvs.solve_device_busy_pct"):
        assert per_layer[name]["workloads"][-1] == CELL
    (rate,) = [m for m in MANIFEST["end_to_end"] if m["name"] == "dmrecon_views_per_s"]
    assert CELL in rate["workloads"]


@pytest.mark.chip
def test_control_fails_where_the_program_passes_at_the_cells_size(card):
    r = controls.readings(CELL, 7101, 1, "cuda")
    assert r["program_failed"] == 0, r["program"]
    assert all(c["value"] <= c["limit"] for c in r["program"].values()), r["program"]
    assert r["control_failed"] == r["attempted"] > 0, r["control"]
