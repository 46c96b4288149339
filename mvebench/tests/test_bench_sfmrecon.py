"""The sfmrecon cell's own pieces on the CPU: the entries that would list
it (unlisted/fountain11-sfmrecon-match.json) against the manifest's
rules, its control, its run with the timed path broken underneath
coming out not correct, the driver's probes holding a traced run and
refusing a program they no longer fit, the top-2 work count on counts
made by hand, and its readers on a hand-built trace and without the
spans they read. The cell is not in BENCHMARK.json (PERF.md, Open
questions), so tests/cells.py and the manifest's tests do not see it.

The faults (drivers/sfmrecon.py's run of 4 views of 480x320, limits set
from the sound run's readings as tests/test_bench_faults.py sets them):
half of the pairs left out of the matching, each match's index in the
second view shifted by one, one view's features returned empty, and no
prebundle written (a call that leaves its state unchanged)."""

import time

import numpy as np
import pytest
import torch

from mvebench import controls
from mvebench.harness import bench, sfm_work
from mvebench.harness.trace import Trace
from mvebench.tests import test_bench_manifest as rules
from mvebench.tests.test_bench_faults import limit, patched, run

torch.set_num_threads(4)
CELL = "fountain11-sfmrecon-match"
LISTING = bench.load_json(bench.HERE / "unlisted" / f"{CELL}.json")
#: BENCHMARK.json with the cell listed.
LISTED = dict(rules.MANIFEST, workloads=rules.MANIFEST["workloads"] + [LISTING["workload"]],
              end_to_end=rules.MANIFEST["end_to_end"] + LISTING["end_to_end"],
              per_layer=rules.MANIFEST["per_layer"] + LISTING["per_layer"])


def test_listing_keeps_the_manifest_rules(monkeypatch):
    """The manifest with the cell listed passes the manifest's own tests."""
    monkeypatch.setattr(rules, "MANIFEST", LISTED)
    monkeypatch.setattr(rules, "METRICS", LISTED["end_to_end"] + LISTED["per_layer"])
    rules.test_names_units_and_lines()
    rules.test_cell_resolves(LISTING["workload"])
    for metric in LISTING["per_layer"]:
        assert metric["workloads"] == [CELL]
        rules.test_reader_declares_its_metric(metric)


def small():
    cell = LISTING["workload"]
    workload = bench.load_json(bench.HERE / "workloads" / f"{CELL}.json")
    config = bench.load_json(bench.HERE / "configs" / f"{cell['config']}.json")
    config.update(views=4, width=480, height=320)
    # The committed floor is half the fewest correct matches a pair that
    # the cell's own size gave (1536x1024 feature images); at 480x320 a
    # pair gets about 600.
    workload["check"]["pair_matches_floor"] = 100
    return cell, workload, config


def test_control_fails_at_a_small_size():
    cell, workload, config = small()
    r = controls.readings(CELL, 11, 1, "cpu", workload, config, cell)
    assert r["control_failed"] == r["attempted"] > 0, r["control"]


@pytest.mark.chip
def test_control_fails_where_the_program_passes(card):
    """At the cell's own size: the program passes every committed limit
    and the control fails, on three seeds with three calls a seed."""
    for seed in (7001, 7002, 7003):
        r = controls.readings(CELL, seed, 3, "cuda", cell=LISTING["workload"])
        assert r["program_failed"] == 0, r["program"]
        assert all(c["value"] <= c["limit"] for c in r["program"].values()), r["program"]
        assert r["control_failed"] > 0, r["control"]


def sfmrecon_faults():
    from mve_tpu_torch.apps import sfmrecon
    from mve_tpu_torch.sfm.bundler import features, matching_batched

    def half(real):
        return lambda *args, **kwargs: real(*args, **kwargs)[::2]

    def shifted(real):
        def compute(self, viewports, *args, **kwargs):
            result = real(self, viewports, *args, **kwargs)
            for m in result:
                n_b = len(viewports[m.view_2_id].positions)
                m.matches[:, 1] = (m.matches[:, 1] + 1) % n_b
            return result
        return compute

    def empty(real):
        def compute_batched(self, images, viewports):
            real(self, images, viewports)
            vp = viewports[0]
            vp.positions = np.zeros((0, 2), np.float32)
            vp.colors = np.zeros((0, 3), np.uint8)
            vp.descriptors = np.zeros((0, 128), np.float32)
            vp.surf_descriptors = np.zeros((0, 64), np.float32)
            vp.num_sift = 0
            vp.track_ids = np.zeros(0, np.int32)
        return compute_batched

    def unwritten(real):
        return lambda *args, **kwargs: None

    return {"half the pairs left out": (matching_batched, "all_pairs", half),
            "each match's index in b shifted by one": (matching_batched.BatchedMatching,
                                                       "compute", shifted),
            "one view's features returned empty": (features.Features, "compute_batched", empty),
            "no prebundle written": (sfmrecon, "save_prebundle", unwritten)}


def test_faults_come_out_not_correct(tmp_path):
    cell, workload, config = small()
    sound = run(cell, workload, config, tmp_path / "sound", dict.fromkeys(workload["limits"], 1.0))
    limits = {k: limit(k, c["value"], workload["limits"][k]) for k, c in sound["checks"].items()}
    assert run(cell, workload, config, tmp_path / "again", limits)["correct"]
    for name, (module, attr, make) in sfmrecon_faults().items():
        with patched(module, attr, make):
            broken = run(cell, workload, config, tmp_path / name.replace(" ", "_").replace("'", ""),
                         limits)
        assert not broken["correct"], (name, broken["checks"], limits)


# --------------------------------------------------------------------------
# the driver's probes
# --------------------------------------------------------------------------

def probes():
    return bench.load_module("drivers", "sfmrecon").Probes(torch.device("cpu"), 500)


def test_probes_hold_a_traced_run(tmp_path):
    """A traced run opens every span once a call or once a view, with the
    three passes in order (the driver checks each call and would raise),
    gives each reader of a host span or counter a number, and restores
    what it wrapped."""
    from mve_tpu_torch.sfm.bundler import matching_batched

    real = matching_batched._match_pairs
    cell, workload, config = small()
    workload = dict(workload, limits=dict.fromkeys(workload["limits"], 1.0))
    (tmp_path / "traced").mkdir()
    result = bench.run_cell(cell, workload, config, LISTED, 20261018, 1e-3, True, "cpu",
                            str(tmp_path / "traced"), time.perf_counter())
    assert result["correct"]
    assert set(result["metrics"]) >= {"sfm.image_load_ms_per_view", "sfm.features_ms_per_view",
                                      "sfm.match_ms_per_pair", "sfm.ransac_sample_ms_per_pair",
                                      "sfm.ransac_solve_ms_per_pair"}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert matching_batched._match_pairs is real


def test_probes_refuse_a_matcher_with_other_arguments(monkeypatch):
    from mve_tpu_torch.sfm.bundler import matching_batched

    monkeypatch.setattr(matching_batched, "_match_pairs", lambda pairs, desc, n_desc: None)
    with pytest.raises(RuntimeError, match="_match_pairs takes"):
        probes().install()


def test_probes_refuse_a_stage_that_is_gone(monkeypatch):
    from mve_tpu_torch.sfm.bundler import features

    monkeypatch.delattr(features.Features, "_limit_size")
    p = probes()
    with pytest.raises(RuntimeError, match="_limit_size is gone"):
        p.install()
    p.remove()


OPENED = {"bench.sfm.load_image": 4, "bench.sfm.resize": 4, "bench.sfm.sift": 1,
          "bench.sfm.surf": 1, "bench.sfm.matching": 1, "bench.sfm.ransac.solve": 1,
          "bench.sfm.prebundle_write": 1}


@pytest.mark.parametrize("opened, order, fits", [
    ({}, ["lowres", "sift", "surf"], True),
    ({"bench.sfm.sift": 2}, ["lowres", "sift", "surf"], False),
    ({"bench.sfm.load_image": 0}, ["lowres", "sift", "surf"], False),
    ({}, ["sift", "surf"], False),
    ({}, ["lowres", "sift", "sift", "surf"], False),
], ids=("sound", "a span twice", "a span never", "a pass missing", "a pass too many"))
def test_probes_check_each_call(opened, order, fits):
    p = probes()
    p.begin()
    p.opened.update(OPENED | opened)
    p.passes = [(name, 1.0, 1.0) for name in order]
    if fits:
        p.check(4)
    else:
        with pytest.raises(RuntimeError, match="no longer fit"):
            p.check(4)


# --------------------------------------------------------------------------
# the top-2 work
# --------------------------------------------------------------------------

def test_pass_work_by_hand():
    # Views of 3, 0 and 5 descriptors of width 4; pairs (0, 2) and (1, 2).
    ops, nbytes = sfm_work.pass_work([3, 0, 5], [0, 1], [2, 2], 4)
    # (0, 2): 2 directions x 2 x 3 x 5 x 4 = 240; (1, 2): none.
    assert ops == 240
    # (0, 2): both blocks read both ways, 2 x 8 x 4 x 4 = 256, and 8 rows
    # of three outputs, 96; (1, 2): 2 x 5 x 4 x 4 = 160 and 5 rows, 60.
    assert nbytes == 256 + 96 + 160 + 60


def test_least_time_and_its_bound():
    s, by = sfm_work.least_seconds(3 * 494.7e12, 1)
    assert by == "operations" and np.isclose(s, 9.0)
    s, by = sfm_work.least_seconds(0, 3.35e12)
    assert by == "bytes" and np.isclose(s, 1.0)


# --------------------------------------------------------------------------
# the readers
# --------------------------------------------------------------------------

READERS = ("sfm.image_load_ms_per_view", "sfm.features_ms_per_view", "sfm.match_ms_per_pair",
           "sfm.ransac_sample_ms_per_pair", "sfm.ransac_solve_ms_per_pair",
           "sfm.top2_roofline_pct")
SPANS = {
    "bench.call": [(0, 100_000)],
    "bench.sfm.load_image": [(100, 1_100), (1_100, 2_100)],
    "bench.sfm.resize": [(2_100, 2_600), (2_600, 3_100)],
    "bench.sfm.sift": [(3_100, 13_100)],
    "bench.sfm.surf": [(13_100, 18_100)],
    "bench.sfm.match.lowres": [(20_000, 22_000)],
    "bench.sfm.match.sift": [(22_000, 30_000)],
    "bench.sfm.match.surf": [(30_000, 34_000)],
}
# 1,000 ns of kernels in lowres, 4,000 in sift, 2,000 in surf; one kernel
# outside every match span.
KERNELS = [(20_500, 21_500, "top2"), (23_000, 25_000, "top2"), (26_000, 28_000, "top2"),
           (31_000, 33_000, "top2"), (40_000, 50_000, "sift")]
# Work whose least time is 1.4e-6 s: operations of 0.7e-6 s at a third of
# the TF32 rate, bytes of 0.7e-6 s at HBM bandwidth.
OPS = 0.7e-6 * sfm_work.F32_VIA_TF32_FLOPS
BYTES = 0.7e-6 * 3.35e12
COUNTERS = {"pairs": 6, "views": 2, "ransac_sample_ms": 12, "ransac_ms": 30,
            "top2": [["lowres", OPS, 1.0], ["sift", 1.0, BYTES]]}
WANT = {
    "sfm.image_load_ms_per_view": 2_000 / 1e6 / 2,
    "sfm.features_ms_per_view": 16_000 / 1e6 / 2,
    "sfm.match_ms_per_pair": 14_000 / 1e6 / 6,
    "sfm.ransac_sample_ms_per_pair": 2.0,
    "sfm.ransac_solve_ms_per_pair": 5.0,
    "sfm.top2_roofline_pct": 100.0 * 1.4e-6 / 7e-6,
}


def run_of(spans, counters):
    trace = Trace(window_s=1e-4, kernels=KERNELS, spans=spans, host_ops=[])
    call = bench.Call(spec=0, seconds=1e-4, work=6, counters=counters)
    return bench.Run(calls=[call], trace=trace, window_peak_bytes=0, extra={})


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_hand_built_trace(name):
    value = bench.load_module("metrics", name).read(run_of(SPANS, COUNTERS))
    assert value == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_reader_without_the_spans(name):
    """A trace with bench.call alone and calls that counted nothing but
    their pairs and views; then no trace at all."""
    reader = bench.load_module("metrics", name)
    run = run_of({"bench.call": SPANS["bench.call"]}, {"pairs": 6, "views": 2})
    assert reader.read(run) is None
    run.trace = None
    assert reader.read(run) is None


@pytest.mark.parametrize("name", ("sfm.ransac_sample_ms_per_pair", "sfm.ransac_solve_ms_per_pair"))
def test_counter_reader_without_a_trace(name):
    """The program keeps its RANSAC timers in every call, traced or not."""
    run = run_of(SPANS, COUNTERS)
    run.trace = None
    assert bench.load_module("metrics", name).read(run) == pytest.approx(WANT[name], rel=1e-12)
