"""The readers of the program's spans and counters (the mvs.* metrics
that read mve_tpu_torch/utils/tracing.py, and
device_idle_unattributed_pct.dmrecon) on a hand-built trace and record
list: one dmrecon call of 2 views inside a bench.call range, kernels in
its solve, an idle gap whose midpoint only dmrecon.call covers and one
that no span covers, and a call recorded outside every bench.call range,
which the counters leave out. A program without the spans reads None."""

import pytest

from mvebench.harness import bench
from mvebench.harness.trace import Trace
from mve_tpu_torch.utils import tracing
from mve_tpu_torch.utils.tracing import SpanRecord

READERS = ("mvs.image_load_ms_per_view", "mvs.images_decoded_per_view",
           "mvs.geometry_ms_per_view", "mvs.write_ms_per_view", "mvs.solve_device_busy_pct",
           "device_idle_unattributed_pct.dmrecon")

SPANS = {
    "bench.call": [(0, 10_000), (20_000, 30_000)],
    "dmrecon.call": [(100, 9_900)],
    "mvs.prepare": [(200, 4_000)],
    "mvs.scene_inputs": [(200, 300)],
    "mvs.view_selection": [(300, 400)],
    "mvs.load_level": [(400, 1_400), (1_400, 2_400)],
    "mvs.seeds": [(2_400, 2_500)],
    "mvs.rectify": [(2_500, 4_000)],
    "mvs.solve": [(4_000, 8_000)],
    "mvs.write": [(8_000, 8_500)],
    "dmrecon.save": [(8_500, 9_500)],
}
# Gaps: 900 ns in mvs.solve, 2,600 in mvs.write, 100 where only
# dmrecon.call is open, 15,200 outside every span.
KERNELS = [(4_100, 5_100, "k"), (6_000, 7_000, "k"), (9_600, 9_650, "k"), (9_750, 9_800, "k"),
           (25_000, 25_100, "k")]
RECORDS = [
    SpanRecord("dmrecon.call", 1, None, 1, 150, 9_850),
    SpanRecord("mvs.prepare_view", 2, 1, 1, 350, 3_950, {"level_hits": 3}),
    SpanRecord("mvs.load_level", 3, 2, 1, 450, 1_350, {"images_decoded": 1}),
    SpanRecord("mvs.load_level", 4, 2, 1, 1_450, 2_350, {"images_decoded": 1}),
    SpanRecord("dmrecon.call", 5, None, 5, 40_000, 50_000),
    SpanRecord("mvs.load_level", 6, 5, 5, 41_000, 42_000, {"images_decoded": 7}),
]
WANT = {
    "mvs.image_load_ms_per_view": 2_000 / 1e6 / 2,
    "mvs.images_decoded_per_view": 1.0,
    "mvs.geometry_ms_per_view": 1_800 / 1e6 / 2,
    "mvs.write_ms_per_view": 1_500 / 1e6 / 2,
    "mvs.solve_device_busy_pct": 100.0 * 2_000 / 4_000,
    "device_idle_unattributed_pct.dmrecon": 100.0 * 15_300 / 18_800,
}


def run_of(spans, records=RECORDS, monkeypatch=None):
    monkeypatch.setattr(tracing, "records", lambda: records)
    trace = Trace(window_s=3e-5, kernels=KERNELS, spans=spans, host_ops=[])
    call = bench.Call(spec=(0, 1), seconds=1e-5, work=2, counters={"views": 2})
    return bench.Run(calls=[call], trace=trace, window_peak_bytes=0, extra={})


@pytest.mark.parametrize("name", READERS)
def test_reader_on_a_hand_built_trace(name, monkeypatch):
    value = bench.load_module("metrics", name).read(run_of(SPANS, monkeypatch=monkeypatch))
    assert value == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_reader_without_the_programs_spans(name, monkeypatch):
    """A program from before the spans: the trace holds bench.call alone
    and tracing has no records()."""
    reader = bench.load_module("metrics", name)
    run = run_of({"bench.call": SPANS["bench.call"]}, monkeypatch=monkeypatch)
    monkeypatch.delattr(tracing, "records")
    assert reader.read(run) is None
    run.trace = None
    assert reader.read(run) is None


def test_records_outside_bench_call_are_left_out(monkeypatch):
    """Only the call outside every bench.call range recorded: nothing to read."""
    reader = bench.load_module("metrics", "mvs.images_decoded_per_view")
    assert reader.read(run_of(SPANS, RECORDS[4:], monkeypatch=monkeypatch)) is None
