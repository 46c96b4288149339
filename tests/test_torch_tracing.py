"""The port's instrumentation (utils/tracing.py, utils/compile_stats.py)
against mve_tpu's contract, on the CPU: trace_stage reads the same
environment variables, writes a Chrome trace of the block under
<MVE_TPU_TRACE_DIR>/<name>/ that names the span, and writes nothing
without the variable; FSSR's four spans are back where mve_tpu has them.
"""

import json
import os

import pytest
import torch

from mve_tpu.utils import compile_stats as jstats

from mve_tpu_torch.fssr.iso_octree import IsoOctree
from mve_tpu_torch.utils import compile_stats as pstats
from mve_tpu_torch.utils.tracing import trace_stage

from tests.test_torch_fssr import sphere

torch.set_num_threads(1)

FSSR_SPANS = ("fssr.voxel_set", "fssr.block_eval", "fssr.influence_pairs", "fssr.device_eval")


def _trace_names(path):
    with open(path) as f:
        return {e.get("name") for e in json.load(f)["traceEvents"]}


def test_trace_stage_writes_a_trace(tmp_path, monkeypatch):
    monkeypatch.setenv("MVE_TPU_TRACE_DIR", str(tmp_path))
    seen = []
    with trace_stage("unit.block", report=lambda n, s: seen.append((n, s))):
        torch.ones(64).cumsum(0)
    files = list((tmp_path / "unit.block").iterdir())
    assert len(files) == 1 and files[0].name.endswith(".pt.trace.json")
    assert "unit.block" in _trace_names(files[0])
    assert seen[0][0] == "unit.block" and seen[0][1] >= 0


def test_trace_stage_without_the_variable(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("MVE_TPU_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("MVE_TPU_TRACE_VERBOSE", "1")
    with trace_stage("unit.quiet"):
        pass
    assert list(tmp_path.iterdir()) == []
    assert "[trace] unit.quiet:" in capsys.readouterr().out


def test_trace_stage_marks_the_span_in_an_outer_profile(monkeypatch):
    monkeypatch.delenv("MVE_TPU_TRACE_DIR", raising=False)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace_stage("unit.inner"):
            torch.ones(8) * 2
    assert "unit.inner" in {e.name for e in prof.events()}


@pytest.mark.parametrize("pairwise", ["0", "1"])
def test_fssr_spans(tmp_path, monkeypatch, pairwise):
    """IsoOctree.compute_voxels on 300 samples: the dense path traces
    fssr.voxel_set and fssr.block_eval; the pair list fssr.voxel_set,
    fssr.influence_pairs and fssr.device_eval."""
    monkeypatch.setenv("MVE_TPU_TRACE_DIR", str(tmp_path))
    monkeypatch.setenv("MVE_TPU_FSSR_PAIRWISE", pairwise)
    _, ps = sphere(n=300)
    IsoOctree(device="cpu").compute_voxels(ps)
    want = {"fssr.voxel_set"} | ({"fssr.block_eval"} if pairwise == "0"
                                 else {"fssr.influence_pairs", "fssr.device_eval"})
    assert set(os.listdir(tmp_path)) == want
    for name in want:
        (trace,) = (tmp_path / name).iterdir()
        assert name in _trace_names(trace)
    assert want <= set(FSSR_SPANS)


def test_compile_stats_match_jax():
    for mod in (jstats, pstats):
        mod.reset()
        mod.record("ba_lm", 12.25)
        mod.record("ba_lm", 1.5)
        mod.record("other", 3.0)
    assert pstats.counts() == jstats.counts() == {"ba_lm": (2, 13.8), "other": (1, 3.0)}
    assert pstats.total_ms() == jstats.total_ms() and pstats.total_ms("x") == 0.0
    for mod in (jstats, pstats):
        mod.reset()
    assert pstats.counts() == {}
