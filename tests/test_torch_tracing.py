"""The port's instrumentation (utils/tracing.py, utils/compile_stats.py)
against mve_tpu's contract, on the CPU: trace_stage reads the same
environment variables, writes a Chrome trace of the block under
<MVE_TPU_TRACE_DIR>/<name>/ that names the span, and writes nothing
without the variable; FSSR's four spans are back where mve_tpu has them.
Then the port's own: dmrecon's span tree, its records on the profiler's
clock, its counters and LAST_TIMINGS, one trace for nested spans, and
nothing kept, no CUDA event and no sync with recording off.
"""

import json
import os

import pytest
import torch

from mve_tpu.utils import compile_stats as jstats

from mve_tpu_torch.apps import dmrecon as dmrecon_app
from mve_tpu_torch.core import Scene, image_io
from mve_tpu_torch.fssr.iso_octree import IsoOctree
from mve_tpu_torch.mvs import dmrecon as mvs_dmrecon
from mve_tpu_torch.utils import compile_stats as pstats
from mve_tpu_torch.utils import tracing
from mve_tpu_torch.utils.tracing import trace_stage

from tests.synthetic import make_plane_scene
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


# ---------------------------------------------------------------------------
# span, count and records on dmrecon: one call on the 5-view 192x144 plane
# scene of tests/test_torch_dmrecon.py at scale 1, under a CPU profiler.
# ---------------------------------------------------------------------------

PHASES = ["mvs.solve.cube", "mvs.solve.lookup", "mvs.solve.exact", "mvs.solve.center_plane",
          "mvs.solve.accept"]


def _children(recs):
    out = {}
    for r in recs:
        out.setdefault(r.parent, []).append(r)
    return {k: sorted(v, key=lambda r: r.start_ns) for k, v in out.items()}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    path = tmp_path_factory.mktemp("spans") / "scene"
    make_plane_scene(str(path), n_views=5, width=192, height=144)
    return str(path)


@pytest.fixture(scope="module")
def traced(scene):
    """reconstruct_views of views 0 and 1 (one solver batch) under a CPU
    profiler: the records, the profiler's record_function ranges by name,
    LAST_TIMINGS and the views whose image was decoded."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    # The first record_function of a process under a profiler stamps its
    # start about 1.5 ms before it returns; a warm-up keeps that out.
    with torch.profiler.profile(activities=acts):
        with torch.profiler.record_function("warm-up"):
            pass
    tracing.clear()
    decoded = []
    load = image_io.load_image

    def counting_load(path):
        if os.path.basename(path).startswith("undistorted"):
            decoded.append(os.path.dirname(path))
        return load(path)

    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("MVE_TPU_TRACE_DIR", raising=False)
        mp.setattr(image_io, "load_image", counting_load)
        with torch.profiler.profile(activities=acts) as prof:
            n = dmrecon_app.reconstruct_views(scene, scale=1, view_ids={0, 1}, force=True,
                                              verbose=False, device="cpu")
    assert n == 2
    marks = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            marks.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    recs = list(tracing.records())
    tracing.clear()
    return recs, marks, dict(mvs_dmrecon.LAST_TIMINGS), decoded


def test_dmrecon_span_tree(traced, scene):
    recs = traced[0]
    (root,) = [r for r in recs if r.parent is None]
    assert root.name == "dmrecon.call" and {r.call for r in recs} == {root.id}
    kids = _children(recs)
    names = lambda rid: [r.name for r in kids.get(rid, [])]  # noqa: E731
    assert names(root.id) == ["dmrecon.scene_open", "mvs.prepare", "mvs.solve",
                              "mvs.write", "mvs.write", "dmrecon.save", "dmrecon.save"]
    by = {r.name: r for r in kids[root.id]}
    assert names(by["mvs.prepare"].id) == ["mvs.scene_inputs", "mvs.prepare_view",
                                           "mvs.prepare_view"]
    assert names(by["mvs.solve"].id) == ["mvs.pack", "mvs.upload"] + PHASES * 2 + ["mvs.readback"]
    (inputs,) = [r for r in recs if r.name == "mvs.scene_inputs"]
    assert inputs.counters == {"features": 60}
    for view in kids[by["mvs.prepare"].id][1:]:
        inner = names(view.id)
        loads = inner.count("mvs.load_level")
        assert inner == ["mvs.view_selection"] + ["mvs.load_level"] * loads + ["mvs.seeds",
                                                                            "mvs.rectify"]
        # The reference view and its 4 neighbours: each a miss or a hit.
        assert loads + view.counters.get("level_hits", 0) == 5
    # Global view selection counts the reference's features, the columns
    # it keeps.
    bundle = Scene(scene).get_bundle()
    sees = [sum(any(r.view_id == v for r in f.refs) for f in bundle.features) for v in (0, 1)]
    selections = [kids[view.id][0] for view in kids[by["mvs.prepare"].id][1:]]
    assert [r.counters for r in selections] == [{"vs_features": n} for n in sees]
    assert 0 < min(sees)
    first, second = kids[by["mvs.prepare"].id][1:]
    assert names(first.id).count("mvs.load_level") == 5 and second.counters == {"level_hits": 5}
    for key, name in (("bytes_h2d", "mvs.upload"), ("bytes_d2h", "mvs.readback"),
                      ("bytes_written", "dmrecon.save")):
        assert all(r.counters[key] > 0 for r in recs if r.name == name)
    # Siblings follow one another inside their parent.
    for parent in recs:
        seq = kids.get(parent.id, [])
        assert all(parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns for r in seq)
        assert all(a.end_ns <= b.start_ns for a, b in zip(seq, seq[1:]))


def test_spans_on_the_profilers_clock(traced):
    """A record is stamped just inside its record_function range. The
    thread can be descheduled between the two stamps, which only moves a
    record's stamps further inside, so: no record reaches more than 200 us
    outside its range (a clock off by more either way would), and the
    median distance of both ends from the range's is within 200 us."""
    recs, marks = traced[:2]
    inside = []
    for name in {r.name for r in recs}:
        mine = sorted((r.start_ns, r.end_ns) for r in recs if r.name == name)
        assert len(mine) == len(marks[name]), name
        for (a, b), (pa, pb) in zip(mine, sorted(marks[name])):
            assert a - pa >= -200_000 and pb - b >= -200_000, (name, a - pa, pb - b)
            inside += [abs(a - pa), abs(pb - b)]
    assert sorted(inside)[len(inside) // 2] <= 200_000


def test_images_decoded_counts_the_views_read(traced):
    recs, decoded = traced[0], traced[3]
    counted = sum(r.counters.get("images_decoded", 0) for r in recs)
    assert counted == len(set(decoded)) == len(decoded) == 5
    assert sum(r.counters.get("halvings", 0) for r in recs) == 5
    assert sum(r.counters.get("bytes_decoded", 0) for r in recs) == 5 * 192 * 144 * 3


def test_span_times_match_last_timings(traced):
    recs, timings = traced[0], traced[2]
    for name, key in (("mvs.prepare", "prepare_ms"), ("mvs.solve", "solve_ms")):
        ms = sum(r.end_ns - r.start_ns for r in recs if r.name == name) / 1e6
        assert abs(ms - timings[key]) <= 0.01 * timings[key], (name, ms, timings[key])


def test_trace_dir_writes_one_trace_for_nested_spans(scene, tmp_path, monkeypatch):
    """With MVE_TPU_TRACE_DIR, the outermost span (dmrecon.call) writes
    the one trace, holding the spans inside it; inside a running profiler
    no span starts another."""
    monkeypatch.setenv("MVE_TPU_TRACE_DIR", str(tmp_path))
    tracing.clear()
    dmrecon_app.reconstruct_views(scene, scale=1, view_ids={0}, force=True, verbose=False,
                                  device="cpu")
    assert os.listdir(tmp_path) == ["dmrecon.call"]
    (trace,) = (tmp_path / "dmrecon.call").iterdir()
    assert {"dmrecon.call", "mvs.prepare_view", "mvs.load_level", "mvs.solve.cube",
            "dmrecon.save"} <= _trace_names(trace)
    recs = tracing.records()
    assert recs and len({r.call for r in recs}) == 1 and recs[0].name == "dmrecon.call"
    tracing.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace_stage("unit.outer"):
            with tracing.span("unit.inner"):
                pass
    assert os.listdir(tmp_path) == ["dmrecon.call"]
    tracing.clear()


class _Forbidden(RuntimeError):
    pass


def test_recording_off_keeps_nothing(scene, monkeypatch):
    """No profiler and no MVE_TPU_TRACE_DIR: a dmrecon call keeps no
    record, count() does nothing, and no span creates a CUDA event or
    syncs, a span timing a CUDA device included."""
    def forbidden(*args, **kwargs):
        raise _Forbidden

    monkeypatch.delenv("MVE_TPU_TRACE_DIR", raising=False)
    monkeypatch.setattr(torch.cuda, "Event", forbidden)
    monkeypatch.setattr(torch.cuda, "synchronize", forbidden)
    tracing.clear()
    assert not torch.autograd._profiler_enabled()
    with tracing.span("unit.device", device="cuda"):
        tracing.count("unit", 3)
    tracing.count("unit")
    dmrecon_app.reconstruct_views(scene, scale=1, view_ids={0}, force=True, verbose=False,
                                  device="cpu")
    assert tracing.records() == []
    # Recording on, the same span does create its events.
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(_Forbidden):
            with tracing.span("unit.device", device="cuda"):
                pass
    tracing.clear()
