"""One traced run of a dmrecon cell of the benchmark, and the program's
spans of its window as tables.

    python3 tools/dmrecon_spans.py --workload <cell> --seed <n> [--seconds 51]
        [--out build/dmrecon_spans]

Runs mvebench's traced run (`--trace 1`) in this process, prints its
result line, then writes <out>/<cell>-<seed>.json and prints:
- each span's self time (its time less its children's) per view;
- the device time of each solver phase per view (the mvs.solve.<phase>
  spans' CUDA events);
- the window's idle seconds on the device by the innermost program span:
  each idle gap (as harness/trace.py forms them) split over the spans
  open during it, and, as device_idle_unattributed_pct.dmrecon and the
  ledger's idle gaps count, whole at its midpoint;
- each span's total against LAST_TIMINGS' (mvs.prepare, mvs.solve,
  mvs.write), and views/s over the bench.call ranges.
Needs a CUDA device, as mvebench/run.py does.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from mvebench.harness import bench, spans, trace as bench_trace  # noqa: E402
from mve_tpu_torch.utils import tracing  # noqa: E402


def tables(reduced, records, calls) -> dict:
    """calls: the program's counters of each call of the window."""
    views = sum(c["views"] for c in calls)
    recs = spans.calls_inside(reduced, records)
    child_ns: dict = {}
    for r in recs:
        if r.parent is not None:
            child_ns[r.parent] = child_ns.get(r.parent, 0) + (r.end_ns - r.start_ns)
    self_ms, total_ms, device_ms = {}, {}, {}
    for r in recs:
        d = r.end_ns - r.start_ns
        self_ms[r.name] = self_ms.get(r.name, 0.0) + (d - child_ns.get(r.id, 0)) / 1e6 / views
        total_ms[r.name] = total_ms.get(r.name, 0.0) + d / 1e6
        if r.device_ms is not None:
            device_ms[r.name] = device_ms.get(r.name, 0.0) + r.device_ms / views
    counters: dict = {}
    for r in recs:
        for k, v in r.counters.items():
            counters[f"{r.name}:{k}"] = counters.get(f"{r.name}:{k}", 0) + v / views

    gaps = spans.idle_gaps(reduced)
    named = sorted((r.start_ns, r.end_ns, r.name) for r in recs)
    inner = bench_trace._innermost_at(named, [(a + b) // 2 for a, b in gaps])
    idle_mid: dict = {}
    for (a, b), name in zip(gaps, inner):
        key = name or "(no program span)"
        idle_mid[key] = idle_mid.get(key, 0.0) + (b - a) / 1e9
    idle_split: dict = {}
    for a, b, name in _overlaps(gaps, _self_intervals(recs)):
        idle_split[name] = idle_split.get(name, 0.0) + (b - a) / 1e9
    idle_split["(no program span)"] = sum(b - a for a, b in gaps) / 1e9 - sum(idle_split.values())

    timed = {"mvs.prepare": "prepare_ms", "mvs.solve": "solve_ms", "mvs.write": "write_ms"}
    against = {name: [total_ms.get(name, 0.0), sum(c[key] for c in calls)]
               for name, key in timed.items()}
    bench_s = sum(b - a for a, b in reduced.spans.get("bench.call", [])) / 1e9
    return {"views": views, "self_ms_per_view": self_ms, "device_ms_per_view": device_ms,
            "counters_per_view": counters, "idle_s_split_by_innermost_span": idle_split,
            "idle_s_at_midpoint_by_innermost_span": idle_mid,
            "span_ms_against_last_timings": against,
            "views_per_s_over_bench_calls": views / bench_s if bench_s else None,
            "window_s": reduced.window_s, "busy_s": reduced.busy_s}


def _self_intervals(recs) -> list:
    """(start, end, name): where each span is the innermost open one,
    sorted and disjoint (spans nest; siblings do not overlap)."""
    kids: dict = {}
    for r in recs:
        kids.setdefault(r.parent, []).append(r)
    out = []
    for r in recs:
        cur = r.start_ns
        for c in sorted(kids.get(r.id, []), key=lambda c: c.start_ns):
            if c.start_ns > cur:
                out.append((cur, c.start_ns, r.name))
            cur = max(cur, c.end_ns)
        if r.end_ns > cur:
            out.append((cur, r.end_ns, r.name))
    return sorted(out)


def _overlaps(gaps, intervals) -> list:
    """(start, end, name) of each overlap of the sorted disjoint gaps with
    the sorted disjoint named intervals."""
    out, j = [], 0
    for a, b in gaps:
        while j < len(intervals) and intervals[j][1] <= a:
            j += 1
        k = j
        while k < len(intervals) and intervals[k][0] < b:
            s, e, name = intervals[k]
            if min(b, e) > max(a, s):
                out.append((max(a, s), min(b, e), name))
            k += 1
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51)
    p.add_argument("--out", default=str(ROOT / "build" / "dmrecon_spans"))
    args = p.parse_args()
    captured = {}
    reduce, run_cell = bench_trace.reduce_profile, bench.run_cell

    def keep_trace(prof, window_s):
        captured["trace"] = reduce(prof, window_s)
        return captured["trace"]

    def keep_calls(*a, **kw):
        result = run_cell(*a, **kw)
        captured["calls"] = [c[3] for c in result["_calls"]]
        return result

    bench_trace.reduce_profile, bench.run_cell = keep_trace, keep_calls
    tracing.clear()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main(["--workload", args.workload, "--seed", str(args.seed),
                         "--seconds", str(args.seconds), "--trace", "1"])
    line = out.getvalue().strip().splitlines()[-1] if out.getvalue().strip() else ""
    print(line)
    if rc != 0 or "trace" not in captured:
        return rc or 1
    result = json.loads(line)
    t = tables(captured["trace"], tracing.records(), captured["calls"])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    t.update(cell=args.workload, seed=args.seed, card=smi, metrics=result["metrics"])
    dest = Path(args.out)
    dest.mkdir(parents=True, exist_ok=True)
    (dest / f"{args.workload}-{args.seed}.json").write_text(json.dumps(t, indent=1))
    print(json.dumps(t))
    return 0


if __name__ == "__main__":
    sys.exit(main())
