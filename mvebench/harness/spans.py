"""What the readers of the program's own spans and counters share
(mve_tpu_torch/utils/tracing.py: `span`, `count`, `records`).

Span totals come from the window's trace (each `record_function` range by
name). Counters come from the program's span records, limited to the
calls whose dmrecon.call record lies inside one of the window's
bench.call ranges (its midpoint, on the profiler's clock). A program
without these spans, such as one from before them, yields None.
"""

from __future__ import annotations

import bisect

#: A span the program opens in every dmrecon call that prepares a view.
MARK = "mvs.prepare"


def views(run) -> int:
    return sum(c.counters["views"] for c in run.calls)


def ms_per_view(run, names) -> float | None:
    """Milliseconds of the named spans over the views of the window's calls."""
    n = views(run)
    if run.trace is None or MARK not in run.trace.spans or not n:
        return None
    ns = sum(b - a for name in names for a, b in run.trace.spans.get(name, []))
    return ns / 1e6 / n


def merged(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def covers(union: list, t) -> bool:
    """Whether t lies in one of merged()'s intervals."""
    i = bisect.bisect_right(union, [t, float("inf")]) - 1
    return i >= 0 and union[i][0] <= t <= union[i][1]


def idle_gaps(trace) -> list:
    """The device's idle gaps (start, end) between the trace's kernels,
    formed as Trace.idle_gaps forms them."""
    gaps, end = [], None
    for a, b, _ in trace.kernels:
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    return gaps


def calls_inside(trace, records) -> list:
    """The records of the calls whose dmrecon.call record lies inside one
    of the trace's bench.call ranges."""
    windows = merged(trace.spans.get("bench.call", []))
    calls = {r.id for r in records if r.name == "dmrecon.call" and r.end_ns is not None
             and covers(windows, (r.start_ns + r.end_ns) // 2)}
    return [r for r in records if r.call in calls]


def call_records(run) -> list | None:
    """The program's span records of the calls the window timed, or None
    where the program keeps none."""
    if run.trace is None:
        return None
    from mve_tpu_torch.utils import tracing

    records = getattr(tracing, "records", None)
    return (calls_inside(run.trace, records()) or None) if records is not None else None
