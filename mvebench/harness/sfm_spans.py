"""What the readers of the sfmrecon cell share: the benchmark's own
bench.sfm.* spans in the window's trace (drivers/sfmrecon.py opens them
in a traced run) and the counters each call returned, over the views or
pairs of the window's calls. A reader finds nothing to read, and
returns None, where the trace holds none of its spans or no call has
its counter. (harness/spans.ms_per_view reads the program's own dmrecon
spans, and only where dmrecon's mark span is in the trace.)"""

from __future__ import annotations


def total(run, key: str) -> int:
    return sum(c.counters.get(key, 0) for c in run.calls)


def span_ms(run, names, per: str) -> float | None:
    """Milliseconds of the named spans over the calls' `per` (views, pairs)."""
    n = total(run, per)
    if run.trace is None or not n or not any(name in run.trace.spans for name in names):
        return None
    ns = sum(b - a for name in names for a, b in run.trace.spans.get(name, []))
    return ns / 1e6 / n


def counter_ms(run, key: str, per: str) -> float | None:
    """A program counter in milliseconds (sfmrecon's LAST_TIMINGS), summed
    over the calls that have it, over those calls' `per`. The program
    keeps it in every call, traced or not."""
    have = [c for c in run.calls if key in c.counters]
    n = sum(c.counters.get(per, 0) for c in have)
    if not have or not n:
        return None
    return sum(c.counters[key] for c in have) / n
