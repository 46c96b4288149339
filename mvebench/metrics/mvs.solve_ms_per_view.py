"""The sweep solver's time a view (mvs/dmrecon._run_batch up to the read
back, closed by a device sync), from the program's own
LAST_TIMINGS["solve_ms"], over the views of the window's calls."""

UNIT = "ms/view"
LAYER = "MVS sweep solver"
MOVES = "dmrecon_views_per_s"


def read(run):
    views = sum(c.counters["views"] for c in run.calls)
    return sum(c.counters["solve_ms"] for c in run.calls) / views if views else None
