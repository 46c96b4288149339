"""Host preparation of a dmrecon view (mvs/dmrecon._prepare_view: view
selection, level images, rectification), from the program's own
LAST_TIMINGS["prepare_ms"], over the views of the window's calls."""

UNIT = "ms/view"
LAYER = "MVS host preparation"
MOVES = "dmrecon_views_per_s"


def read(run):
    views = sum(c.counters["views"] for c in run.calls)
    return sum(c.counters["prepare_ms"] for c in run.calls) / views if views else None
