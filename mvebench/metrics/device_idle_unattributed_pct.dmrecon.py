"""The share of the device's idle time that no stage of the program
explains: of the window's idle gaps between kernels (formed as
harness/trace.Trace.idle_gaps forms them), the time of those whose
midpoint no mvs.* or dmrecon.* span covers. dmrecon.call, which covers
the whole call, names no stage and is left out."""

from mvebench.harness import spans

UNIT = "%"
LAYER = "device"
MOVES = "dmrecon_views_per_s"


def read(run):
    trace = run.trace
    if trace is None or spans.MARK not in trace.spans:
        return None
    gaps = spans.idle_gaps(trace)
    total = sum(b - a for a, b in gaps)
    if not total:
        return None
    stages = spans.merged(r for name, ranges in trace.spans.items()
                          if name.startswith(("mvs.", "dmrecon.")) and name != "dmrecon.call"
                          for r in ranges)
    alone = sum(b - a for a, b in gaps if not spans.covers(stages, (a + b) // 2))
    return 100.0 * alone / total
