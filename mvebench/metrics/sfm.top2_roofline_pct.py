"""The top-2 passes' share of their roofline: the least time an H100
needs for the work the window's passes need (harness/sfm_work.py:
operations at a third of the TF32 tensor rate, bytes at HBM bandwidth),
over the device time of the kernels that ran inside the benchmark's
bench.sfm.match.* spans, whatever kernels implement the search."""

from mvebench.harness import sfm_work

UNIT = "%"
LAYER = "SfM matching"
MOVES = "sfmrecon_pairs_per_s"
SPANS = ("bench.sfm.match.lowres", "bench.sfm.match.sift", "bench.sfm.match.surf")


def read(run):
    passes = [p for c in run.calls for p in c.counters.get("top2", ())]
    if run.trace is None or not passes:
        return None
    kernel_s = sum(run.trace.kernel_s_inside(name) for name in SPANS)
    if kernel_s <= 0:
        return None
    least = sum(sfm_work.least_seconds(ops, nbytes)[0] for _, ops, nbytes in passes)
    return 100.0 * least / kernel_s
