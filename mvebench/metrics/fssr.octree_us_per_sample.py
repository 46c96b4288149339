"""The time of the sample octree (fssr/dual_contouring.DualContouring -> fssr/octree.build_octree), from LAST_STATS["octree_ms"], over the input samples of the window's calls."""

UNIT = "us/sample"
LAYER = "FSSR octree"
MOVES = "fssrecon_samples_per_s"


def read(run):
    samples = sum(c.counters["samples"] for c in run.calls)
    return 1e3 * sum(c.counters["octree_ms"] for c in run.calls) / samples if samples else None
