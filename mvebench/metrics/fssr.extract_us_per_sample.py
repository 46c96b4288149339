"""The time of the surface's extraction (DualContouring.extract_mesh), from LAST_STATS["extract_ms"], over the input samples of the window's calls."""

UNIT = "us/sample"
LAYER = "FSSR extraction"
MOVES = "fssrecon_samples_per_s"


def read(run):
    samples = sum(c.counters["samples"] for c in run.calls)
    return 1e3 * sum(c.counters["extract_ms"] for c in run.calls) / samples if samples else None
