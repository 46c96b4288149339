"""The share of the sweep solver's time in which the device runs a
kernel: the device time of the kernels inside the program's mvs.solve
spans (each closed by the read-back's wait) over those spans' time."""

UNIT = "%"
LAYER = "MVS sweep solver"
MOVES = "dmrecon_views_per_s"


def read(run):
    ranges = run.trace.spans.get("mvs.solve") if run.trace is not None else None
    total_s = sum(b - a for a, b in ranges) / 1e9 if ranges else 0.0
    return 100.0 * run.trace.kernel_s_inside("mvs.solve") / total_s if total_s > 0 else None
