"""The share of the traced window in which no operation ran on the
device: one minus the union of the kernel intervals over the window."""

UNIT = "%"
LAYER = "device"
MOVES = "dmrecon_views_per_s"


def read(run):
    if run.trace is None or not run.trace.kernels or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
