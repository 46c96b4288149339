"""FSSR evaluation's share of its roofline: the least time an H100 needs
for the influence pairs that the window's samples and evaluated corners
need (harness/fssr_work.py, against harness/peaks.py's float32 rate
outside the tensor cores and HBM bandwidth), over the device time of the
kernels that ran inside the program's fssr.block_eval spans."""

from mvebench.harness import fssr_work, peaks

UNIT = "%"
LAYER = "kernel"
MOVES = "fssrecon_samples_per_s"


def read(run):
    calls = run.extra.get("calls")
    if run.trace is None or not calls:
        return None
    kernel_s = run.trace.kernel_s_inside("fssr.block_eval")
    if kernel_s <= 0:
        return None
    least = 0.0
    for samples, corners in calls:
        pairs = fssr_work.support_pairs(samples["pos"], samples["scale"], corners)
        least += fssr_work.least_seconds(pairs, len(samples["pos"]), len(corners),
                                         peaks.F32_FLOPS, peaks.HBM_BYTES)[0]
    return 100.0 * least / kernel_s
