"""RANSAC's batched 8-point solve and scoring on the device, with its
uploads and the read-back of the inlier masks (the program's own timer,
LAST_TIMINGS["ransac_ms"]), over the pairs of the window's calls."""

from mvebench.harness import sfm_spans

UNIT = "ms/pair"
LAYER = "SfM RANSAC"
MOVES = "sfmrecon_pairs_per_s"


def read(run):
    return sfm_spans.counter_ms(run, "ransac_ms", "pairs")
