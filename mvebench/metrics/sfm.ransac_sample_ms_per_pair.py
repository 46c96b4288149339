"""RANSAC's host draw of the 8-point samples (the program's own timer,
LAST_TIMINGS["ransac_sample_ms"]), over the pairs of the window's calls."""

from mvebench.harness import sfm_spans

UNIT = "ms/pair"
LAYER = "SfM RANSAC"
MOVES = "sfmrecon_pairs_per_s"


def read(run):
    return sfm_spans.counter_ms(run, "ransac_sample_ms", "pairs")
