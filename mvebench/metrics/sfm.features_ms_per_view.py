"""Computing the views' features: the halvings to at most max_pixels
(Features._limit_size), then SIFT and SURF batched over the views
(sift/surf.detect_and_describe_batch), from the benchmark's
bench.sfm.resize, bench.sfm.sift and bench.sfm.surf spans, over the
views of the window's calls."""

from mvebench.harness import sfm_spans

UNIT = "ms/view"
LAYER = "SfM features"
MOVES = "sfmrecon_pairs_per_s"


def read(run):
    return sfm_spans.span_ms(run, ("bench.sfm.resize", "bench.sfm.sift", "bench.sfm.surf"),
                             "views")
