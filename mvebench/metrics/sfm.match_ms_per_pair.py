"""The three top-2 passes of the batched matcher (the low-res prefilter,
SIFT, SURF: matching_batched._match_pairs, each closed once the device
has finished), from the benchmark's bench.sfm.match.* spans, over the
pairs of the window's calls."""

from mvebench.harness import sfm_spans

UNIT = "ms/pair"
LAYER = "SfM matching"
MOVES = "sfmrecon_pairs_per_s"


def read(run):
    return sfm_spans.span_ms(run, ("bench.sfm.match.lowres", "bench.sfm.match.sift",
                                   "bench.sfm.match.surf"), "pairs")
