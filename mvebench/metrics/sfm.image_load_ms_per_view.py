"""Decoding the views' images (View.get_image: the PNG read and decoded
on the host), from the benchmark's bench.sfm.load_image spans, over the
views of the window's calls."""

from mvebench.harness import sfm_spans

UNIT = "ms/view"
LAYER = "SfM image loading"
MOVES = "sfmrecon_pairs_per_s"


def read(run):
    return sfm_spans.span_ms(run, ("bench.sfm.load_image",), "views")
