"""Loading a view's level images (mvs/pyramid.ImagePyramidCache.get_level
on a cache miss: decode, gray, halvings), from the program's
mvs.load_level spans, over the views of the window's calls."""

from mvebench.harness import spans

UNIT = "ms/view"
LAYER = "MVS host preparation"
MOVES = "dmrecon_views_per_s"


def read(run):
    return spans.ms_per_view(run, ("mvs.load_level",))
