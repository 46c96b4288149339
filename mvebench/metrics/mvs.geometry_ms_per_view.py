"""A view's host geometry (mvs/dmrecon: the scene's feature visibility,
global view selection, feature seeds, reprojection, ray geometry and
rectification), from the program's mvs.scene_inputs, mvs.view_selection,
mvs.seeds and mvs.rectify spans, over the views of the window's calls."""

from mvebench.harness import spans

UNIT = "ms/view"
LAYER = "MVS host preparation"
MOVES = "dmrecon_views_per_s"


def read(run):
    return spans.ms_per_view(run, ("mvs.scene_inputs", "mvs.view_selection", "mvs.seeds",
                                   "mvs.rectify"))
