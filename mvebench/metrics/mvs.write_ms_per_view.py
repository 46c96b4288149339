"""Writing a view's results (mvs/dmrecon._write_outputs, then the app's
View.save_view and cache_cleanup), from the program's mvs.write and
dmrecon.save spans, over the views of the window's calls."""

from mvebench.harness import spans

UNIT = "ms/view"
LAYER = "MVS writes"
MOVES = "dmrecon_views_per_s"


def read(run):
    return spans.ms_per_view(run, ("mvs.write", "dmrecon.save"))
