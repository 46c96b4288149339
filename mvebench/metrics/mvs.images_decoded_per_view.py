"""Images decoded for a view (level-0 misses of mvs/pyramid's cache: the
view and each neighbour not yet read in its call), from the program's
`images_decoded` counter, over the views of the window's calls."""

from mvebench.harness import spans

UNIT = "images/view"
LAYER = "MVS host preparation"
MOVES = "dmrecon_views_per_s"


def read(run):
    records, views = spans.call_records(run), spans.views(run)
    if records is None or not views:
        return None
    return sum(r.counters.get("images_decoded", 0) for r in records) / views
