"""The neighbour tensor a view uploads and its solver gathers from:
neigh_px_padded (the pixels of the padded (B, J, Hn, Wn) tensor of
mvs/dmrecon._pack), summed over the window's mvs.pack records, in
millions, over the views of the window's calls."""

from mvebench.harness import spans

UNIT = "Mpx/view"
LAYER = "MVS host preparation"
MOVES = "dmrecon_views_per_s"


def read(run):
    records, views = spans.call_records(run), spans.views(run)
    packs = [r for r in records or [] if r.name == "mvs.pack" and "neigh_px_padded" in r.counters]
    if not packs or not views:
        return None
    return sum(r.counters["neigh_px_padded"] for r in packs) / 1e6 / views
