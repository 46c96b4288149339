"""The share of the neighbour tensor that is padding: 100 * (1 -
neigh_px / neigh_px_padded), the pixels of the neighbour images and of
the padded tensor that mvs/dmrecon._pack counts, each summed over the
window's mvs.pack records."""

from mvebench.harness import spans

UNIT = "%"
LAYER = "MVS host preparation"
MOVES = "dmrecon_views_per_s"


def read(run):
    packs = [r for r in spans.call_records(run) or []
             if r.name == "mvs.pack" and "neigh_px_padded" in r.counters]
    padded = sum(r.counters["neigh_px_padded"] for r in packs)
    if not padded:
        return None
    return 100.0 * (1.0 - sum(r.counters["neigh_px"] for r in packs) / padded)
