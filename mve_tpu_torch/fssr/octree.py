"""Sample octree (reference: libs/fssr/octree.h/.cc; port of
mve_tpu/fssr/octree.py, host numpy).

Samples insert at the level whose node size matches their scale (bigger
scale -> coarser level, octree.cc:153-230); the leaf set is the union of
nodes holding samples plus every cell a sample's surface band can cross
(|x - pos| < band x scale). Built with vectorized numpy over flat
(level, ix, iy, iz) keys instead of pointers.

The leaf set feeds the adaptive dual-contouring extractor
(dual_contouring.py); implicit-function evaluation reuses the batched
pair machinery from iso_octree.py at the leaf corner positions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from .sample import SampleList


@dataclasses.dataclass
class SampleOctree:
    center: np.ndarray          # root center
    root_size: float
    max_level: int
    # Leaves as arrays: level (L,), coords (L, 3) int64 in level units.
    leaf_level: np.ndarray
    leaf_coord: np.ndarray

    def node_size(self, level):
        return self.root_size / (2.0 ** level)

    def leaf_min_corner(self, idx):
        """World min corner of leaves idx."""
        size = self.node_size(self.leaf_level[idx])[..., None]
        origin = self.center - self.root_size / 2.0
        return origin + self.leaf_coord[idx] * size

    def lookup(self) -> Dict[Tuple[int, int, int, int], int]:
        """(level, ix, iy, iz) -> leaf index."""
        return {
            (int(l), int(c[0]), int(c[1]), int(c[2])): i
            for i, (l, c) in enumerate(zip(self.leaf_level, self.leaf_coord))
        }


def build_octree(samples: SampleList, max_level: int = 10,
                 band: float = 1.2) -> SampleOctree:
    """Construct the leaf set.

    Per sample: level = clamp(floor(log2(root/scale))); the sample marks
    every cell at its level overlapped by the cube |x - pos| <= band *
    scale (the region containing its zero crossing). Coarser ancestors
    of marked cells are NOT leaves; overlapping marks at different
    levels keep the finest (finer data wins, as in the reference's
    octree refinement).
    """
    pos = samples.pos.astype(np.float64)
    scale = samples.scale.astype(np.float64)
    aabb_min = (pos - 3.0 * scale[:, None]).min(axis=0)
    aabb_max = (pos + 3.0 * scale[:, None]).max(axis=0)
    center = (aabb_min + aabb_max) / 2.0
    root_size = float((aabb_max - aabb_min).max()) * 1.01

    # Level per sample: smallest level with node size <= scale, i.e.
    # node size in (scale/2, scale] — the reference's descend rule
    # (octree.cc find_node_descend: stop when node_size <= sample.scale).
    with np.errstate(divide="ignore"):
        lvl = np.ceil(np.log2(root_size / np.maximum(scale, 1e-30))).astype(int)
    lvl = np.clip(lvl, 0, max_level)

    origin = center - root_size / 2.0
    # All set algebra below runs on packed int64 codes (21 bits per
    # axis; max_level <= 20): np.unique on int codes is 20-50x faster
    # than np.unique(axis=0), which sorts void views (the r05 bench
    # spent ~22s of fssr wall-clock there at 128k samples).
    B = 21

    def pack(c):
        return (c[:, 2] << (2 * B)) | (c[:, 1] << B) | c[:, 0]

    def unpack(code):
        mask = (np.int64(1) << B) - 1
        return np.stack([code & mask, (code >> B) & mask,
                         (code >> (2 * B)) & mask], axis=1)

    cells = {}
    for level in np.unique(lvl):
        sel = lvl == level
        size = root_size / (2.0 ** level)
        n = 1 << level
        lo = np.floor((pos[sel] - band * scale[sel][:, None] - origin) / size).astype(np.int64)
        hi = np.floor((pos[sel] + band * scale[sel][:, None] - origin) / size).astype(np.int64)
        lo = np.clip(lo, 0, n - 1)
        hi = np.clip(hi, 0, n - 1)
        # Samples with the same cell range mark the same cells: expand
        # each distinct range once (a dense point set has many samples a
        # range; the marked set, and so the octree, is mve_tpu's).
        klo, khi = pack(lo), pack(hi)
        order = np.lexsort((khi, klo))
        first = np.ones(len(order), bool)
        first[1:] = (klo[order[1:]] != klo[order[:-1]]) | (khi[order[1:]] != khi[order[:-1]])
        lo, hi = lo[order[first]], hi[order[first]]
        # Expand each sample's cell range (ranges are tiny: band*scale ~
        # size), grouped by span so each group is one vectorized
        # broadcast instead of (span+1)^3 masked passes.
        codes = []
        span = (hi - lo).max(axis=1)
        for m in np.unique(span):
            sub = span == m
            slo, shi = lo[sub], hi[sub]
            rng = np.arange(m + 1)
            ox, oy, oz = np.meshgrid(rng, rng, rng, indexing="ij")
            offs = np.stack([ox.ravel(), oy.ravel(), oz.ravel()], axis=1)
            c = slo[:, None, :] + offs[None, :, :]          # (S, O, 3)
            ok = (c <= shi[:, None, :]).all(axis=2)
            flat = (c[:, :, 2] << (2 * B)) | (c[:, :, 1] << B) | c[:, :, 0]
            codes.append(flat[ok])
        cells[int(level)] = np.unique(np.concatenate(codes))

    # Tree construction via the split set: every proper ancestor of a
    # required cell splits; existing nodes are the root plus the 8
    # children of each split node; leaves are existing nodes that do not
    # themselves split. This tiles space exactly (no cracks, no overlap),
    # like the reference's pointer octree.
    split_by_level: dict = {}
    for level, cs in cells.items():
        anc = cs
        for coarser in range(level - 1, -1, -1):
            anc = np.unique(pack(unpack(anc) >> 1))
            split_by_level.setdefault(coarser, []).append(anc)
    split_codes = {l: np.unique(np.concatenate(v))
                   for l, v in split_by_level.items()}

    leaf_level_list = []
    leaf_coord_list = []
    if not split_codes:
        leaf_level_list.append(np.zeros(1, np.int32))
        leaf_coord_list.append(np.zeros((1, 3), np.int64))
    else:
        child_off_codes = pack(np.array(
            [[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0],
             [0, 0, 1], [1, 0, 1], [0, 1, 1], [1, 1, 1]], np.int64))
        for lvl_s in sorted(split_codes):
            sc = split_codes[lvl_s]
            child_level = lvl_s + 1
            children = (pack(unpack(sc) << 1)[:, None]
                        + child_off_codes[None, :]).reshape(-1)
            nxt = split_codes.get(child_level, np.zeros(0, np.int64))
            if len(nxt):
                j = np.clip(np.searchsorted(nxt, children), 0, len(nxt) - 1)
                is_split = nxt[j] == children
            else:
                is_split = np.zeros(len(children), bool)
            keep = children[~is_split]
            if len(keep):
                leaf_level_list.append(
                    np.full(len(keep), child_level, np.int32))
                leaf_coord_list.append(unpack(keep))

    leaf_level = np.concatenate(leaf_level_list)
    leaf_coord = np.concatenate(leaf_coord_list)
    return SampleOctree(center=center, root_size=root_size, max_level=max_level,
                        leaf_level=leaf_level, leaf_coord=leaf_coord)
