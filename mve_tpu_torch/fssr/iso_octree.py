"""Implicit-function evaluation on a sparse voxel grid
(reference: libs/fssr/iso_octree.cc; port of mve_tpu/fssr/iso_octree.py).

The host builds the voxel set with vectorised grid hashing; the device
evaluates the implicit function at the voxels with the dense block
program of block_eval.py, or, with MVE_TPU_FSSR_PAIRWISE=1, with
mve_tpu's pair-list evaluator: the (voxel, sample) influence pairs from
the native library (the Python grid hashing without it), then the scale
filter, the basis and the per-voxel sums of fssr/basis.py on the device.

Reference semantics preserved: influence radius 3 x sample scale, the
per-voxel scale filter (drop samples with scale > 2 x the voxel's
10th-percentile influencing scale, iso_octree.cc:104-112), and the
VoxelData fields {value, conf, deriv, scale, color}.

The stages are marked with utils.tracing.trace_stage spans of mve_tpu's
names: fssr.voxel_set, fssr.block_eval, fssr.influence_pairs and
fssr.device_eval.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from .. import native as _native
from .. import resolve_device
from ..utils.tracing import trace_stage
from . import basis, block_eval
from .sample import SampleList

# The pair-list path's last run: pair count, which list (native or
# python), host milliseconds of the pairing and of the device evaluation
# (ending in the read back).
STATS: dict = {}


@dataclasses.dataclass
class VoxelGrid:
    origin: np.ndarray      # (3,) world position of voxel (0,0,0)
    cell_size: float
    dims: np.ndarray        # (3,) number of voxels per axis (corners)
    voxel_codes: np.ndarray # (V,) sorted linear codes of evaluated voxels
    value: np.ndarray       # (V,)
    conf: np.ndarray        # (V,)
    deriv: np.ndarray       # (V, 3)
    scale: np.ndarray       # (V,)
    color: np.ndarray       # (V, 3)
    active_cells: np.ndarray  # (C, 3) integer cell coords with all 8 corners

    def voxel_position(self, codes):
        iz = codes // (self.dims[0] * self.dims[1])
        rem = codes % (self.dims[0] * self.dims[1])
        iy = rem // self.dims[0]
        ix = rem % self.dims[0]
        return self.origin[None, :] + np.stack([ix, iy, iz], axis=-1) * self.cell_size


def _shape_bucket(n: int, minimum: int = 4096) -> int:
    """Next power of two >= n (mve_tpu's padded shapes: kept so the pair
    arrays and their fixed-size chunks are the same in both packages)."""
    size = minimum
    while size < n:
        size *= 2
    return size


def evaluate_at_positions(samples: SampleList, positions: np.ndarray,
                          device="cuda") -> dict:
    """Evaluate the FSSR implicit function at arbitrary positions.

    Returns dict of arrays value/conf/deriv/scale/color, each
    len(positions): iso_octree.cc sample_ifn, batched on `device` through
    the dense block program, or through the influence pairs with
    MVE_TPU_FSSR_PAIRWISE=1."""
    dev = resolve_device(device)
    if os.environ.get("MVE_TPU_FSSR_PAIRWISE") != "1":
        with trace_stage("fssr.block_eval"):
            sums = block_eval.evaluate_positions_blocked(samples, positions, device=dev)
        return _normalize_sums(sums)

    pos = samples.pos.astype(np.float64)
    scale = samples.scale.astype(np.float64)
    positions = np.asarray(positions, np.float64)
    STATS.clear()
    t0 = time.perf_counter()
    with trace_stage("fssr.influence_pairs"):
        # Both packages prefer the native list; it comes in another order
        # than the Python one, which moves only the rounding of the sums.
        native_pairs = _native.fssr_influence_pairs(positions, pos, scale)
        if native_pairs is not None:
            pair_v, pair_s = native_pairs
        else:
            pair_v, pair_s = IsoOctree._influence_pairs(
                positions, pos, scale, float(np.median(scale)))
    STATS.update(pairs=len(pair_v), source="native" if native_pairs is not None else "python",
                 pairs_ms=1e3 * (time.perf_counter() - t0))
    t0 = time.perf_counter()
    with trace_stage("fssr.device_eval"):
        sums = _evaluate_pairs(samples, positions, pair_v, pair_s, dev)
    STATS["device_ms"] = 1e3 * (time.perf_counter() - t0)
    return _normalize_sums(sums)


def _evaluate_pairs(samples: SampleList, positions, pair_v, pair_s, dev) -> np.ndarray:
    """(V, 10) float64 sums over the influence pairs: the scale filter by
    an on-device sort, then fixed-size chunks of pairs evaluated and summed
    per voxel, added across chunks in float32 (mve_tpu's
    iso_octree.py:101-131)."""
    CHUNK = 4_194_304  # fixed evaluation chunk: bounded device memory
    V, N = len(positions), len(samples.pos)
    Vb, Nb = _shape_bucket(V), _shape_bucket(N)
    Pb = _shape_bucket(len(pair_v), minimum=CHUNK)

    def rows(arr, n, fill=0.0):
        return torch.from_numpy(_pad_rows(np.asarray(arr, np.float32), n, fill)).to(dev)

    d_positions = rows(positions, Vb)
    d_pos = rows(samples.pos, Nb)
    d_normal = rows(samples.normal, Nb, fill=(0.0, 0.0, 1.0))
    d_scale = rows(samples.scale, Nb, fill=1.0)
    d_conf = rows(samples.confidence, Nb)
    d_color = rows(samples.color, Nb)
    # Padding pairs point at the padded voxel row Vb, whose sums are dropped.
    pv = np.full(Pb, Vb, np.int64)
    pv[:len(pair_v)] = pair_v
    ps = np.zeros(Pb, np.int64)
    ps[:len(pair_s)] = pair_s
    s_pv, s_ps, keep = basis.scale_filter_pairs(
        d_scale, torch.from_numpy(pv).to(dev), torch.from_numpy(ps).to(dev), Vb)
    sums = None
    for start in range(0, Pb, CHUNK):
        sl = slice(start, start + CHUNK)
        out = basis.evaluate_pairs_masked(d_positions, d_pos, d_normal, d_scale, d_conf,
                                          d_color, s_pv[sl], s_ps[sl], keep[sl])
        sums = out if sums is None else sums + out
    return sums.cpu().numpy().astype(np.float64)[:V]


def _pad_rows(arr: np.ndarray, n: int, fill=0.0) -> np.ndarray:
    """Pad axis 0 of arr to length n with a constant row."""
    if arr.shape[0] >= n:
        return arr
    pad = np.empty((n - arr.shape[0],) + arr.shape[1:], arr.dtype)
    pad[...] = fill
    return np.concatenate([arr, pad])


def _normalize_sums(sums: np.ndarray) -> dict:
    """Accumulator sums (V, 10) -> VoxelData fields.

    F = sum(f w c)/sum(w c); the derivative keeps the dominant quotient
    term (exact at the zero crossing, iso_octree.cc:121-169)."""
    value = sums[:, 0]
    conf = sums[:, 1]
    cw_total = sums[:, 2]
    sw_total = sums[:, 3]
    deriv = sums[:, 4:7]
    col = sums[:, 7:10]
    w_safe = np.where(conf > 0, conf, 1.0)
    cw_safe = np.where(cw_total > 0, cw_total, 1.0)
    return {
        "value": np.where(conf > 0, value / w_safe, 0.0),
        "conf": conf,
        "deriv": deriv / w_safe[:, None],
        "scale": sw_total / cw_safe,
        "color": col / cw_safe[:, None],
    }


def grid_geometry(aabb_min, aabb_max, h: float, max_grid_dim: int):
    """Uniform-grid origin/cell/dims for an influence-dilated AABB.

    h is nominally the median sample scale (the octree level most
    samples insert at, octree.cc:153-230); it grows if the grid would
    exceed max_grid_dim per axis."""
    dims_f = (aabb_max - aabb_min) / h + 2
    if dims_f.max() > max_grid_dim:
        h = float((aabb_max - aabb_min).max() / (max_grid_dim - 2))
        dims_f = (aabb_max - aabb_min) / h + 2
    origin = aabb_min - h
    dims = np.ceil(dims_f).astype(np.int64) + 2
    return origin, h, dims


def mark_active_cells(pos, scale, origin, h, dims) -> np.ndarray:
    """Unique linear codes of near-surface cells: the (2r+1)^3
    neighborhood around each sample's cell, expanded directly in
    linear-code space (one int64 per cell instead of a coordinate
    triple — the expansion is allocation-bound on this host). Center
    cells are clamped so the whole neighborhood stays in bounds; border
    samples thus mark a shifted (never out-of-range) neighborhood.
    Streaming accumulates the union of per-chunk results."""
    cell = np.floor((pos - origin) / h).astype(np.int64)
    r_cells = np.minimum(np.ceil(np.maximum(scale, h) / h).astype(np.int64), 3)
    code_parts = []
    for r in np.unique(r_cells):
        sub = cell[r_cells == r]
        sub = np.clip(sub, r, (dims - 3 - r)[None, :])
        sub_code = (sub[:, 2] * dims[1] + sub[:, 1]) * dims[0] + sub[:, 0]
        rng = np.arange(-r, r + 1)
        ox, oy, oz = np.meshgrid(rng, rng, rng, indexing="ij")
        offs_code = (oz.reshape(-1) * dims[1] + oy.reshape(-1)) * dims[0] \
            + ox.reshape(-1)
        code_parts.append((sub_code[:, None] + offs_code[None, :]).reshape(-1))
    # Unique via linear codes (np.unique(axis=0) sorts a void view —
    # an order of magnitude slower).
    return np.unique(np.concatenate(code_parts))


def voxels_from_cells(uniq_cell_codes, dims):
    """(voxel_codes, cells (C, 3) int) from active cell codes: voxels are
    the unique corners of the active cells; positions come from
    voxel_positions."""
    stride_y = dims[0]
    stride_z = dims[0] * dims[1]
    cz = uniq_cell_codes // stride_z
    crem = uniq_cell_codes % stride_z
    cells = np.stack([crem % dims[0], crem // dims[0], cz], axis=1)
    corner_offs_code = np.array(
        [0, 1, stride_y, stride_y + 1,
         stride_z, stride_z + 1, stride_z + stride_y,
         stride_z + stride_y + 1], np.int64)
    corner_codes = (uniq_cell_codes[:, None]
                    + corner_offs_code[None, :]).reshape(-1)
    voxel_codes = np.unique(corner_codes)
    return voxel_codes, cells


def voxel_positions(voxel_codes, origin, h, dims) -> np.ndarray:
    stride_y = dims[0]
    stride_z = dims[0] * dims[1]
    vx = voxel_codes % stride_y
    vy = (voxel_codes % stride_z) // stride_y
    vz = voxel_codes // stride_z
    return origin[None, :] + np.stack([vx, vy, vz], axis=-1) * h


class IsoOctree:
    """Voxel evaluation engine (mirrors fssr::IsoOctree's compute_voxels)."""

    def __init__(self, cell_size: float | None = None,
                 max_grid_dim: int = 1024, device="cuda"):
        self.cell_size = cell_size
        self.max_grid_dim = max_grid_dim
        self.device = device

    def compute_voxels(self, samples: SampleList) -> VoxelGrid:
        if len(samples) == 0:
            raise ValueError("No samples given")
        with trace_stage("fssr.voxel_set"):
            grid_args = self._build_voxel_set(samples)
        data = evaluate_at_positions(samples, grid_args[-1], device=self.device)
        origin, h, dims, voxel_codes, cells, _ = grid_args
        return VoxelGrid(
            origin=origin, cell_size=h, dims=dims, voxel_codes=voxel_codes,
            value=data["value"], conf=data["conf"], deriv=data["deriv"],
            scale=data["scale"], color=data["color"], active_cells=cells,
        )

    def _build_voxel_set(self, samples: SampleList):
        pos = samples.pos.astype(np.float64)
        scale = samples.scale.astype(np.float64)

        # --- grid resolution: the octree level most samples insert at
        # corresponds to a cell of about the median sample scale.
        h = self.cell_size or float(np.median(scale))
        aabb_min = (pos - 3.0 * scale[:, None]).min(axis=0)
        aabb_max = (pos + 3.0 * scale[:, None]).max(axis=0)
        origin, h, dims = grid_geometry(aabb_min, aabb_max, h,
                                        self.max_grid_dim)
        uniq = mark_active_cells(pos, scale, origin, h, dims)
        voxel_codes, cells = voxels_from_cells(uniq, dims)
        voxel_pos = voxel_positions(voxel_codes, origin, h, dims)
        return origin, h, dims, voxel_codes, cells, voxel_pos

    # ------------------------------------------------------------------
    @staticmethod
    def _influence_pairs(voxel_pos, pos, scale, h):
        """All (voxel, sample) pairs with |v - p| < 3 * scale: the Python
        grid hashing that stands in for the native fssr_influence_pairs
        (mve_tpu's, copied; the same pairs in another order)."""
        pair_v_list, pair_s_list = [], []
        levels = np.clip(np.floor(np.log2(np.maximum(scale / h, 1e-3))).astype(int), -20, 30)
        for lv in np.unique(levels):
            sel = np.nonzero(levels == lv)[0]
            max_r = 3.0 * scale[sel].max()
            cell = max_r  # hash cell equals max influence radius
            s_cell = np.floor(pos[sel] / cell).astype(np.int64)
            v_cell = np.floor(voxel_pos / cell).astype(np.int64)
            # linear codes with offset to avoid negatives
            off = np.minimum(s_cell.min(axis=0), v_cell.min(axis=0)) - 1
            span = np.maximum(s_cell.max(axis=0), v_cell.max(axis=0)) - off + 2

            def code(c):
                c = c - off
                return (c[:, 2] * span[1] + c[:, 1]) * span[0] + c[:, 0]
            s_codes = code(s_cell)
            order = np.argsort(s_codes, kind="stable")
            s_codes_sorted = s_codes[order]
            sel_sorted = sel[order]
            for dz in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    for dx in (-1, 0, 1):
                        q = v_cell + np.array([dx, dy, dz])
                        q_codes = code(q)
                        lo = np.searchsorted(s_codes_sorted, q_codes, "left")
                        hi = np.searchsorted(s_codes_sorted, q_codes, "right")
                        counts = hi - lo
                        nz = np.nonzero(counts)[0]
                        if len(nz) == 0:
                            continue
                        reps = counts[nz]
                        v_ids = np.repeat(nz, reps)
                        starts = lo[nz]
                        # Vectorised range expansion: index k within its
                        # group plus the group's start.
                        total = int(reps.sum())
                        group_start = np.repeat(starts, reps)
                        group_base = np.repeat(np.cumsum(reps) - reps, reps)
                        idx = group_start + (np.arange(total) - group_base)
                        s_ids = sel_sorted[idx]
                        d = voxel_pos[v_ids] - pos[s_ids]
                        ok = np.sum(d * d, axis=1) < (3.0 * scale[s_ids]) ** 2
                        pair_v_list.append(v_ids[ok])
                        pair_s_list.append(s_ids[ok])
        if not pair_v_list:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        return np.concatenate(pair_v_list), np.concatenate(pair_s_list)

