"""Implicit-function evaluation on a sparse voxel grid
(reference: libs/fssr/iso_octree.cc; port of mve_tpu/fssr/iso_octree.py).

The host builds the voxel set with vectorised grid hashing; the device
evaluates the implicit function at the voxels with the dense block
program of block_eval.py.

Reference semantics preserved: influence radius 3 x sample scale, the
per-voxel scale filter (drop samples with scale > 2 x the voxel's
10th-percentile influencing scale, iso_octree.cc:104-112), and the
VoxelData fields {value, conf, deriv, scale, color}.

mve_tpu's pair-list evaluator (behind MVE_TPU_FSSR_PAIRWISE=1, with
fssr/basis.py and the native fssr_influence_pairs) is not ported yet
(ROADMAP.md queue A item 22); with that variable set, evaluation raises.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from .. import resolve_device
from . import block_eval
from .sample import SampleList


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


def evaluate_at_positions(samples: SampleList, positions: np.ndarray,
                          device="cuda") -> dict:
    """Evaluate the FSSR implicit function at arbitrary positions.

    Returns dict of arrays value/conf/deriv/scale/color, each
    len(positions): iso_octree.cc sample_ifn, batched through the dense
    block program on `device`."""
    dev = resolve_device(device)
    if os.environ.get("MVE_TPU_FSSR_PAIRWISE") == "1":
        raise NotImplementedError(
            "MVE_TPU_FSSR_PAIRWISE=1 selects mve_tpu's pair-list evaluator, "
            "which mve_tpu_torch does not port yet (ROADMAP.md queue A item "
            "22); unset it to use the dense block evaluation")
    sums = block_eval.evaluate_positions_blocked(samples, positions, device=dev)
    return _normalize_sums(sums)


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
