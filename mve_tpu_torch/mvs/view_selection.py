"""Global neighbor-view selection (reference:
libs/dmrecon/global_view_selection.cc:34-104) and per-pixel local view
selection (local_view_selection.cc performVS).

Global selection is host work on the sparse features, in numpy as in
mve_tpu: greedy max-benefit selection of up to global_vs_max views. Benefit
of a candidate = sum over features shared with the reference view of
   parallax-weight(ref) x resolution-ratio-weight x
   prod over already-selected views seeing the feature of parallax-weight,
with parallax weight (plx/10)^2 below min_parallax degrees and
resolution weight ratio = footprint_ref/footprint_cand clamped per the
reference.

Local selection runs on the device over every pixel at once: a greedy
k-step loop where each step argmaxes the weight map, then multiplies in
pairwise parallax and epipolar-plane-diversity factors against the
just-selected view.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np
import torch

from .patch import _fma


# Vectors are kept as three arrays of components. numpy sums a last axis
# of three (np.sum, np.linalg.norm) as (x + y) + z; the sums below keep
# that order, so each value is mve_tpu's bit for bit.

def _unit(x, y, z):
    """(x, y, z) over its length (at least 1e-30)."""
    n = np.maximum(np.sqrt((x * x + y * y) + z * z), 1e-30)
    return x / n, y / n, z / n


def _cos(a, b):
    """Cosine of each pair of unit vectors, clipped to [-1, 1]."""
    return np.clip((a[0] * b[0] + a[1] * b[1]) + a[2] * b[2], -1.0, 1.0)


def _min_parallax_weight(cos, min_parallax):
    """(plx/10)^2 below min_parallax degrees, 1 above."""
    plx = np.rad2deg(np.arccos(cos))
    return np.where(plx < min_parallax, (plx / 10.0) ** 2, 1.0)


def _footprint(points, camera, width, height):
    """World-space size of one pixel at each point (depthmap.h
    pixel_footprint): z-depth / focal-in-pixels."""
    K = camera.calibration(width, height)
    R, t = camera.rot, camera.trans
    z = (points @ R.T + t)[:, 2]
    return np.abs(z) / K[0, 0]


def global_view_selection(
    feature_positions: np.ndarray,      # (F, 3) bundle feature positions
    feature_vis: np.ndarray,            # (V, F) bool visibility per view
    cameras: Sequence,                  # CameraInfo per view
    sizes: Sequence,                    # (width, height) per view
    ref_view: int,
    max_views: int = 20,
    min_parallax: float = 10.0,
) -> List[int]:
    """The views mve_tpu's dense (V, F) loops select, in the same order.

    Only the reference's features score, so the work runs over the pairs
    (candidate, feature) that the two share, grouped by candidate: each
    score and weight is mve_tpu's, element by element, and a selection
    step updates every candidate in one pass.
    """
    V, F = feature_vis.shape
    valid = np.array([c is not None and c.valid for c in cameras])
    valid[ref_view] = False
    centers = np.stack([
        c.camera_pos() if (c is not None and c.valid) else np.zeros(3)
        for c in cameras])

    cols = np.nonzero(feature_vis[ref_view])[0]
    pts = feature_positions[cols]
    ref_fp = _footprint(feature_positions, cameras[ref_view], *sizes[ref_view])[cols]
    pair_view, pair_col = np.nonzero(feature_vis[:, cols] & valid[:, None])
    cands = np.unique(pair_view)
    starts = np.searchsorted(pair_view, np.arange(V + 1))
    unit = _unit(*(centers[pair_view] - pts[pair_col]).T)

    # Static score of each pair: parallax to the reference x resolution.
    ref_unit = _unit(*(centers[ref_view] - pts).T)
    score = _min_parallax_weight(_cos([c[pair_col] for c in ref_unit], unit), min_parallax)
    fp = np.empty(len(pair_view))
    for v in cands:
        rows = slice(starts[v], starts[v + 1])
        fp[rows] = _footprint(pts[pair_col[rows]], cameras[v], *sizes[v])
    ratio = ref_fp[pair_col] / np.maximum(fp, 1e-30)
    ratio = np.where(ratio > 2.0, 2.0 / ratio, np.minimum(ratio, 1.0))
    static = score * ratio

    # reduceat sums a candidate's pairs in another order than mve_tpu's
    # dense row sum; the two differ by at most `slack` of the largest
    # benefit, so only candidates that close to it are summed densely.
    slack = 8 * max(len(cols), 1) * np.finfo(np.float64).eps
    # Below this cosine the parallax is min_parallax or more, with room
    # for float32 arccos and rad2deg rounding: the weight is exactly 1.
    at_least_min = np.cos(np.deg2rad(min(min_parallax, 180.0))) - 1e-5
    selected: List[int] = []
    available = valid.copy()
    diversity = np.ones(len(pair_view))
    best_unit = [np.zeros(len(cols), u.dtype) for u in unit]
    seen = np.zeros(len(cols), bool)
    benefits = np.zeros(V)
    while len(selected) < max_views:
        gain = static * diversity
        if len(cands):
            benefits[cands] = np.add.reduceat(gain, starts[cands])
        benefits[~available] = 0.0
        top = benefits.max()
        if top <= 0.0:
            break
        near = np.nonzero(benefits >= top - slack * top)[0]
        best = int(near[0])
        if len(near) > 1:
            dense = np.zeros((len(near), F))
            for j, v in enumerate(near):
                rows = slice(starts[v], starts[v + 1])
                dense[j, cols[pair_col[rows]]] = gain[rows]
            best = int(near[np.argmax(dense.sum(axis=1))])
        selected.append(best)
        available[best] = False
        # Features seen by `best` get the parallax weight w.r.t. it for
        # every candidate; a selected candidate's diversity is not read
        # again.
        rows = slice(starts[best], starts[best + 1])
        seen[:] = False
        seen[pair_col[rows]] = True
        for b, u in zip(best_unit, unit):
            b[pair_col[rows]] = u[rows]
        cos = _cos([b[pair_col] for b in best_unit], unit)
        close = np.nonzero((cos > at_least_min) & seen[pair_col])[0]
        diversity[close] *= _min_parallax_weight(cos[close], min_parallax)
    return selected


# ---------------------------------------------------------------------------
# small vector helpers on (..., 3) tensors, rounded as XLA's CPU code
# rounds mve_tpu's (patch._fma)
# ---------------------------------------------------------------------------

def _dot3(a, b):
    """sum(a * b, -1) over 3 components: a0 b0, then two fused steps."""
    return _fma(a[..., 2], b[..., 2], _fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def _cross3(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([_fma(a1, b2, -(a2 * b1)), _fma(a2, b0, -(a0 * b2)),
                        _fma(a0, b1, -(a1 * b0))], dim=-1)


def _normalize3(a, eps):
    return a / torch.clamp(torch.sqrt(_dot3(a, a)), min=eps)[..., None]


def _degrees(x):
    return x * (180.0 / math.pi)


def _parallax_weight(cos_ang):
    """parallaxToWeight (mvs_tools.h:56-69): Gaussian peaked at 20 deg,
    sigma 5 below / 15 above."""
    plx = _degrees(torch.arccos(torch.clamp(cos_ang, -1.0, 1.0)))
    sigma = torch.where(plx <= 20.0, 5.0, 15.0)
    return torch.exp(-((plx - 20.0) ** 2) / (2.0 * sigma * sigma))


def _take0(a, idx):
    """a[idx[h, w], h, w, ...] for a: (J, H, W, ...), idx: (H, W) int64."""
    index = idx.reshape((1,) + idx.shape + (1,) * (a.dim() - 3))
    return torch.gather(a, 0, index.expand((1,) + a.shape[1:]))[0]


def local_view_selection(ncc, depth, ray_world, ref_pos, cam_pos,
                         k: int = 4, min_ncc: float = 0.3,
                         min_parallax: float = 10.0):
    """Select k diverse views per pixel.

    ncc: (J, H, W) photoconsistency of each global neighbor at the current
      depth; depth: (H, W) ray lengths; ray_world: (H, W, 3) unit viewing
      rays in world coords; ref_pos: (3,) reference camera center;
      cam_pos: (J, 3) neighbor camera centers.
    Returns (sel (k, H, W) int64 view indices, valid (k, H, W) bool).
    Score = NCC x parallax-to-ref weight x prod over already-selected
    views of [pairwise parallax weight x epipolar-plane angle factor]
    (local_view_selection.cc:96-133).
    """
    p = ref_pos + ray_world * depth[..., None]          # (H, W, 3)
    ref_dir = ray_world                                  # unit, p - ref_pos
    vd = _normalize3(p[None] - cam_pos[:, None, None, :], 1e-12)   # (J, H, W, 3)
    ep = _normalize3(_cross3(vd, ref_dir[None]), 1e-12)  # epipolar normals

    w = ncc * _parallax_weight(_dot3(vd, ref_dir[None]))
    w = torch.where(ncc < min_ncc, 0.0, w)
    return _greedy_select(w, vd, ep, k, min_parallax)


def _greedy_select(w, vd, ep, k, min_parallax):
    """The k greedy steps shared by both local selections."""
    J = w.shape[0]
    jj = torch.arange(J, device=w.device)[:, None, None]
    sels, valids = [], []
    for _ in range(k):
        idx = torch.argmax(w, dim=0)                     # (H, W)
        best = _take0(w, idx)
        sels.append(idx)
        valids.append(best > 0.0)
        d_sel = _take0(vd, idx)
        e_sel = _take0(ep, idx)
        w = torch.where(jj == idx[None], 0.0, w)
        w = w * _parallax_weight(_dot3(vd, d_sel[None]))
        # Epipolar-plane angle folded into [0, 90]; linear penalty below
        # min_parallax degrees (floor 1 deg).
        dp = torch.abs(_dot3(ep, e_sel[None]))
        ang = _degrees(torch.arccos(torch.clamp(dp, -1.0, 1.0)))
        ang = torch.clamp(ang, min=1.0)
        w = w * torch.where(ang < min_parallax, ang / min_parallax, 1.0)
    return torch.stack(sels), torch.stack(valids)
