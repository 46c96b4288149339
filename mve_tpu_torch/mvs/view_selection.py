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


def _parallax_deg(points, center_a, center_b):
    """Angle (deg) at each point between the two camera centers."""
    va = center_a - points
    vb = center_b - points
    va = va / np.maximum(np.linalg.norm(va, axis=-1, keepdims=True), 1e-30)
    vb = vb / np.maximum(np.linalg.norm(vb, axis=-1, keepdims=True), 1e-30)
    cos = np.clip(np.sum(va * vb, axis=-1), -1.0, 1.0)
    return np.rad2deg(np.arccos(cos))


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
    V = len(cameras)
    valid = np.array([c is not None and c.valid for c in cameras])
    valid[ref_view] = False
    centers = np.stack([
        c.camera_pos() if (c is not None and c.valid) else np.zeros(3)
        for c in cameras])

    shared = feature_vis & feature_vis[ref_view][None, :]  # (V, F)
    ref_fp = _footprint(feature_positions, cameras[ref_view], *sizes[ref_view])

    # Precompute per-candidate static scores (parallax-to-ref x resolution).
    static_scores = np.zeros((V, feature_positions.shape[0]), np.float64)
    for i in range(V):
        if not valid[i] or not shared[i].any():
            continue
        idx = np.nonzero(shared[i])[0]
        pts = feature_positions[idx]
        plx = _parallax_deg(pts, centers[ref_view], centers[i])
        score = np.where(plx < min_parallax, (plx / 10.0) ** 2, 1.0)
        fp = _footprint(pts, cameras[i], *sizes[i])
        ratio = ref_fp[idx] / np.maximum(fp, 1e-30)
        ratio = np.where(ratio > 2.0, 2.0 / ratio, np.minimum(ratio, 1.0))
        static_scores[i, idx] = score * ratio

    selected: List[int] = []
    available = valid.copy()
    # Diversity multiplier accumulated as views are selected.
    diversity = np.ones((V, feature_positions.shape[0]), np.float64)
    while len(selected) < max_views:
        benefits = np.where(
            available[:, None], static_scores * diversity, 0.0).sum(axis=1)
        best = int(np.argmax(benefits))
        if benefits[best] <= 0.0:
            break
        selected.append(best)
        available[best] = False
        # Update diversity: features seen by `best` get parallax weight
        # w.r.t. the new selection for every remaining candidate.
        idx = np.nonzero(feature_vis[best])[0]
        if len(idx) == 0:
            continue
        for i in np.nonzero(available)[0]:
            both = shared[i, idx]
            if not both.any():
                continue
            sub = idx[both]
            plx = _parallax_deg(feature_positions[sub], centers[best], centers[i])
            w = np.where(plx < min_parallax, (plx / 10.0) ** 2, 1.0)
            diversity[i, sub] *= w
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
