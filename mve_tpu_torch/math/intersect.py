"""Intersection predicates (reference: libs/math/octree_tools.h:47-93;
port of mve_tpu/math/intersect.py).

Ray/box, ray/triangle and point/box tests, as torch functions batched
over leading dims, on the tensors' own device (cross products as in
geometry.py).
"""

from __future__ import annotations

import torch

from .geometry import _cross


def _as(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def ray_box(origin, direction, box_min, box_max):
    """Slab-test ray/AABB intersection. Returns (hit, tmin, tmax).

    Batched over leading dims of origin/direction; box is (..., 3) or (3,).
    Matches behavior of octree_tools.h:52 ray_box_overlap.
    """
    origin, direction = _as(origin), _as(direction)
    tiny = torch.where(direction < 0, -1e-32, 1e-32)
    inv = 1.0 / torch.where(torch.abs(direction) < 1e-32, tiny, direction)
    t0 = (_as(box_min) - origin) * inv
    t1 = (_as(box_max) - origin) * inv
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    hit = tmax >= torch.clamp_min(tmin, 0.0)
    return hit, tmin, tmax


def _dot(a, b):
    """Three-term dot product along the last axis, ((x + y) + z)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def ray_triangle(origin, direction, v0, v1, v2, eps=1e-12):
    """Moeller-Trumbore ray/triangle test. Returns (hit, t, u, v).

    Matches behavior of octree_tools.h:63 ray_triangle_intersect.
    """
    origin, direction, v0 = _as(origin), _as(direction), _as(v0)
    e1 = _as(v1) - v0
    e2 = _as(v2) - v0
    p = _cross(direction, e2)
    det = _dot(e1, p)
    inv_det = 1.0 / torch.where(torch.abs(det) < eps, eps, det)
    tvec = origin - v0
    u = _dot(tvec, p) * inv_det
    q = _cross(tvec, e1)
    v = _dot(direction, q) * inv_det
    t = _dot(e2, q) * inv_det
    hit = (torch.abs(det) >= eps) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t >= 0)
    return hit, t, u, v


def point_in_box(p, box_min, box_max):
    """Inclusive point/AABB containment (octree_tools.h:92)."""
    p = _as(p)
    return torch.all((p >= _as(box_min)) & (p <= _as(box_max)), dim=-1)
