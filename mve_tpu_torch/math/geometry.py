"""Small geometric helpers (reference: libs/math/geometry.h, functions.h;
port of mve_tpu/math/geometry.py).

Torch functions batched over leading dims, on the tensors' own device.
Cross products are torch.linalg.cross's, which on the CPU rounds as
jnp.cross does on XLA's CPU (a fused multiply-add), the same bits on
every input tested: a thin triangle's cross product cancels, and written
out as two products and a difference it lands up to 1.4e-5 apart in a
ray's barycentrics.
"""

from __future__ import annotations

import torch


def _as(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1)


def triangle_normal(v0, v1, v2, normalize=True):
    """Normal of triangles (v1-v0) x (v2-v0). Batched (..., 3)."""
    v0 = _as(v0)
    n = _cross(_as(v1) - v0, _as(v2) - v0)
    if normalize:
        n = n / torch.clamp_min(_norm(n)[..., None], 1e-32)
    return n


def triangle_area(v0, v1, v2):
    """Area of triangles. Batched (..., 3) -> (...)."""
    v0 = _as(v0)
    return 0.5 * _norm(_cross(_as(v1) - v0, _as(v2) - v0))


def triangle_circumradius(v0, v1, v2):
    """Circumradius r = abc / (4A) (reference geometry.h circumsphere)."""
    v0, v1, v2 = _as(v0), _as(v1), _as(v2)
    a = _norm(v1 - v2)
    b = _norm(v0 - v2)
    c = _norm(v0 - v1)
    return a * b * c / torch.clamp_min(4.0 * triangle_area(v0, v1, v2), 1e-32)


def normalize(v, axis=-1, eps=1e-32):
    v = _as(v)
    return v / torch.clamp_min(torch.linalg.vector_norm(v, dim=axis, keepdim=True), eps)
