"""Homography estimation (reference: libs/sfm/homography.cc; port of
mve_tpu/sfm/homography.py).

Batched DLT and symmetric transfer error for the RANSAC estimator and for
the initial pair's "explained by a homography?" test
(bundler_init_pair.cc:23).
"""

from __future__ import annotations

import torch


def homography_dlt(p1, p2):
    """Batched 4+ point DLT. p1, p2: (..., N, 2) -> H (..., 3, 3)."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    zero = torch.zeros_like(x1)
    one = torch.ones_like(x1)
    # Two rows per correspondence (standard DLT for x2 ~ H x1).
    rows_a = torch.stack([zero, zero, zero, -x1, -y1, -one, y2 * x1, y2 * y1, y2], dim=-1)
    rows_b = torch.stack([x1, y1, one, zero, zero, zero, -x2 * x1, -x2 * y1, -x2], dim=-1)
    A = torch.cat([rows_a, rows_b], dim=-2)
    _, _, vt = torch.linalg.svd(A, full_matrices=True)
    h = vt[..., -1, :]
    H = h.reshape(h.shape[:-1] + (3, 3))
    h22 = H[..., 2:3, 2:3]
    return H / torch.where(torch.abs(h22) < 1e-30, 1e-30, h22)


def symmetric_transfer_error(H, p1, p2):
    """0.5 * (|p2 - H p1|^2 + |p1 - H^-1 p2|^2) per correspondence
    (ransac_homography.cc evaluation). inv_ex: the inverse without the
    error check that would wait for the device."""
    Hinv, _ = torch.linalg.inv_ex(H)

    def transfer(H, p):
        x = torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)
        y = torch.einsum("...ij,...nj->...ni", H, x)
        z = y[..., 2:]
        return y[..., :2] / torch.where(torch.abs(z) < 1e-30, 1e-30, z)

    e12 = torch.sum((transfer(H, p1) - p2) ** 2, dim=-1)
    e21 = torch.sum((transfer(Hinv, p2) - p1) ** 2, dim=-1)
    return 0.5 * (e12 + e21)
