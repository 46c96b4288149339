"""Epipolar geometry for RANSAC: 8-point fundamental and Sampson distance
(reference: libs/sfm/fundamental.h/.cc; port of the parts of
mve_tpu/sfm/fundamental.py that the prebundle stage runs).

Batched over leading dimensions: the 8-point solve is one batched SVD
over (..., 8, 9) systems, the scoring one (..., N) Sampson evaluation.
"""

from __future__ import annotations

import torch


def _correspondence_matrix(p1, p2):
    """Rows of the DLT system for x2^T F x1 = 0.

    p1, p2: (..., N, 2). Returns (..., N, 9) with the reference's column
    order (fundamental.cc:52-64)."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    one = torch.ones_like(x1)
    return torch.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, one], dim=-1)


def fundamental_8_point(p1, p2):
    """Batched 8-point algorithm. p1, p2: (..., 8, 2) -> F (..., 3, 3).

    The solution is the right-singular vector of the smallest singular
    value (fundamental.cc:80-117): the last row of vt of the full SVD.
    Rank 2 is not enforced here (the reference's split as well).
    """
    A = _correspondence_matrix(p1, p2)
    _, _, vt = torch.linalg.svd(A, full_matrices=True)
    f = vt[..., -1, :]
    return f.reshape(f.shape[:-1] + (3, 3))


def sampson_distance(F, p1, p2):
    """Batched Sampson distance (fundamental.cc:225-247).

    F: (..., 3, 3); p1, p2: (..., N, 2), broadcast against F's batch.
    Returns (..., N). Written per component, so no (..., N, 3)
    intermediate is stored."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]

    def f(i, j):
        return F[..., i, j, None]

    fx0 = f(0, 0) * x1 + f(0, 1) * y1 + f(0, 2)
    fx1 = f(1, 0) * x1 + f(1, 1) * y1 + f(1, 2)
    fx2 = f(2, 0) * x1 + f(2, 1) * y1 + f(2, 2)
    ftx0 = f(0, 0) * x2 + f(1, 0) * y2 + f(2, 0)
    ftx1 = f(0, 1) * x2 + f(1, 1) * y2 + f(2, 1)
    num = (x2 * fx0 + y2 * fx1 + fx2) ** 2
    den = fx0**2 + fx1**2 + ftx0**2 + ftx1**2
    return num / torch.clamp(den, min=1e-30)
