"""Epipolar geometry: 8-point/N-point and 7-point fundamental, the rank
constraints, essential decomposition, Sampson distance (reference:
libs/sfm/fundamental.h/.cc; port of mve_tpu/sfm/fundamental.py).

Batched over leading dimensions: the 8-point solve is one batched SVD
over (..., 8, 9) systems, the scoring one (..., N) Sampson evaluation.
Determinants of 3x3 blocks are closed-form (det3): torch.linalg.det goes
through an LU factorisation per block.
"""

from __future__ import annotations

import numpy as np
import torch


def det3(M):
    """Determinant of (..., 3, 3), closed form."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))


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


def fundamental_least_squares(p1, p2):
    """N-point least squares fundamental (fundamental.cc:43-77)."""
    return fundamental_8_point(p1, p2)


def fundamental_7_point(p1, p2):
    """Batched 7-point algorithm (fundamental.h 7-point).

    p1, p2: (..., 7, 2). The null space is spanned by F1, F2; the real
    roots of the cubic det(a F1 + (1-a) F2) = 0 give up to three F.
    Returns (Fs (..., 3, 3, 3), valid (..., 3)).
    """
    from .p3p import cubic_roots_real

    A = _correspondence_matrix(p1, p2)
    _, _, vt = torch.linalg.svd(A, full_matrices=True)
    f1 = vt[..., -1, :].reshape(vt.shape[:-2] + (3, 3))
    f2 = vt[..., -2, :].reshape(vt.shape[:-2] + (3, 3))

    # The cubic's coefficients from its values at a = 0, 1, 2, -1.
    def det_at(a):
        return det3(a * f1 + (1.0 - a) * f2)

    d0, d1, d2, dm = det_at(0.0), det_at(1.0), det_at(2.0), det_at(-1.0)
    c0 = d0
    c2 = (d1 + dm) / 2.0 - c0
    c3 = (d2 - 2.0 * d1 + c0 - 2.0 * c2) / 6.0
    c1 = d1 - c0 - c2 - c3
    c3_safe = torch.where(torch.abs(c3) < 1e-20, 1e-20, c3)
    a, valid = cubic_roots_real(c2 / c3_safe, c1 / c3_safe, c0 / c3_safe)
    Fs = (a[..., None, None] * f1[..., None, :, :]
          + (1.0 - a)[..., None, None] * f2[..., None, :, :])
    return Fs, valid


def enforce_fundamental_constraints(F):
    """Zero the smallest singular value (fundamental.cc:113-126)."""
    u, s, vt = torch.linalg.svd(F)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    return u @ (s[..., :, None] * vt)


def enforce_essential_constraints(E):
    """diag(s, s, 0) with s the mean of the two largest singular values
    (fundamental.cc:128-145)."""
    u, s, vt = torch.linalg.svd(E)
    avg = (s[..., 0] + s[..., 1]) * 0.5
    s = torch.stack([avg, avg, torch.zeros_like(avg)], dim=-1)
    return u @ (s[..., :, None] * vt)


def pose_from_essential(E):
    """Four (R, t) decompositions of E (fundamental.cc:147-193).

    Returns (Rs (..., 4, 3, 3), ts (..., 4, 3)); camera 1 is [I|0].
    """
    u, _, vt = torch.linalg.svd(E)
    # det(R) = +1 fixups.
    su = torch.where(det3(u) < 0, -1.0, 1.0)
    sv = torch.where(det3(vt) < 0, -1.0, 1.0)
    u = torch.cat([u[..., :, :2], u[..., :, 2:] * su[..., None, None]], dim=-1)
    vt = torch.cat([vt[..., :2, :], vt[..., 2:, :] * sv[..., None, None]], dim=-2)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    t = u[..., :, 2]
    Rs = torch.stack([R1, R1, R2, R2], dim=-3)
    ts = torch.stack([t, -t, t, -t], dim=-2)
    return Rs, ts


def fundamental_from_pose(pose1, pose2) -> np.ndarray:
    """F from two camera poses: F = [e2]x P2 P1^+ (fundamental.cc:196-223).
    Host numpy, as in mve_tpu."""
    P1 = pose1.fill_p_matrix()
    P2 = pose2.fill_p_matrix()
    c1 = np.concatenate([pose1.R.T @ -pose1.t, [1.0]])
    e2 = P2 @ c1
    ex = np.array([[0, -e2[2], e2[1]], [e2[2], 0, -e2[0]], [-e2[1], e2[0], 0]])
    return ex @ P2 @ np.linalg.pinv(P1)


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
