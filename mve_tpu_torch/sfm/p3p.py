"""Perspective-three-point pose, batched (reference: libs/sfm/pose_p3p.cc;
port of mve_tpu/sfm/p3p.py).

mve_tpu replaces the reference's Kneip closed form by Grunert's distance
formulation (Haralick et al., "Analysis and Solutions of the Three Point
Perspective Pose Estimation Problem"), whose resultant quartic it derived
symbolically: the same solution set, up to four (R, t) per sample, and a
shape that batches: one closed-form quartic solve (Ferrari, in real
arithmetic) and a batched 3x3 SVD for the absolute orientation. A whole
RANSAC batch of hypotheses solves in one pass of tensor ops.

Convention as in the reference: x_cam = R x_world + t (pose_p3p.h:41-45).
"""

from __future__ import annotations

import math

import torch

from .fundamental import det3


def _cbrt(x):
    """Real, sign-preserving cube root."""
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def cubic_roots_real(B, C, D):
    """All real roots of m^3 + B m^2 + C m + D = 0, batched, in real
    arithmetic.

    Returns (roots (..., 3), valid (..., 3)); slot 0 is always a real
    root and, in the three-real-root branch, the largest one.
    """
    B = B.to(torch.float32)  # as mve_tpu, which casts B to float32
    p = C - B * B / 3.0
    q = 2.0 * B**3 / 27.0 - B * C / 3.0 + D
    disc = q * q / 4.0 + p**3 / 27.0

    # disc >= 0: one real root via Cardano.
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    root_single = _cbrt(-q / 2.0 + sq) + _cbrt(-q / 2.0 - sq)

    # disc < 0: three real roots via the trigonometric form (p < 0 here).
    pm = torch.clamp(p, max=-1e-30)
    rr = torch.sqrt(-pm / 3.0)
    arg = torch.clamp(3.0 * q / (2.0 * pm) * torch.sqrt(-3.0 / pm), -1.0, 1.0)
    phi = torch.acos(arg)
    t0 = 2.0 * rr * torch.cos(phi / 3.0)                       # largest
    t1 = 2.0 * rr * torch.cos((phi - 2.0 * math.pi) / 3.0)
    t2 = 2.0 * rr * torch.cos((phi - 4.0 * math.pi) / 3.0)

    three = disc < 0.0
    shift = B / 3.0
    roots = torch.stack([torch.where(three, t0, root_single) - shift,
                         torch.where(three, t1, root_single) - shift,
                         torch.where(three, t2, root_single) - shift], dim=-1)
    valid = torch.stack([torch.ones_like(three), three, three], dim=-1)
    return roots, valid


def solve_quartic(b, c, d, e):
    """Real roots of x^4 + b x^3 + c x^2 + d x + e = 0 (Ferrari), batched.

    Returns (roots (..., 4), real_mask (..., 4)).
    """
    b = b.to(torch.float32)
    p = c - 3.0 * b * b / 8.0
    q = d - b * c / 2.0 + b**3 / 8.0
    r = e - b * d / 4.0 + b * b * c / 16.0 - 3.0 * b**4 / 256.0
    # The resolvent cubic m^3 + p m^2 + (p^2/4 - r) m - q^2/8 = 0 always
    # has a root m >= 0 (its value at 0 is -q^2/8 <= 0); slot 0 is the
    # largest.
    f32 = torch.float32
    mroots, _ = cubic_roots_real(p.to(f32), (p * p / 4.0 - r).to(f32),
                                 (-q * q / 8.0).to(f32))
    m = torch.clamp(mroots[..., 0], min=0.0)
    alpha = torch.sqrt(2.0 * m)
    biquad = alpha < 1e-10  # q ~ 0: the biquadratic case

    alpha_safe = torch.clamp(alpha, min=1e-10)
    gamma1 = (p + alpha * alpha - q / alpha_safe) / 2.0
    gamma2 = (p + alpha * alpha + q / alpha_safe) / 2.0
    disc1 = alpha * alpha - 4.0 * gamma1
    disc2 = alpha * alpha - 4.0 * gamma2
    s1 = torch.sqrt(torch.clamp(disc1, min=0.0))
    s2 = torch.sqrt(torch.clamp(disc2, min=0.0))
    yF = torch.stack([(-alpha + s1) / 2.0, (-alpha - s1) / 2.0,
                      (alpha + s2) / 2.0, (alpha - s2) / 2.0], dim=-1)
    realF = torch.stack([disc1 >= 0, disc1 >= 0, disc2 >= 0, disc2 >= 0], dim=-1)

    # Biquadratic y^4 + p y^2 + r = 0: y^2 = (-p +- sqrt(p^2-4r))/2.
    discB = p * p - 4.0 * r
    sB = torch.sqrt(torch.clamp(discB, min=0.0))
    u1 = torch.sqrt(torch.clamp((-p + sB) / 2.0, min=0.0))
    u2 = torch.sqrt(torch.clamp((-p - sB) / 2.0, min=0.0))
    ok1 = (discB >= 0) & ((-p + sB) / 2.0 >= 0)
    ok2 = (discB >= 0) & ((-p - sB) / 2.0 >= 0)
    yB = torch.stack([u1, -u1, u2, -u2], dim=-1)
    realB = torch.stack([ok1, ok1, ok2, ok2], dim=-1)

    y = torch.where(biquad[..., None], yB, yF)
    real = torch.where(biquad[..., None], realB, realF)
    return y - (b / 4.0)[..., None], real


def _kabsch(P, Y):
    """Rigid transform world -> camera from exact 3-point correspondences.

    P: (..., 3, 3) world points (rows), Y: (..., 3, 3) camera points.
    Returns (R, t) with Y ~= R P + t, batched.
    """
    Pc = torch.mean(P, dim=-2, keepdim=True)
    Yc = torch.mean(Y, dim=-2, keepdim=True)
    H = torch.einsum("...ni,...nj->...ij", P - Pc, Y - Yc)
    # An invalid P3P root has non-finite camera points. mve_tpu's SVD
    # returns NaN for it and torch.linalg.svd raises, so such blocks are
    # zeroed; their poses are masked out by the roots' validity anyway.
    H = torch.where(torch.isfinite(H), H, 0.0)
    u, _, vt = torch.linalg.svd(H)
    V = vt.transpose(-1, -2)
    d = det3(V @ u.transpose(-1, -2))
    D = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    R = (V * D[..., None, :]) @ u.transpose(-1, -2)
    t = Yc[..., 0, :] - torch.einsum("...ij,...j->...i", R, Pc[..., 0, :])
    return R, t


def pose_p3p(p_world, f_bearing):
    """Batched Grunert P3P.

    p_world: (..., 3, 3) three world points (rows).
    f_bearing: (..., 3, 3) corresponding unit bearing vectors (rows).
    Returns (Rs (..., 4, 3, 3), ts (..., 4, 3), valid (..., 4)).
    """
    P1, P2, P3 = p_world[..., 0, :], p_world[..., 1, :], p_world[..., 2, :]
    f1, f2, f3 = f_bearing[..., 0, :], f_bearing[..., 1, :], f_bearing[..., 2, :]

    # Triangle sides: a opposite P1 (=|P2-P3|), b opposite P2, c opposite P3.
    a = torch.linalg.vector_norm(P2 - P3, dim=-1)
    b = torch.linalg.vector_norm(P1 - P3, dim=-1)
    c = torch.linalg.vector_norm(P1 - P2, dim=-1)
    # Cosines of the viewing angles between bearings.
    ca = torch.sum(f2 * f3, dim=-1)  # alpha: between rays 2 and 3
    cb = torch.sum(f1 * f3, dim=-1)  # beta: between rays 1 and 3
    cg = torch.sum(f1 * f2, dim=-1)  # gamma: between rays 1 and 2

    b2 = torch.clamp(b * b, min=1e-20)
    A = (a * a) / b2
    C = (c * c) / b2

    # Quartic in v = s3/s1 from the resultant of Grunert's two quadratics.
    a4 = A**2 - 2 * A * C - 2 * A + C**2 - 4 * C * ca**2 + 2 * C + 1
    a3 = (-4 * A**2 * cb + 8 * A * C * cb + 4 * A * ca * cg + 4 * A * cb
          - 4 * C**2 * cb + 8 * C * ca**2 * cb + 4 * C * ca * cg - 4 * C * cb
          - 4 * ca * cg)
    a2 = (4 * A**2 * cb**2 + 2 * A**2 - 8 * A * C * cb**2 - 4 * A * C
          - 8 * A * ca * cb * cg - 4 * A * cg**2 + 4 * C**2 * cb**2 + 2 * C**2
          - 4 * C * ca**2 - 8 * C * ca * cb * cg + 4 * ca**2 + 4 * cg**2 - 2)
    a1 = (-4 * A**2 * cb + 8 * A * C * cb + 4 * A * ca * cg
          + 8 * A * cb * cg**2 - 4 * A * cb - 4 * C**2 * cb + 4 * C * ca * cg
          + 4 * C * cb - 4 * ca * cg)
    a0 = A**2 - 2 * A * C - 4 * A * cg**2 + 2 * A + C**2 - 2 * C + 1

    a4_safe = torch.where(torch.abs(a4) < 1e-12, 1e-12, a4)
    v, real_ok = solve_quartic(a3 / a4_safe, a2 / a4_safe, a1 / a4_safe, a0 / a4_safe)
    root_ok = real_ok & (v > 1e-6)

    # s1 from the beta equation: s1^2 (1 + v^2 - 2 v cb) = b^2.
    bb = b[..., None]
    cbb, cgb, cab = cb[..., None], cg[..., None], ca[..., None]
    Ab, Cb = A[..., None], C[..., None]
    denom1 = 1.0 + v * v - 2.0 * v * cbb
    s1 = bb / torch.sqrt(torch.clamp(denom1, min=1e-20))
    root_ok = root_ok & (denom1 > 1e-12)

    # u from the gamma equation: u^2 - 2 u cg + (1 - C (1+v^2-2v cb)) = 0.
    const = 1.0 - Cb * denom1
    sq = torch.sqrt(torch.clamp(cgb * cgb - const, min=0.0))
    u_cands = torch.stack([cgb + sq, cgb - sq], dim=-1)  # (..., 4, 2)
    # The root consistent with the alpha equation:
    # u^2 + v^2 - 2 u v ca - A (1 + v^2 - 2 v cb) = 0.
    resid = torch.abs(
        u_cands**2 + (v**2)[..., None] - 2 * u_cands * v[..., None] * cab[..., None]
        - Ab[..., None] * denom1[..., None])
    u = torch.where(resid[..., 0] <= resid[..., 1], u_cands[..., 0], u_cands[..., 1])
    root_ok = root_ok & (u > 1e-6)

    s2 = u * s1
    s3 = v * s1
    root_ok = root_ok & (s1 > 0) & (s2 > 0) & (s3 > 0)

    # Camera-frame points and absolute orientation per root.
    Y = torch.stack([s1[..., None] * f1[..., None, :],
                     s2[..., None] * f2[..., None, :],
                     s3[..., None] * f3[..., None, :]], dim=-2)  # (..., 4, 3, 3)
    Pmat = torch.stack([P1, P2, P3], dim=-2)[..., None, :, :].expand(Y.shape)
    R, t = _kabsch(Pmat, Y)
    return R, t, root_ok
