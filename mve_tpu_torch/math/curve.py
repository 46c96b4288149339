"""Parametric curves (reference: libs/math/bezier_curve.h, bspline.h; a
copy of mve_tpu/math/curve.py, host numpy).

De Casteljau Bezier evaluation and uniform cubic B-spline evaluation,
batched over parameters.
"""

from __future__ import annotations

import numpy as np


def bezier(control_points, t):
    """Evaluate a Bezier curve of arbitrary degree at parameters t.

    control_points: (K, D); t: (...,) in [0, 1]. Returns (..., D).
    """
    cp = np.asarray(control_points, np.float64)
    t = np.asarray(t, np.float64)[..., None, None]  # (..., 1, 1)
    pts = np.broadcast_to(cp, t.shape[:-2] + cp.shape).copy()
    k = len(cp)
    for _ in range(k - 1):
        pts = pts[..., :-1, :] * (1.0 - t) + pts[..., 1:, :] * t
    return pts[..., 0, :]


def bspline_uniform_cubic(control_points, t):
    """Uniform cubic B-spline over K control points; t in [0, 1] spans the
    valid knot range. Returns (..., D)."""
    cp = np.asarray(control_points, np.float64)
    K = len(cp)
    if K < 4:
        raise ValueError("Need at least 4 control points")
    t = np.asarray(t, np.float64)
    nseg = K - 3
    u = np.clip(t, 0.0, 1.0) * nseg
    seg = np.minimum(u.astype(int), nseg - 1)
    x = u - seg
    b0 = (1 - x) ** 3 / 6.0
    b1 = (3 * x**3 - 6 * x**2 + 4) / 6.0
    b2 = (-3 * x**3 + 3 * x**2 + 3 * x + 1) / 6.0
    b3 = x**3 / 6.0
    return (b0[..., None] * cp[seg] + b1[..., None] * cp[seg + 1]
            + b2[..., None] * cp[seg + 2] + b3[..., None] * cp[seg + 3])
