"""Rotation parameterisations: Rodrigues/axis-angle and quaternions
(reference: libs/math/matrix_tools.h, libs/math/quaternion.h and the
Rodrigues camera update of bundle adjustment, bundle_adjustment.cc:662-688;
port of mve_tpu/math/rotation.py).

Each function is written once on torch tensors and batched over leading
dimensions. A numpy input is computed as a float64 CPU tensor and handed
back as numpy, so host bookkeeping never touches a device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _numpy_in_numpy_out(fn):
    @functools.wraps(fn)
    def wrapper(x):
        if isinstance(x, torch.Tensor):
            return fn(x)
        return fn(torch.from_numpy(np.asarray(x, np.float64))).numpy()
    return wrapper


def _skew(x, y, z):
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


@_numpy_in_numpy_out
def rodrigues_to_matrix(r):
    """Axis-angle (Rodrigues) 3-vector -> 3x3 rotation matrix.

    R = I + sin(a)/a [r]_x + (1-cos(a))/a^2 [r]_x^2 with a = |r|. The
    series branch near 0 keeps the derivative at r = 0 exact, which bundle
    adjustment needs: it linearises around r = 0 at every LM step.

    Batched over leading dims: (..., 3) -> (..., 3, 3).
    """
    a2 = torch.sum(r * r, dim=-1, keepdim=True)[..., None]  # angle^2, (..., 1, 1)
    a = torch.sqrt(torch.clamp(a2, min=1e-32))
    small = a2 < 1e-12
    sinc = torch.where(small, 1.0 - a2 / 6.0, torch.sin(a) / a)
    cosc = torch.where(small, 0.5 - a2 / 24.0,
                       (1.0 - torch.cos(a)) / torch.clamp(a2, min=1e-32))
    K = _skew(r[..., 0], r[..., 1], r[..., 2])
    eye = torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)
    return eye + sinc * K + cosc * (K @ K)


@_numpy_in_numpy_out
def matrix_to_rodrigues(R):
    """3x3 rotation matrix -> axis-angle 3-vector. Batched (..., 3, 3).

    Through the quaternion (robust at every angle, including near pi):
    angle = 2 atan2(|v|, w), axis = v/|v| for q = (w, v)."""
    q = matrix_to_quat(R)
    w = torch.abs(q[..., 0])
    v = q[..., 1:] * torch.sign(q[..., :1] + 1e-300)  # w >= 0 hemisphere
    vn = torch.linalg.vector_norm(v, dim=-1)
    angle = 2.0 * torch.atan2(vn, w)
    small = vn < 1e-6
    scale = torch.where(small, 2.0 / torch.clamp(w, min=1e-32),
                        angle / torch.clamp(vn, min=1e-32))
    return v * scale[..., None]


@_numpy_in_numpy_out
def quat_to_matrix(q):
    """Unit quaternion (w, x, y, z) -> rotation matrix. Batched (..., 4)."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)


@_numpy_in_numpy_out
def matrix_to_quat(R):
    """Rotation matrix -> unit quaternion (w, x, y, z). Batched (..., 3, 3).

    Shepperd's construction: of four candidates, the one built on the
    largest component."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
                      1.0 - m00 - m11 + m22], dim=-1)
    qw = torch.sqrt(torch.clamp(qw, min=0.0)) * 0.5

    def d(k):
        return 4 * qw[..., k] + 1e-32

    c0 = torch.stack([qw[..., 0], (m21 - m12) / d(0), (m02 - m20) / d(0), (m10 - m01) / d(0)], dim=-1)
    c1 = torch.stack([(m21 - m12) / d(1), qw[..., 1], (m01 + m10) / d(1), (m02 + m20) / d(1)], dim=-1)
    c2 = torch.stack([(m02 - m20) / d(2), (m01 + m10) / d(2), qw[..., 2], (m12 + m21) / d(2)], dim=-1)
    c3 = torch.stack([(m10 - m01) / d(3), (m02 + m20) / d(3), (m12 + m21) / d(3), qw[..., 3]], dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)  # (..., 4, 4)
    best = torch.argmax(qw, dim=-1)
    q = torch.take_along_dim(cands, best[..., None, None], dim=-2)[..., 0, :]
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


@_numpy_in_numpy_out
def skew(v):
    """3-vector -> 3x3 skew-symmetric cross-product matrix. Batched."""
    return _skew(v[..., 0], v[..., 1], v[..., 2])
