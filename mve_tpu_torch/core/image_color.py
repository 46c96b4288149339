"""Colour space conversions (reference: libs/mve/image_color.h; port of
mve_tpu/core/image_color.py).

sRGB <-> linear, RGB <-> XYZ (D65), XYZ <-> Lab, RGB <-> YCbCr, the set
the reference provides, as torch functions over (..., 3) tensors in
[0, 1] on the tensors' own device and in their dtype. Each 3x3 product
is written out as three-term sums, one output channel at a time, and
each division by a constant divides by a tensor on the input's device
(PyTorch divides a CUDA tensor by a Python number as a multiplication by
its reciprocal, an ulp off the quotient). XYZ -> Lab runs in float64 and
rounds once: a* and b* are 500 and 200 times a difference of two cube
roots, which float32 would round an ulp apart (torch has no cbrt, and
XLA's float32 cbrt is itself an ulp off at about 1% of the inputs).
"""

from __future__ import annotations

import torch

# sRGB D65 primaries.
_RGB_TO_XYZ = ((0.4124564, 0.3575761, 0.1804375),
               (0.2126729, 0.7151522, 0.0721750),
               (0.0193339, 0.1191920, 0.9503041))
_XYZ_TO_RGB = ((3.2404542, -1.5371385, -0.4985314),
               (-0.9692660, 1.8760108, 0.0415560),
               (0.0556434, -0.2040259, 1.0572252))
_D65 = (0.95047, 1.0, 1.08883)


def _as(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _div(x, c):
    """x / c, correctly rounded on every device."""
    return x / x.new_tensor(c)


def _mat3(m, x):
    """m (3x3 of floats) times each (..., 3) vector of x."""
    x = _as(x)
    c = [x[..., j] for j in range(3)]
    return torch.stack([m[i][0] * c[0] + m[i][1] * c[1] + m[i][2] * c[2] for i in range(3)],
                       dim=-1)


def srgb_to_linear(c):
    c = _as(c)
    return torch.where(c <= 0.04045, _div(c, 12.92), _div(c + 0.055, 1.055) ** 2.4)


def linear_to_srgb(c):
    c = torch.clamp_min(_as(c), 0.0)
    return torch.where(c <= 0.0031308, c * 12.92, 1.055 * c ** (1 / 2.4) - 0.055)


def rgb_to_xyz(rgb):
    return _mat3(_RGB_TO_XYZ, rgb)


def xyz_to_rgb(xyz):
    return _mat3(_XYZ_TO_RGB, xyz)


def _lab_f(t):
    d = 6.0 / 29.0
    # The cube root where it is taken (t > d^3 > 0).
    return torch.where(t > d**3, torch.clamp_min(t, 0.0) ** (1.0 / 3.0),
                       _div(t, 3 * d * d) + 4.0 / 29.0)


def _lab_finv(t):
    d = 6.0 / 29.0
    return torch.where(t > d, t**3, 3 * d * d * (t - 4.0 / 29.0))


def xyz_to_lab(xyz):
    xyz = _as(xyz)
    fx, fy, fz = (_lab_f(_div(xyz[..., i].double(), _D65[i])) for i in range(3))
    L = 116.0 * fy - 16.0
    a = 500.0 * (fx - fy)
    b = 200.0 * (fy - fz)
    return torch.stack([L, a, b], dim=-1).to(xyz.dtype)


def lab_to_xyz(lab):
    lab = _as(lab)
    fy = _div(lab[..., 0] + 16.0, 116.0)
    fx = fy + _div(lab[..., 1], 500.0)
    fz = fy - _div(lab[..., 2], 200.0)
    return torch.stack([_lab_finv(f) * w for f, w in zip((fx, fy, fz), _D65)], dim=-1)


def rgb_to_ycbcr(rgb):
    rgb = _as(rgb)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 0.5 - 0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 0.5 + 0.5 * r - 0.418688 * g - 0.081312 * b
    return torch.stack([y, cb, cr], dim=-1)


def ycbcr_to_rgb(ycc):
    ycc = _as(ycc)
    y = ycc[..., 0]
    cb = ycc[..., 1] - 0.5
    cr = ycc[..., 2] - 0.5
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    return torch.stack([r, g, b], dim=-1)
