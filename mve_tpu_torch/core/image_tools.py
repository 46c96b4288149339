"""Image operations used by the feature stage (libs/mve/image_tools.h).

Public functions keep mve_tpu's (H, W, C) float32 layout; the `_planes`
helpers work on a stack of single-channel planes (..., H, W), which is
how the batched SIFT pyramid calls them. Behaviours match the reference:

- rescale_half_size: 2x2 box average, odd sizes keep the last row/col
  (image_tools.h:577-614).
- rescale_half_size_gaussian: 4x4 gaussian taps at even offsets
  (image_tools.h:619-...).
- blur_gaussian: separable convolution, kernel size ceil(sigma*2.884)*2+1,
  with edge-replicating borders.
- image_undistort_k2k4_batch: sfmrecon's undistortion of a stack of
  same-shape views (image_tools.h:106-139) by bilinear sampling.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def to_float(img):
    """uint8/uint16 -> [0,1] float32 (image_tools byte_to_float_image)."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    if img.dtype == np.uint16:
        return img.astype(np.float32) / 65535.0
    return img.astype(np.float32)


def to_byte(img):
    return np.clip(np.asarray(img) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def rescale_half_size(img: torch.Tensor) -> torch.Tensor:
    """2x2 average downsample of (H, W, C); odd dims replicate the last
    row/column (the reference's "hasnext" handling, image_tools.h:600-607)."""
    h, w = img.shape[0], img.shape[1]
    if h % 2:
        img = torch.cat([img, img[-1:]], dim=0)
    if w % 2:
        img = torch.cat([img, img[:, -1:]], dim=1)
    return 0.25 * (img[0::2, 0::2] + img[1::2, 0::2] + img[0::2, 1::2] + img[1::2, 1::2])


def _half_size_kernel(sigma: float) -> torch.Tensor:
    # Separable [a, b, b, a] stencil with a*a=w3, a*b=w2, b*b=w1: the 2D
    # stencil of the reference is its outer product.
    w1 = math.exp(-0.5 / (2.0 * sigma**2))
    w3 = math.exp(-4.5 / (2.0 * sigma**2))
    a = math.sqrt(w3)
    b = math.sqrt(w1)
    kern = torch.tensor([a, b, b, a], dtype=torch.float32)
    return kern / torch.sum(kern)


def half_size_gaussian_planes(x: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """Gaussian 4x4-tap half-size (image_tools.h:619) of planes (..., H, W).

    Output pixel (x,y) gathers input pixels at {2x-1, 2x, 2x+1, 2x+2} x
    {2y-1, 2y, 2y+1, 2y+2}, edge-replicated at the borders."""
    h, w = x.shape[-2], x.shape[-1]
    kern = _half_size_kernel(sigma).tolist()
    lead = x.shape[:-2]
    p = x.reshape(-1, 1, h, w)
    p = F.pad(p, (1, 2 + w % 2, 1, 2 + h % 2), mode="replicate")[:, 0]
    oh = (h + 1) // 2
    ow = (w + 1) // 2
    acc = torch.zeros((p.shape[0], oh, ow), dtype=x.dtype, device=x.device)
    for dy in range(4):
        rowsel = p[:, dy:dy + 2 * oh:2]
        inner = torch.zeros_like(acc)
        for dx in range(4):
            inner = inner + kern[dx] * rowsel[:, :, dx:dx + 2 * ow:2]
        acc = acc + kern[dy] * inner
    return acc.reshape(*lead, oh, ow)


def rescale_half_size_gaussian(img: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """(H, W, C) layout wrapper of half_size_gaussian_planes."""
    return half_size_gaussian_planes(img.permute(2, 0, 1), sigma).permute(1, 2, 0)


def gauss_kernel_1d(sigma: float) -> np.ndarray:
    ks = int(math.ceil(sigma * 2.884)) * 2 + 1  # image_tools blur_gaussian
    x = np.arange(ks) - ks // 2
    k = np.exp(-(x**2) / (2.0 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def blur_planes(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable gaussian blur of planes (..., H, W), rows then columns.

    The borders replicate the edge pixel (mve_tpu pads with mode="edge";
    its docstring's "reflect" does not describe the code). Float32 with
    cuDNN TF32 off (set in mve_tpu_torch/__init__.py)."""
    if sigma <= 0:
        return x
    k = torch.from_numpy(gauss_kernel_1d(sigma)).to(x.device)
    r = len(k) // 2
    h, w = x.shape[-2], x.shape[-1]
    lead = x.shape[:-2]
    p = x.reshape(-1, 1, h, w)
    p = F.pad(p, (0, 0, r, r), mode="replicate")
    p = F.conv2d(p, k.reshape(1, 1, -1, 1))
    p = F.pad(p, (r, r, 0, 0), mode="replicate")
    p = F.conv2d(p, k.reshape(1, 1, 1, -1))
    return p.reshape(*lead, h, w)


def blur_gaussian(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable gaussian blur of an (H, W, C) image (edge borders)."""
    if sigma <= 0:
        return img
    return blur_planes(img.permute(2, 0, 1), sigma).permute(1, 2, 0)


def bilinear_sample_batch(imgs: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                          fill: float = 0.0) -> torch.Tensor:
    """Sample each (H, W, C) image of imgs (B, H, W, C) at continuous
    pixel coordinates x, y (B, ...): pixel centres at integers (the
    caller applies the -0.5 shift); samples outside the image are `fill`
    (mve_tpu's bilinear_sample, per image)."""
    b, h, w = imgs.shape[0], imgs.shape[1], imgs.shape[2]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    bi = torch.arange(b, device=imgs.device).reshape((b,) + (1,) * (x.dim() - 1))

    def gather(yi, xi):
        return imgs[bi, torch.clamp(yi, 0, h - 1), torch.clamp(xi, 0, w - 1)]

    val = (gather(y0i, x0i) * (1 - fx) * (1 - fy)
           + gather(y0i, x0i + 1) * fx * (1 - fy)
           + gather(y0i + 1, x0i) * (1 - fx) * fy
           + gather(y0i + 1, x0i + 1) * fx * fy)
    inside = ((x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1))[..., None]
    return torch.where(inside, val, fill)


def image_undistort_k2k4_batch(imgs, flen, k2, k4, device="cuda") -> np.ndarray:
    """k2/k4 undistortion of a stack of same-shape views in one pass
    (sfmrecon.cc:403-444 loops over views; here the batch is the parallel
    axis). Output pixel p samples the input at p * rd(p) with
    rd(r) = 1 + k2 r^2 + k4 r^4, r in units of flen * max(W, H).

    imgs: (B, H, W, C) uint8 (sent as bytes, converted on the device);
    flen/k2/k4: (B,) per view. Returns (B, H, W, C) uint8 as numpy.
    """
    dev = torch.device(device)
    imgs = torch.from_numpy(np.ascontiguousarray(imgs)).to(dev)
    f = imgs.to(torch.float32) / 255.0

    def col(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=dev)[:, None, None]

    fl, a2, a4 = col(flen), col(k2), col(k4)
    h, w = imgs.shape[1], imgs.shape[2]
    fw, fh = float(w), float(h)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    cx = (xs + 0.5) - fw / 2.0
    cy = (ys + 0.5) - fh / 2.0
    norm = fl * max(fw, fh)
    r2 = (cx * cx + cy * cy) / (norm * norm)
    factor = 1.0 + a2 * r2 + a4 * r2 * r2
    out = bilinear_sample_batch(f, cx * factor + fw / 2.0 - 0.5, cy * factor + fh / 2.0 - 0.5)
    return torch.clamp(out * 255.0 + 0.5, 0, 255).to(torch.uint8).cpu().numpy()
