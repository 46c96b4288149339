"""SURF in PyTorch (reference behaviour: libs/sfm/surf.h/.cc; port of
mve_tpu/sfm/surf.py).

The reference pipeline: integral-image box-filter Hessian responses with
the 4x4 kernel-size table (surf.cc:28), strict 26-neighbour non-maximum
suppression on the two middle samples per octave, 3D quadratic
localisation with contrast filtering (surf.cc:337-476), Haar-wavelet
sliding-window orientation (surf.cc:517-625) and the 4x4x(dx,dy,|dx|,|dy|)
= 64-dim descriptor (surf.cc:667-736).

As in mve_tpu, every response map is strided indexing into the
summed-area table, candidates are fixed-size slot arrays per octave, and
the batch of same-shape views is an explicit leading dimension. Candidate
order follows jax.lax.top_k (stable sort, lower index first on ties) and
the slot cap after localisation is max(cap//4, 256).

The SAT is int32: exact for images up to ~8 MP of uint8 (the feature
stage caps images at 6 MP, bundler_features.cc:40-43).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..core import image_tools

# Kernel sizes per octave in 1/3 of full size (surf.cc:28).
KERNEL_SIZES = ((3, 5, 7, 9), (5, 9, 13, 17), (9, 17, 25, 33), (17, 33, 49, 65))


@dataclasses.dataclass(frozen=True)
class SurfOptions:
    """surf.h:48-60 defaults."""

    contrast_threshold: float = 500.0
    use_upright_descriptor: bool = False
    max_keypoints_per_octave: int = 4096


@dataclasses.dataclass
class SurfResult:
    x: np.ndarray
    y: np.ndarray
    scale: np.ndarray
    orientation: np.ndarray
    descriptors: np.ndarray  # (N, 64) float32, unit norm

    def __len__(self):
        return len(self.x)


# ---------------------------------------------------------------------------
# summed-area table + box filters
# ---------------------------------------------------------------------------

def _build_sat(gray_u8):
    """SAT of (B, H, W) uint8 with one row/col of zero padding, so
    sat[b, y, x] = sum over [0,y) x [0,x) (integral_image semantics)."""
    s = torch.cumsum(torch.cumsum(gray_u8.to(torch.int32), dim=1, dtype=torch.int32),
                     dim=2, dtype=torch.int32)
    return F.pad(s, (1, 0, 1, 0))


def _box(sat, y0, x0, h, w, rows, cols):
    """Box sums over offsets [y0, y0+h) x [x0, x0+w) relative to every
    octave grid point. rows/cols: grid pixel coordinates. Corner reads
    clamp to the SAT (mve_tpu edge-pads it); border entries are masked
    by the caller."""
    H1, W1 = sat.shape[-2] - 1, sat.shape[-1] - 1

    def corner(dy, dx):
        r = torch.clamp(rows + dy, 0, H1)
        c = torch.clamp(cols + dx, 0, W1)
        return sat.index_select(-2, r).index_select(-1, c)

    return corner(y0 + h, x0 + w) + corner(y0, x0) - corner(y0, x0 + w) - corner(y0 + h, x0)


def _response_map(sat, octave: int, sample: int, H: int, W: int):
    """Hessian determinant response map for one (octave, sample)
    (surf.cc:157-220 create_response_map + filter_dxx/dyy/dxy).
    sat: (B, H+1, W+1) -> (B, oh, ow) float32."""
    fs = KERNEL_SIZES[octave][sample]
    step = 2 ** octave
    fs2 = fs // 2
    weight = 0.912
    inv_karea = 1.0 / (fs * (2 * fs - 1))
    dev = sat.device
    rows = torch.arange(0, H, step, device=dev)
    cols = torch.arange(0, W, step, device=dev)

    def box(y0, x0, h, w):
        return _box(sat, y0, x0, h, w, rows, cols)

    # The reference's inclusive-SAT corner offsets shifted by +1 for this
    # exclusive SAT (surf.cc filter_dxx/dyy/dxy).
    dxx = (box(-fs + 1, -fs - fs2 + 0 * fs, 2 * fs - 1, fs)
           - 2 * box(-fs + 1, -fs - fs2 + 1 * fs, 2 * fs - 1, fs)
           + box(-fs + 1, -fs - fs2 + 2 * fs, 2 * fs - 1, fs))
    dyy = (box(-fs - fs2 + 0 * fs, -fs + 1, fs, 2 * fs - 1)
           - 2 * box(-fs - fs2 + 1 * fs, -fs + 1, fs, 2 * fs - 1)
           + box(-fs - fs2 + 2 * fs, -fs + 1, fs, 2 * fs - 1))
    dxy = (box(-fs, -fs, fs, fs)
           - box(-fs, 1, fs, fs)
           - box(1, -fs, fs, fs)
           + box(1, 1, fs, fs))

    dxx_t = dxx.to(torch.float32) * inv_karea
    dyy_t = dyy.to(torch.float32) * inv_karea
    dxy_t = dxy.to(torch.float32) * inv_karea
    resp = dxx_t * dyy_t - weight * dxy_t * dxy_t

    # Zero the border where the filter would read out of bounds
    # (surf.cc:193-199).
    border = fs + fs2 + 1
    ymask = (rows >= border) & (rows + border < H)
    xmask = (cols >= border) & (cols + border < W)
    return resp * ymask[:, None] * xmask[None, :]


def _nms_mask(resp):
    """Strict 26-neighbour maxima of samples 1..2. resp: (B, 4, Ho, Wo)."""
    B, L, H, W = resp.shape
    full = F.max_pool2d(resp.reshape(B * L, 1, H, W), 3, stride=1,
                        padding=1).reshape(B, L, H, W)
    center = resp[:, 1:3]
    padded = F.pad(center, (1, 1, 1, 1), value=-math.inf)
    same = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            nb = padded[..., 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
            same = nb if same is None else torch.maximum(same, nb)
    nb = torch.maximum(torch.maximum(full[:, 0:2], full[:, 2:4]), same)
    mask = center > nb
    mask[..., 0, :] = False
    mask[..., -1, :] = False
    mask[..., :, 0] = False
    mask[..., :, -1] = False
    return mask


# ---------------------------------------------------------------------------
# localisation (surf.cc:396-476)
# ---------------------------------------------------------------------------

def _localize(resp, ix, iy, isamp, valid, contrast_thr: float):
    """Batched quadratic localisation in one octave's (B, 4, Ho, Wo) stack."""
    B, L, Ho, Wo = resp.shape
    flat = resp.reshape(B, -1)

    def at(ds, dy, dx):
        idx = (((isamp + ds) * Ho + torch.clamp(iy + dy, 0, Ho - 1)) * Wo
               + torch.clamp(ix + dx, 0, Wo - 1))
        return torch.gather(flat, 1, idx)

    bx = -(at(0, 0, 1) - at(0, 0, -1)) * 0.5
    by = -(at(0, 1, 0) - at(0, -1, 0)) * 0.5
    bs = -(at(1, 0, 0) - at(-1, 0, 0)) * 0.5
    c = at(0, 0, 0)
    axx = at(0, 0, 1) + at(0, 0, -1) - 2 * c
    ayy = at(0, 1, 0) + at(0, -1, 0) - 2 * c
    ass = at(1, 0, 0) + at(-1, 0, 0) - 2 * c
    axy = (at(0, 1, 1) - at(0, 1, -1) - at(0, -1, 1) + at(0, -1, -1)) * 0.25
    axs = (at(1, 0, 1) - at(1, 0, -1) - at(-1, 0, 1) + at(-1, 0, -1)) * 0.25
    ays = (at(1, 1, 0) - at(1, -1, 0) - at(-1, 1, 0) + at(-1, -1, 0)) * 0.25

    det = (axx * (ayy * ass - ays * ays) - axy * (axy * ass - ays * axs)
           + axs * (axy * ays - ayy * axs))
    singular = torch.abs(det) < 1e-5
    det_safe = torch.where(singular, torch.ones_like(det), det)
    i00 = (ayy * ass - ays * ays) / det_safe
    i01 = (axs * ays - axy * ass) / det_safe
    i02 = (axy * ays - axs * ayy) / det_safe
    i11 = (axx * ass - axs * axs) / det_safe
    i12 = (axs * axy - axx * ays) / det_safe
    i22 = (axx * ayy - axy * axy) / det_safe
    fx = i00 * bx + i01 * by + i02 * bs
    fy = i01 * bx + i11 * by + i12 * bs
    fs_ = i02 * bx + i12 * by + i22 * bs

    value = c - 0.5 * (bx * fx + by * fy + bs * fs_)
    keep = (valid & ~singular
            & (torch.maximum(torch.maximum(torch.abs(fx), torch.abs(fy)),
                             torch.abs(fs_)) <= 0.5)
            & (value >= contrast_thr))
    return fx, fy, fs_, keep


# ---------------------------------------------------------------------------
# Haar responses + orientation + descriptor
# ---------------------------------------------------------------------------

def _haar(sat_flat, bidx, x, y, fs, H, W):
    """Haar dx/dy responses at integer (x, y) with half-size fs
    (surf.cc:628-664 filter_dx_dy; corner offsets shifted +1 for the
    exclusive SAT). sat_flat: (B*(H+1)*(W+1),); bidx, x, y, fs broadcast
    together."""
    def at(yy, xx):
        idx = (bidx * (H + 1) + torch.clamp(yy, 0, H)) * (W + 1) + torch.clamp(xx, 0, W)
        return sat_flat[idx].to(torch.float32)

    x1 = at(y - fs, x - fs)
    x2 = at(y - fs, x)
    x3 = at(y - fs, x + 1)
    x4 = at(y - fs, x + fs + 1)
    x5 = at(y + fs + 1, x - fs)
    x6 = at(y + fs + 1, x)
    x7 = at(y + fs + 1, x + 1)
    x8 = at(y + fs + 1, x + fs + 1)
    y1 = at(y, x - fs)
    y2 = at(y, x + fs + 1)
    y3 = at(y + 1, x - fs)
    y4 = at(y + 1, x + fs + 1)
    norm = ((2 * fs + 1) * fs * (fs + 1)).to(torch.float32)
    dx = ((x8 + x2 - x4 - x6) - (x7 + x1 - x3 - x5)) / norm
    dy = ((x8 + y1 - x5 - y2) - (y4 + x1 - y3 - x4)) / norm
    return dx, dy


def _circle_samples():
    """The 109 (rx, ry) offsets of the radius-6 circle (surf.cc:566-577)
    and the matching gaussian weights (sigma 2.5)."""
    offs = []
    for ry in range(-5, 6):
        for rx in range(-5, 6):
            if rx * rx + ry * ry < 36:
                offs.append((rx, ry))
    offs = np.array(offs, np.int64)
    w = np.exp(-(offs[:, 0] ** 2 + offs[:, 1] ** 2) / (2.0 * 2.5**2)).astype(np.float32)
    return offs, w


_CIRCLE_OFFS, _CIRCLE_W = _circle_samples()


def _orientations(sat, kx, ky, kscale, valid):
    """Sliding-window dominant orientation (surf.cc:517-625), batched over
    (B, K) keypoints."""
    B = sat.shape[0]
    H, W = sat.shape[1] - 1, sat.shape[2] - 1
    dev = sat.device
    ix = (kx + 0.5).to(torch.int64)
    iy = (ky + 0.5).to(torch.int64)
    iscale = kscale.to(torch.int64)
    spacing = 8 * iscale + 1
    inside = ((ix >= spacing) & (iy >= spacing)
              & (ix + spacing < W) & (iy + spacing < H))

    offs = torch.from_numpy(_CIRCLE_OFFS).to(dev)
    gw = torch.from_numpy(_CIRCLE_W).to(dev)
    s1 = torch.clamp(iscale, min=1)[..., None]
    xs = ix[..., None] + offs[:, 0] * s1                      # (B, K, 109)
    ys = iy[..., None] + offs[:, 1] * s1
    bidx = torch.arange(B, device=dev)[:, None, None]
    dx, dy = _haar(sat.reshape(-1), bidx, xs, ys, 2 * s1, H, W)
    dx = dx * gw
    dy = dy * gw
    ang = torch.atan2(dy, dx)
    # 16 windows of width pi/3 stepping pi/8.
    centers = -math.pi + torch.arange(16, device=dev) * (math.pi / 8.0)
    half = math.pi / 6.0
    diff = torch.abs(torch.remainder((ang[..., None, :] - centers[:, None]) + math.pi,
                                     2 * math.pi) - math.pi)   # (B, K, 16, 109)
    in_win = diff < half
    zero = torch.zeros((), dtype=dx.dtype, device=dev)
    sum_dx = torch.sum(torch.where(in_win, dx[..., None, :], zero), dim=-1)
    sum_dy = torch.sum(torch.where(in_win, dy[..., None, :], zero), dim=-1)
    length = sum_dx**2 + sum_dy**2
    best = torch.argmax(length, dim=-1, keepdim=True)
    ori = torch.atan2(torch.gather(sum_dy, -1, best), torch.gather(sum_dx, -1, best))[..., 0]
    return ori, valid & inside


def _descriptors(sat, kx, ky, kscale, kori, valid, upright: bool = False):
    """64-dim SURF descriptor (surf.cc:667-736), batched over (B, K)."""
    B, K = kx.shape
    H, W = sat.shape[1] - 1, sat.shape[2] - 1
    dev = sat.device
    iscale = torch.clamp(kscale.to(torch.int64), min=1)
    spacing = (15 * iscale + 1).to(torch.float32)
    inside = ((kx >= spacing) & (ky >= spacing)
              & (kx + spacing < W) & (ky + spacing <= H))

    grid = torch.arange(-10, 10, dtype=torch.float32, device=dev)
    GY, GX = torch.meshgrid(grid, grid, indexing="ij")  # (20, 20), 'xy' layout
    gauss = torch.exp(-(GX * GX + GY * GY) / (2.0 * 3.3) ** 2)

    if upright:
        sin_o = torch.zeros_like(kori)
        cos_o = torch.ones_like(kori)
    else:
        sin_o = torch.sin(kori)
        cos_o = torch.cos(kori)
    sin_o, cos_o = sin_o[..., None, None], cos_o[..., None, None]
    s1 = iscale[..., None, None]
    rx = torch.round(kx[..., None, None]
                     + (cos_o * (GX + 0.5) - sin_o * (GY + 0.5)) * s1).to(torch.int64)
    ry = torch.round(ky[..., None, None]
                     + (sin_o * (GX + 0.5) + cos_o * (GY + 0.5)) * s1).to(torch.int64)
    bidx = torch.arange(B, device=dev)[:, None, None, None]
    dx, dy = _haar(sat.reshape(-1), bidx, rx, ry, s1, H, W)    # (B, K, 20, 20)
    odx = cos_o * dx + sin_o * dy
    ody = -sin_o * dx + cos_o * dy
    wdx = gauss * odx
    wdy = gauss * ody
    feats = torch.stack([wdx, wdy, torch.abs(wdx), torch.abs(wdy)], dim=-1)
    # Sum each 5x5 cell: (B, K, cy, 5, cx, 5, 4) -> (B, K, cy, cx, 4).
    desc = feats.reshape(B, K, 4, 5, 4, 5, 4).sum(dim=(3, 5)).reshape(B, K, 64)
    nrm = torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
    ok = nrm[..., 0] > 1e-4
    return desc / torch.clamp(nrm, min=1e-12), valid & inside & ok


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _pow2(n: int, minimum: int = 256) -> int:
    size = minimum
    while size < n:
        size *= 2
    return size


def _octave_full(sat, octave: int, H: int, W: int, cap: int, contrast_thr: float):
    """One SURF octave for a batch of views: response maps -> NMS ->
    top-`cap` candidates -> localisation -> slot compaction.

    Returns (x, y, scale, keep), each (B, max(cap//4, 256)), strongest first."""
    B = sat.shape[0]
    step = 2 ** octave
    oh = (H + step - 1) // step
    ow = (W + step - 1) // step
    resp = torch.stack([_response_map(sat, octave, s, H, W) for s in range(4)], dim=1)
    mask = _nms_mask(resp)                                   # (B, 2, oh, ow)
    strength = torch.where(mask, resp[:, 1:3], torch.full_like(resp[:, 1:3], -math.inf))
    flat = strength.reshape(B, -1)
    k = min(cap, flat.shape[1])
    srt = torch.sort(flat, dim=1, descending=True, stable=True)
    vals, idx = srt.values[:, :k], srt.indices[:, :k]
    valid = vals > -math.inf
    si = idx // (oh * ow) + 1
    rem = idx % (oh * ow)
    iy = rem // ow
    ix = rem % ow
    ix = torch.where(valid, ix, torch.full_like(ix, 2))
    iy = torch.where(valid, iy, torch.full_like(iy, 2))
    isamp = torch.where(valid, si, torch.ones_like(si))
    fx, fy, fs_, keep = _localize(resp, ix, iy, isamp, valid, contrast_thr)
    sampling = float(step)
    x_img = (ix.to(torch.float32) + fx) * sampling
    y_img = (iy.to(torch.float32) + fy) * sampling
    samp_f = isamp.to(torch.float32) + fs_
    in_img = ((x_img >= 0) & (x_img + 1 <= W)
              & (y_img >= 0) & (y_img + 1 <= H))
    keep = keep & in_img & valid
    samp_round = torch.clamp(torch.round(samp_f), 0, 3).to(torch.int64)
    ksizes = torch.tensor(KERNEL_SIZES[octave], dtype=torch.float32,
                          device=sat.device)[samp_round]
    scales = 3.0 * ksizes * 1.2 / 9.0
    if k < cap:
        pad = cap - k
        x_img = F.pad(x_img, (0, pad))
        y_img = F.pad(y_img, (0, pad))
        scales = F.pad(scales, (0, pad), value=1.0)
        keep = F.pad(keep, (0, pad))
    # Keep cap//4 slots for the orientation/descriptor stages; the stable
    # sort keeps strongest-first, so any overflow drops the weakest.
    out_cap = max(cap // 4, 256)
    order = torch.sort((~keep).to(torch.uint8), dim=1, stable=True).indices[:, :out_cap]
    kv = torch.gather(keep, 1, order)
    kx = torch.where(kv, torch.gather(x_img, 1, order), torch.full_like(kv, W / 2.0, dtype=torch.float32))
    ky = torch.where(kv, torch.gather(y_img, 1, order), torch.full_like(kv, H / 2.0, dtype=torch.float32))
    ks = torch.where(kv, torch.gather(scales, 1, order), torch.ones_like(kv, dtype=torch.float32))
    return kx, ky, ks, kv


def _gray_u8(image) -> np.ndarray:
    """Grayscale in numpy (lightness mode; the reference feeds SURF byte
    images)."""
    img = np.asarray(image)
    if img.ndim == 3 and img.shape[2] >= 3:
        f = image_tools.to_float(img)
        gray = 0.5 * (np.maximum(np.maximum(f[:, :, 0], f[:, :, 1]), f[:, :, 2])
                      + np.minimum(np.minimum(f[:, :, 0], f[:, :, 1]), f[:, :, 2]))
        return (gray * 255.0 + 0.5).astype(np.uint8)
    if img.dtype == np.uint8:
        return img if img.ndim == 2 else img[:, :, 0]
    return (image_tools.to_float(img)[:, :, 0] * 255.0 + 0.5).astype(np.uint8)


_MAX_SURF_BATCH = 10  # views per batch (matches sift._MAX_FEATURE_BATCH)


def detect_and_describe_batch(images, options: SurfOptions = SurfOptions(),
                              device="cuda"):
    """SURF over a list of images, batched over same-shape views
    (_MAX_SURF_BATCH at a time). Returns one SurfResult per image."""
    dev = resolve_device(device)
    grays = [_gray_u8(im) for im in images]
    if len(set(g.shape for g in grays)) > 1:
        return [detect_and_describe_batch([g], options, dev)[0] for g in grays]
    out = []
    for i in range(0, len(grays), _MAX_SURF_BATCH):
        out.extend(_detect_batch(grays[i:i + _MAX_SURF_BATCH], options, dev))
    return out


def _detect_batch(grays, options: SurfOptions, dev):
    B = len(grays)
    H, W = grays[0].shape
    sat = _build_sat(torch.from_numpy(np.stack(grays)).to(dev))
    pending = []
    for octave in range(4):
        step = 2 ** octave
        oh, ow = (H + step - 1) // step, (W + step - 1) // step
        if oh < 8 or ow < 8:
            break
        cap = min(_pow2(options.max_keypoints_per_octave),
                  _pow2(max(256, 2 * oh * ow // 64)))
        kx, ky, ks, kv = _octave_full(sat, octave, H, W, cap, options.contrast_threshold)
        if options.use_upright_descriptor:
            ori, ov = torch.zeros_like(kx), kv
        else:
            ori, ov = _orientations(sat, kx, ky, ks, kv)
        desc, ok = _descriptors(sat, kx, ky, ks, ori, ov,
                                upright=options.use_upright_descriptor)
        pending.append((kx, ky, ks, ori, desc, ok))

    results = [dict(x=[], y=[], scale=[], ori=[], desc=[]) for _ in range(B)]
    for arrays in pending:
        kx, ky, ks, ori, desc, ok = (a.cpu().numpy() for a in arrays)
        for b in range(B):
            sel = ok[b]
            if not sel.any():
                continue
            results[b]["x"].append(kx[b][sel])
            results[b]["y"].append(ky[b][sel])
            results[b]["scale"].append(ks[b][sel])
            results[b]["ori"].append(ori[b][sel])
            results[b]["desc"].append(desc[b][sel])
    out = []
    for r in results:
        if not r["x"]:
            z = np.zeros(0, np.float32)
            out.append(SurfResult(z, z.copy(), z.copy(), z.copy(),
                                  np.zeros((0, 64), np.float32)))
            continue
        out.append(SurfResult(*(np.concatenate(r[k]).astype(np.float32)
                                for k in ("x", "y", "scale", "ori", "desc"))))
    return out


def detect_and_describe(image, options: SurfOptions = SurfOptions(),
                        device="cuda") -> SurfResult:
    """SURF on one image: the batched pipeline with a batch of one
    (Surf::process, surf.cc:49)."""
    return detect_and_describe_batch([image], options, device)[0]
