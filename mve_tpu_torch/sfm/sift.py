"""SIFT in PyTorch (reference behaviour: libs/sfm/sift.h/.cc; port of
mve_tpu/sfm/sift.py).

The reference's algorithm: octaves min..max with S samples (S+3
gaussians, S+2 DoGs per octave, sift.h:183-190), 26-neighbour extrema,
iterative 3D quadratic localisation with contrast/edge filtering
(sift.cc:340-489), 36-bin orientation histograms (sift.cc:599-700) and
4x4x8 trilinear descriptors with 0.2 clamping (sift.cc:702-845).

Shape of the computation, as in mve_tpu: every stage is a dense tensor
program over a batch of same-shape views (the batch dimension is written
out where mve_tpu used vmap), candidate sets are fixed-size slot arrays
per octave, and the host only reads the final keep masks.

Tie order matters wherever a sort decides which candidates survive:
jax.lax.top_k puts the lower index first among equal values and
jnp.argsort is stable, so every such sort here is torch.sort(stable=True)
followed by a slice. The slot caps are mve_tpu's: cap//2 keypoints after
localisation (_compact_keypoints).

With min_octave < 0 (the upsampled first octave) mve_tpu takes its
per-image path, and so does the port (_detect_per_image): the octave -1
image is image_tools.rescale_double_size of the input at twice the
inherent blur, the keep masks are read back on the host between the
stages, and each octave keeps every localised keypoint (no cap//2
compaction).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..core import image_tools


@dataclasses.dataclass(frozen=True)
class SiftOptions:
    """Defaults match the reference (sift.h:48-109)."""

    num_samples_per_octave: int = 3
    min_octave: int = 0
    max_octave: int = 4
    contrast_threshold: float = -1.0  # <0 => 0.02 / samples
    edge_ratio_threshold: float = 10.0
    base_blur_sigma: float = 1.6
    inherent_blur_sigma: float = 0.5
    # Slot budgets of the batched pipeline (not in the reference):
    max_keypoints_per_octave: int = 4096
    max_orientations_per_keypoint: int = 3

    @property
    def eff_contrast_threshold(self) -> float:
        if self.contrast_threshold >= 0:
            return self.contrast_threshold
        return 0.02 / self.num_samples_per_octave


@dataclasses.dataclass
class SiftResult:
    """Final descriptors; coordinates are in input-image pixels
    (sift.cc:543-546 scale_factor mapping)."""

    x: np.ndarray  # (N,)
    y: np.ndarray  # (N,)
    scale: np.ndarray  # (N,) absolute scale
    orientation: np.ndarray  # (N,)
    descriptors: np.ndarray  # (N, 128) float32, unit norm

    def __len__(self):
        return len(self.x)


def _stable_order(key: torch.Tensor, descending: bool = False) -> torch.Tensor:
    """Indices that sort `key` along the last axis, equal keys in index
    order (jnp.argsort / lax.top_k tie order)."""
    return torch.sort(key, dim=-1, descending=descending, stable=True).indices


# ---------------------------------------------------------------------------
# octave construction (sift.cc:170-263)
# ---------------------------------------------------------------------------

def _build_octave(img, num_samples: int, base_sigma: float, has_sigma: float):
    """One octave per view: S+3 gaussians and S+2 DoGs.

    img: (B, H, W) float32 at octave resolution with blur `has_sigma`.
    Returns gauss (B, S+3, H, W), dogs (B, S+2, H, W).
    """
    if base_sigma > has_sigma:
        base = image_tools.blur_planes(img, math.sqrt(base_sigma**2 - has_sigma**2))
    else:
        base = img
    imgs = [base]
    k = 2.0 ** (1.0 / num_samples)
    sigma = base_sigma
    for _ in range(num_samples + 2):
        sigmak = sigma * k
        imgs.append(image_tools.blur_planes(imgs[-1], math.sqrt(sigmak**2 - sigma**2)))
        sigma = sigmak
    gauss = torch.stack(imgs, dim=1)
    return gauss, gauss[:, 1:] - gauss[:, :-1]


# ---------------------------------------------------------------------------
# extrema detection (sift.cc:264-336)
# ---------------------------------------------------------------------------

def _pool3x3_excl_center(x, largest: bool):
    """Max (min) over the 8 spatial neighbours, centre excluded, with
    +-inf outside the image. x: (..., H, W)."""
    fill = -math.inf if largest else math.inf
    H, W = x.shape[-2], x.shape[-1]
    padded = F.pad(x, (1, 1, 1, 1), value=fill)
    out = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            nb = padded[..., 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
            if out is None:
                out = nb
            else:
                out = torch.maximum(out, nb) if largest else torch.minimum(out, nb)
    return out


def _extrema_mask(dogs):
    """Strict 26-neighbour extrema of the middle DoGs.

    dogs: (B, S+2, H, W). Returns a bool mask (B, S, H, W) for samples
    0..S-1 — an extremum of the 3x3x3 neighbourhood centred at dogs[s+1].
    A tie with any neighbour rejects (the reference's >=)."""
    B, L, H, W = dogs.shape
    flat = dogs.reshape(B * L, 1, H, W)
    mx = F.max_pool2d(flat, 3, stride=1, padding=1).reshape(B, L, H, W)
    mn = (-F.max_pool2d(-flat, 3, stride=1, padding=1)).reshape(B, L, H, W)
    center = dogs[:, 1:-1]
    nb_max = torch.maximum(torch.maximum(mx[:, :-2], mx[:, 2:]),
                           _pool3x3_excl_center(center, True))
    nb_min = torch.minimum(torch.minimum(mn[:, :-2], mn[:, 2:]),
                           _pool3x3_excl_center(center, False))
    mask = (center > nb_max) | (center < nb_min)
    # The reference iterates y, x in [1, dim-2].
    mask[..., 0, :] = False
    mask[..., -1, :] = False
    mask[..., :, 0] = False
    mask[..., :, -1] = False
    return mask


# ---------------------------------------------------------------------------
# keypoint localisation (sift.cc:340-489)
# ---------------------------------------------------------------------------

def _localize_keypoints(dogs, ix, iy, isamp, valid, contrast_thr: float,
                        edge_thr: float, num_samples: int):
    """Batched 3D quadratic localisation with up-to-5-step re-centring.

    dogs: (B, S+2, H, W); ix/iy/isamp: (B, N) int64; valid: (B, N) bool.
    Returns (x, y, sample, keep) with the reference's rejection rules.
    """
    B, L, H, W = dogs.shape
    flat = dogs.reshape(B, L * H * W)

    def derivs(ix, iy):
        def at(ds, dy, dx):
            idx = (((isamp + 1 + ds) * H + torch.clamp(iy + dy, 0, H - 1)) * W
                   + torch.clamp(ix + dx, 0, W - 1))
            return torch.gather(flat, 1, idx)

        Dx = (at(0, 0, 1) - at(0, 0, -1)) * 0.5
        Dy = (at(0, 1, 0) - at(0, -1, 0)) * 0.5
        Ds = (at(1, 0, 0) - at(-1, 0, 0)) * 0.5
        c = at(0, 0, 0)
        Dxx = at(0, 0, 1) + at(0, 0, -1) - 2 * c
        Dyy = at(0, 1, 0) + at(0, -1, 0) - 2 * c
        Dss = at(1, 0, 0) + at(-1, 0, 0) - 2 * c
        Dxy = (at(0, 1, 1) + at(0, -1, -1) - at(0, 1, -1) - at(0, -1, 1)) * 0.25
        Dxs = (at(1, 0, 1) + at(-1, 0, -1) - at(1, 0, -1) - at(-1, 0, 1)) * 0.25
        Dys = (at(1, 1, 0) + at(-1, -1, 0) - at(1, -1, 0) - at(-1, 1, 0)) * 0.25
        return Dx, Dy, Ds, Dxx, Dyy, Dss, Dxy, Dxs, Dys, c

    def solve(Dx, Dy, Ds, Dxx, Dyy, Dss, Dxy, Dxs, Dys):
        """Solve A [fx fy fs]^T = -[Dx Dy Ds]^T by the 3x3 adjugate."""
        a, b, c_ = Dxx, Dxy, Dxs
        d, e, f = Dxy, Dyy, Dys
        g, h, i = Dxs, Dys, Dss
        det = a * (e * i - f * h) - b * (d * i - f * g) + c_ * (d * h - e * g)
        singular = torch.abs(det) < 1e-15
        det_safe = torch.where(singular, torch.ones_like(det), det)
        A = (e * i - f * h) / det_safe
        Bq = (c_ * h - b * i) / det_safe
        C = (b * f - c_ * e) / det_safe
        D = (f * g - d * i) / det_safe
        E = (a * i - c_ * g) / det_safe
        Fq = (c_ * d - a * f) / det_safe
        G = (d * h - e * g) / det_safe
        Hh = (b * g - a * h) / det_safe
        I = (a * e - b * d) / det_safe
        zero = torch.zeros_like(det)
        fx = torch.where(singular, zero, -(A * Dx + Bq * Dy + C * Ds))
        fy = torch.where(singular, zero, -(D * Dx + E * Dy + Fq * Ds))
        fs = torch.where(singular, zero, -(G * Dx + Hh * Dy + I * Ds))
        return fx, fy, fs, singular

    done = torch.zeros_like(valid)
    singular = torch.zeros_like(valid)
    fx = fy = fs = torch.zeros(ix.shape, dtype=dogs.dtype, device=dogs.device)
    for _ in range(5):
        fx, fy, fs, singular = solve(*derivs(ix, iy)[:9])
        dx = (((fx > 0.6) & (ix < W - 2)).long()
              - ((fx < -0.6) & (ix > 1)).long())
        dy = (((fy > 0.6) & (iy < H - 2)).long()
              - ((fy < -0.6) & (iy > 1)).long())
        move = (dx != 0) | (dy != 0)
        step = move & ~done & ~singular
        ix = torch.where(step, ix + dx, ix)
        iy = torch.where(step, iy + dy, iy)
        done = done | ~move | singular
    # Final derivatives at the settled pixel for the value/edge tests.
    Dx, Dy, Ds, Dxx, Dyy, Dss, Dxy, Dxs, Dys, center = derivs(ix, iy)
    val = center + 0.5 * (Dx * fx + Dy * fy + Ds * fs)
    tr = Dxx + Dyy
    det2 = Dxx * Dyy - Dxy * Dxy
    score = tr * tr / torch.where(torch.abs(det2) < 1e-30,
                                  torch.full_like(det2, 1e-30), det2)
    score_thr = (edge_thr + 1.0) ** 2 / edge_thr

    x = ix.to(torch.float32) + fx
    y = iy.to(torch.float32) + fy
    s = isamp.to(torch.float32) + fs
    keep = (
        valid
        & ~singular
        & (torch.abs(val) >= contrast_thr)
        & (score >= 0.0)
        & (score <= score_thr)
        & (torch.abs(fx) <= 1.5)
        & (torch.abs(fy) <= 1.5)
        & (torch.abs(fs) <= 1.0)
        & (s >= -1.0)
        & (s <= float(num_samples))
        & (x >= 0.0)
        & (x <= float(W - 1))
        & (y >= 0.0)
        & (y <= float(H - 1))
    )
    return x, y, s, keep


# ---------------------------------------------------------------------------
# gradient/orientation images (sift.cc:557-597)
# ---------------------------------------------------------------------------

def _grad_ori(gauss):
    """Gradient magnitude and orientation in [0, 2pi). gauss: (..., H, W)."""
    dx = torch.zeros_like(gauss)
    dy = torch.zeros_like(gauss)
    dx[..., :, 1:-1] = 0.5 * (gauss[..., :, 2:] - gauss[..., :, :-2])
    dy[..., 1:-1, :] = 0.5 * (gauss[..., 2:, :] - gauss[..., :-2, :])
    mag = torch.sqrt(dx * dx + dy * dy)
    ori = torch.atan2(dy, dx)
    ori = torch.where(ori < 0, ori + 2 * math.pi, ori)
    return mag, ori


def _window_index(level, iy, ix, R: int, Hp: int, Wp: int):
    """Flat indices of the (2R+1)^2 window whose top-left corner is
    (iy, ix) in planes edge-padded by R (so the window is centred on the
    unpadded pixel (iy, ix)). level/iy/ix: (n,) int64 -> (n, (2R+1)^2)."""
    off = torch.arange(2 * R + 1, device=ix.device)
    rows = (level * Hp + iy)[:, None] + off[None, :]          # (n, 2R+1)
    return (rows[:, :, None] * Wp + (ix[:, None, None] + off[None, None, :])
            ).reshape(len(ix), -1)


def _offsets(R: int, device):
    """Tap offsets (DX, DY), each ((2R+1)^2,), row-major like meshgrid 'xy'."""
    d = torch.arange(-R, R + 1, dtype=torch.float32, device=device)
    DY, DX = torch.meshgrid(d, d, indexing="ij")
    return DX.reshape(-1), DY.reshape(-1)


# Keypoints per gather chunk in the orientation and descriptor stages:
# bounds the (chunk, window) temporaries to a few hundred MB.
_KP_CHUNK = 512


# ---------------------------------------------------------------------------
# orientation assignment (sift.cc:599-700)
# ---------------------------------------------------------------------------

_ORI_WIN = 20  # max window radius: sigma<=4.04 => win = int(sigma*4.5) <= 18


def _assign_orientations(grad, ori, x, y, samp, valid,
                         num_samples: int, base_sigma: float, max_ori: int):
    """36-bin weighted histogram -> up to max_ori interpolated peaks.

    grad/ori: (B, S+3, H, W); x/y/samp/valid: (B, N) refined keypoints
    (octave coords). Returns (orientations (B, N, max_ori),
    ori_valid (B, N, max_ori)).
    """
    B, L, H, W = grad.shape
    N = x.shape[1]
    nbins = 36
    R = _ORI_WIN
    dev = grad.device

    ix = (x + 0.5).to(torch.int64)
    iy = (y + 0.5).to(torch.int64)
    isamp = torch.round(samp).to(torch.int64)
    sigma = base_sigma * torch.exp2((samp + 1.0) / num_samples)
    win = (sigma * 1.5 * 3.0).to(torch.int64)
    inside = (ix >= win) & (ix + win < W) & (iy >= win) & (iy + win < H)

    # Edge-pad once so every window is in range. Out-of-image taps read
    # edge values but are masked by in_win, and keypoints whose window
    # leaves the image are rejected by `inside`.
    Hp, Wp = H + 2 * R, W + 2 * R
    grad_pad = F.pad(grad.reshape(B * L, 1, H, W), (R, R, R, R), mode="replicate").reshape(-1)
    ori_pad = F.pad(ori.reshape(B * L, 1, H, W), (R, R, R, R), mode="replicate").reshape(-1)
    DX, DY = _offsets(R, dev)

    level = (torch.clamp(isamp + 1, 0, L - 1)
             + torch.arange(B, device=dev)[:, None] * L).reshape(-1)
    fx, fy = ix.reshape(-1), iy.reshape(-1)
    xs, ys = x.reshape(-1), y.reshape(-1)
    sig, wn = sigma.reshape(-1), win.reshape(-1)
    hist = torch.zeros((B * N, nbins), dtype=torch.float32, device=dev)
    # Only occupied slots get a histogram; the others are masked below.
    slots = torch.nonzero(valid.reshape(-1)).squeeze(1)
    for c0 in range(0, len(slots), _KP_CHUNK):
        c = slots[c0:c0 + _KP_CHUNK]
        idx = _window_index(level[c], fy[c], fx[c], R, Hp, Wp)
        gm = grad_pad[idx]
        go = ori_pad[idx]
        dxf = (xs[c] - fx[c])[:, None]
        dyf = (ys[c] - fy[c])[:, None]
        dist = (DX - dxf) ** 2 + (DY - dyf) ** 2
        w1 = wn[c][:, None]
        maxdist = w1.to(torch.float32) ** 2 + 0.5
        in_win = (dist <= maxdist) & (torch.abs(DX) <= w1) & (torch.abs(DY) <= w1)
        sig_w = sig[c][:, None] * 1.5
        weight = torch.exp(-dist / (2.0 * sig_w * sig_w))
        contrib = torch.where(in_win, gm * weight, torch.zeros_like(gm))
        bin_idx = torch.clamp((nbins * go / (2 * math.pi)).to(torch.int64), 0, nbins - 1)
        hist[c] = torch.zeros_like(contrib[:, :nbins]).scatter_add_(1, bin_idx, contrib)
    hist = hist.reshape(B, N, nbins)

    # Circular box smoothing x6 (sift.cc:663-675).
    for _ in range(6):
        hist = (torch.roll(hist, 1, dims=-1) + hist + torch.roll(hist, -1, dims=-1)) / 3.0

    maxh = torch.max(hist, dim=-1, keepdim=True).values
    h0 = torch.roll(hist, 1, dims=-1)
    h2 = torch.roll(hist, -1, dims=-1)
    is_peak = (hist > 0.8 * maxh) & (hist > h0) & (hist > h2)
    denom = h0 - 2.0 * hist + h2
    frac = -0.5 * (h2 - h0) / torch.where(torch.abs(denom) < 1e-30,
                                          torch.full_like(denom, 1e-30), denom)
    bin_centers = torch.arange(nbins, dtype=torch.float32, device=dev)
    peak_ori = 2.0 * math.pi * (frac + bin_centers + 0.5) / nbins

    # Up to max_ori peaks, strongest first.
    peak_score = torch.where(is_peak, hist, torch.full_like(hist, -math.inf))
    top_idx = _stable_order(-peak_score)[..., :max_ori]
    top_valid = (torch.gather(is_peak, -1, top_idx)
                 & valid[..., None] & inside[..., None])
    top_ori = torch.gather(peak_ori, -1, top_idx)
    return top_ori, top_valid


# ---------------------------------------------------------------------------
# descriptor extraction (sift.cc:702-845)
# ---------------------------------------------------------------------------

_DESC_WIN = 44  # max: sqrt(2)*3*sigma*(4+1)/2 with sigma<=4.04 => <=43


def _compute_descriptors(grad, ori, x, y, samp, orientation, valid,
                         num_samples: int, base_sigma: float):
    """4x4 spatial x 8 orientation trilinear descriptor, batched.

    grad/ori: (B, S+3, H, W); keypoint arrays (B, N).
    Returns (desc (B, N, 128), keep (B, N)).
    """
    B, L, H, W = grad.shape
    N = x.shape[1]
    PXB, OHB = 4, 8
    R = _DESC_WIN
    dev = grad.device

    Hp, Wp = H + 2 * R, W + 2 * R
    grad_pad = F.pad(grad.reshape(B * L, 1, H, W), (R, R, R, R), mode="replicate").reshape(-1)
    ori_pad = F.pad(ori.reshape(B * L, 1, H, W), (R, R, R, R), mode="replicate").reshape(-1)
    DX, DY = _offsets(R, dev)
    bins4 = torch.arange(PXB, dtype=torch.float32, device=dev)
    bins8 = torch.arange(OHB, dtype=torch.float32, device=dev)
    binoff = (PXB - 1) / 2.0

    xs, ys = x.reshape(-1), y.reshape(-1)
    ix = (xs + 0.5).to(torch.int64)
    iy = (ys + 0.5).to(torch.int64)
    isamp = torch.round(samp.reshape(-1)).to(torch.int64)
    sigma = base_sigma * torch.exp2((samp.reshape(-1) + 1.0) / num_samples)
    binsize = 3.0 * sigma
    win = (math.sqrt(2.0) * binsize * (PXB + 1) * 0.5).to(torch.int64)
    ok = (ix >= win) & (ix + win < W) & (iy >= win) & (iy + win < H)
    level = (torch.clamp(isamp + 1, 0, L - 1).reshape(B, N)
             + torch.arange(B, device=dev)[:, None] * L).reshape(-1)
    oris = orientation.reshape(-1)

    # Only occupied slots get a descriptor; the others stay zero and are
    # masked by the returned keep flags.
    desc = torch.zeros((B * N, PXB * PXB * OHB), dtype=torch.float32, device=dev)
    slots = torch.nonzero(valid.reshape(-1)).squeeze(1)
    for c0 in range(0, len(slots), _KP_CHUNK):
        c = slots[c0:c0 + _KP_CHUNK]
        idx = _window_index(level[c], iy[c], ix[c], R, Hp, Wp)
        gm = grad_pad[idx]
        go = ori_pad[idx]
        o1 = oris[c][:, None]
        theta = go - o1
        theta = torch.where(theta < 0, theta + 2 * math.pi, theta)
        winx = DX - (xs[c] - ix[c])[:, None]
        winy = DY - (ys[c] - iy[c])[:, None]
        sino = torch.sin(o1)
        coso = torch.cos(o1)
        bs = binsize[c][:, None]
        binx = (coso * winx + sino * winy) / bs + binoff
        biny = (-sino * winx + coso * winy) / bs + binoff
        bint = theta * OHB / (2 * math.pi) - 0.5

        gw = torch.exp(-((binx - binoff) ** 2 + (biny - binoff) ** 2)
                       / (2.0 * (0.5 * PXB) ** 2))
        w1 = win[c][:, None]
        in_win = (torch.abs(DX) <= w1) & (torch.abs(DY) <= w1)
        contrib = torch.where(in_win, gm * gw, torch.zeros_like(gm))

        # Trilinear soft-binning as separable hat-weight contractions:
        # hat(d) = max(0, 1-|d|) reproduces the two-corner linear weights,
        # including the drop of out-of-range spatial bins; the orientation
        # axis wraps, so its distance is circular.
        wxh = torch.clamp(1.0 - torch.abs(binx[..., None] - bins4), min=0.0)
        wyh = torch.clamp(1.0 - torch.abs(biny[..., None] - bins4), min=0.0)
        dt = torch.abs(torch.remainder(bint[..., None] - bins8, OHB))
        dt = torch.minimum(dt, OHB - dt)
        wth = torch.clamp(1.0 - dt, min=0.0)                          # (n,T,8)
        M = (contrib[..., None, None] * wyh[..., :, None]) * wxh[..., None, :]
        d = torch.bmm(M.reshape(M.shape[0], M.shape[1], PXB * PXB).transpose(1, 2), wth)
        d = d.reshape(-1, PXB * PXB * OHB)
        # Normalise, clamp 0.2, renormalise (sift.cc:832-840).
        d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-12)
        d = torch.clamp(d, max=0.2)
        d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-12)
        desc[c] = d
    return desc.reshape(B, N, -1), ok.reshape(B, N) & valid


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _pad_to_bucket(n: int, cap: int, chunk: int = 256) -> int:
    """Next power of two >= chunk that covers n, at most cap (mve_tpu's
    slot budget; kept so both packages keep the same slot counts)."""
    size = chunk
    while size < n and size < cap:
        size *= 2
    return min(size, cap) if cap >= chunk else size


def _octave_detect(oct_img, num_samples: int, base_sigma: float,
                   has_sigma: float, cap: int, contrast_thr: float,
                   edge_thr: float):
    """Stage 1 per octave: scale space + DoGs + extrema + top-`cap`
    candidate selection + batched localisation.

    Returns (gauss, x, y, s, keep), keypoint arrays (B, cap)."""
    gauss, dogs = _build_octave(oct_img, num_samples, base_sigma, has_sigma)
    mask = _extrema_mask(dogs)  # (B, S, H, W)
    B, S, H, W = mask.shape
    # Candidate strength = |DoG| at the centre sample; masked to extrema.
    strength = torch.where(mask, torch.abs(dogs[:, 1:1 + S]),
                           torch.full_like(mask, -1.0, dtype=dogs.dtype))
    flat = strength.reshape(B, -1)
    k = min(cap, flat.shape[1])
    srt = torch.sort(flat, dim=1, descending=True, stable=True)
    vals, idx = srt.values[:, :k], srt.indices[:, :k]
    valid = vals > 0.0
    isamp = idx // (H * W)
    rem = idx % (H * W)
    iy = rem // W
    ix = rem % W
    # Invalid slots point at interior pixels so gathers stay in range.
    ix = torch.where(valid, ix, torch.full_like(ix, 2))
    iy = torch.where(valid, iy, torch.full_like(iy, 2))
    isamp = torch.where(valid, isamp, torch.zeros_like(isamp))
    x, y, s, keep = _localize_keypoints(
        dogs, ix, iy, isamp, valid, contrast_thr, edge_thr, num_samples)
    return gauss, x, y, s, keep


def _compact_keypoints(x, y, s, keep):
    """Pack valid keypoints into the first half of the slot array.

    _octave_detect orders candidates by extremum strength and the sort on
    validity is stable, so survivors stay strongest-first and any overflow
    past cap/2 drops the weakest (mve_tpu's budget: real keypoint counts
    run well below cap)."""
    cap2 = x.shape[1] // 2
    order = _stable_order((~keep).to(torch.uint8))[:, :cap2]
    kd = torch.gather(keep, 1, order)
    eight = torch.full_like(x[:, :cap2], 8.0)
    xd = torch.where(kd, torch.gather(x, 1, order), eight)
    yd = torch.where(kd, torch.gather(y, 1, order), eight)
    sd = torch.where(kd, torch.gather(s, 1, order), torch.zeros_like(eight))
    return xd, yd, sd, kd


def _compact_slots(x, y, s, oris, ori_valid, keep, max_ori: int):
    """Expand keypoints x orientations to flat slots and pack the valid
    ones into the first `cap` entries (stable: overflow drops the tail)."""
    B, cap = x.shape
    valid_f = (ori_valid & keep[:, :, None]).reshape(B, -1)
    order = _stable_order((~valid_f).to(torch.uint8))[:, :cap]
    vd = torch.gather(valid_f, 1, order)
    eight = torch.full((B, cap), 8.0, dtype=x.dtype, device=x.device)

    def pick(a):
        return torch.gather(a.repeat_interleave(max_ori, dim=1), 1, order)

    xd = torch.where(vd, pick(x), eight)
    yd = torch.where(vd, pick(y), eight)
    sd = torch.where(vd, pick(s), torch.zeros_like(eight))
    od = torch.gather(oris.reshape(B, -1), 1, order)
    return xd, yd, sd, od, vd


def _octave_full(oct_img, num_samples: int, base_sigma: float,
                 has_sigma: float, cap: int, contrast_thr: float,
                 edge_thr: float, max_ori: int):
    """One octave for a batch of views: detect, orientations on cap/2
    slots, slot compaction, descriptors. Returns (x, y, s, ori, desc, ok)
    padded to cap/2 slots per view."""
    gauss, x, y, s, keep = _octave_detect(
        oct_img, num_samples, base_sigma, has_sigma, cap, contrast_thr, edge_thr)
    x, y, s, keep = _compact_keypoints(x, y, s, keep)
    grad, orient = _grad_ori(gauss)
    oris, ori_valid = _assign_orientations(
        grad, orient, x, y, s, keep, num_samples, base_sigma, max_ori)
    xd, yd, sd, od, vd = _compact_slots(x, y, s, oris, ori_valid, keep, max_ori)
    desc, ok = _compute_descriptors(grad, orient, xd, yd, sd, od, vd,
                                    num_samples, base_sigma)
    return xd, yd, sd, od, desc, ok & vd


def _to_gray_f32(image) -> np.ndarray:
    """Grayscale in numpy with image_tools.desaturate's luminosity weights."""
    img = np.asarray(image)
    if img.ndim == 3:
        if img.shape[2] >= 3:
            f = image_tools.to_float(img)
            img = (0.21 * f[:, :, 0] + 0.72 * f[:, :, 1] + 0.07 * f[:, :, 2])
        else:
            img = image_tools.to_float(img)[:, :, 0]
    else:
        img = image_tools.to_float(img)
    return np.asarray(img, np.float32)


_MAX_FEATURE_BATCH = 10  # views per batch: bounds the pyramid working set


def _empty_result() -> SiftResult:
    z = np.zeros(0, np.float32)
    return SiftResult(z, z.copy(), z.copy(), z.copy(), np.zeros((0, 128), np.float32))


def detect_and_describe_batch(images, options: SiftOptions = SiftOptions(),
                              device="cuda"):
    """SIFT over a list of images, batched over same-shape views
    (_MAX_FEATURE_BATCH at a time). Returns one SiftResult per image."""
    dev = resolve_device(device)
    grays = [_to_gray_f32(im) for im in images]
    if options.min_octave < 0:
        return [_detect_per_image(g, options, dev) for g in grays]
    if len(set(g.shape for g in grays)) > 1:
        return [detect_and_describe_batch([g], options, dev)[0] for g in grays]
    out = []
    for i in range(0, len(grays), _MAX_FEATURE_BATCH):
        out.extend(_detect_batch(grays[i:i + _MAX_FEATURE_BATCH], options, dev))
    return out


def _detect_batch(grays, opts: SiftOptions, dev):
    S = opts.num_samples_per_octave
    B = len(grays)
    base = torch.from_numpy(np.stack(grays)).to(dev)
    results = [dict(x=[], y=[], scale=[], ori=[], desc=[]) for _ in range(B)]
    img_sigma = opts.inherent_blur_sigma
    for _ in range(opts.min_octave):
        base = image_tools.half_size_gaussian_planes(base)
    pending = []
    o = opts.min_octave
    while o <= opts.max_octave and base.shape[1] >= 16 and base.shape[2] >= 16:
        H, W = base.shape[1], base.shape[2]
        cap = min(opts.max_keypoints_per_octave, max(256, S * H * W // 64))
        cap = _pad_to_bucket(cap, opts.max_keypoints_per_octave)
        pending.append((o, _octave_full(
            base, S, opts.base_blur_sigma, float(img_sigma), cap,
            opts.eff_contrast_threshold, opts.edge_ratio_threshold,
            opts.max_orientations_per_keypoint)))
        base = image_tools.half_size_gaussian_planes(base)
        img_sigma = opts.base_blur_sigma
        o += 1

    for o, arrays in pending:
        xd, yd, sd, od, desc, ok = (a.cpu().numpy() for a in arrays)
        scale_factor = 2.0 ** o
        for b in range(B):
            sel = ok[b]
            if not sel.any():
                continue
            results[b]["x"].append(scale_factor * (xd[b][sel] + 0.5) - 0.5)
            results[b]["y"].append(scale_factor * (yd[b][sel] + 0.5) - 0.5)
            results[b]["scale"].append(
                opts.base_blur_sigma * 2.0 ** (o + (sd[b][sel] + 1.0) / S))
            results[b]["ori"].append(od[b][sel])
            results[b]["desc"].append(desc[b][sel])

    out = []
    for r in results:
        if not r["x"]:
            out.append(_empty_result())
            continue
        out.append(SiftResult(*(np.concatenate(r[k]).astype(np.float32)
                                for k in ("x", "y", "scale", "ori", "desc"))))
    return out


def _detect_per_image(img: np.ndarray, opts: SiftOptions, dev) -> SiftResult:
    """mve_tpu's per-image path (sfm/sift.py:721-800), which it takes for
    min_octave < 0: per octave, detection on `cap` slots, then the kept
    keypoints alone (read back on the host) through orientations, then
    each (keypoint, orientation) through descriptors. The stages are the
    batched ones with a batch of one."""
    S = opts.num_samples_per_octave
    gray = torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(dev)
    octave_inputs = []
    if opts.min_octave < 0:
        up = image_tools.rescale_double_size(gray[:, :, None])[:, :, 0]
        octave_inputs.append((-1, up, opts.inherent_blur_sigma * 2.0))
    base = gray
    img_sigma = opts.inherent_blur_sigma
    for _ in range(opts.min_octave):
        base = image_tools.half_size_gaussian_planes(base)
    for o in range(max(0, opts.min_octave), opts.max_octave + 1):
        if base.shape[0] < 16 or base.shape[1] < 16:
            break
        octave_inputs.append((o, base, img_sigma))
        base = image_tools.half_size_gaussian_planes(base)
        img_sigma = opts.base_blur_sigma

    parts = []
    for oct_idx, oct_img, has_sigma in octave_inputs:
        H, W = oct_img.shape
        cap = min(opts.max_keypoints_per_octave, max(256, S * H * W // 64))
        cap = _pad_to_bucket(cap, opts.max_keypoints_per_octave)
        gauss, x, y, s, keep = _octave_detect(
            oct_img[None], S, opts.base_blur_sigma, float(has_sigma), cap,
            opts.eff_contrast_threshold, opts.edge_ratio_threshold)
        keep = keep[0]
        if not bool(keep.any()):
            continue
        kx, ky, ks = x[0][keep], y[0][keep], s[0][keep]
        grad, orient = _grad_ori(gauss)
        oris, ori_valid = _assign_orientations(
            grad, orient, kx[None], ky[None], ks[None], torch.ones_like(kx, dtype=torch.bool)[None],
            S, opts.base_blur_sigma, opts.max_orientations_per_keypoint)
        kp_rep, ori_flat = torch.nonzero(ori_valid[0], as_tuple=True)
        if len(kp_rep) == 0:
            continue
        dx, dy, ds = kx[kp_rep], ky[kp_rep], ks[kp_rep]
        do = oris[0][kp_rep, ori_flat]
        desc, keep_d = _compute_descriptors(
            grad, orient, dx[None], dy[None], ds[None], do[None],
            torch.ones_like(dx, dtype=torch.bool)[None], S, opts.base_blur_sigma)
        keep_d = keep_d[0]
        if not bool(keep_d.any()):
            continue
        fx, fy, fs, fo, fd = (a.cpu().numpy() for a in
                              (dx[keep_d], dy[keep_d], ds[keep_d], do[keep_d], desc[0][keep_d]))
        scale_factor = 2.0 ** oct_idx
        parts.append((scale_factor * (fx + 0.5) - 0.5, scale_factor * (fy + 0.5) - 0.5,
                      opts.base_blur_sigma * 2.0 ** (oct_idx + (fs + 1.0) / S), fo, fd))
    if not parts:
        return _empty_result()
    return SiftResult(*(np.concatenate([p[k] for p in parts]).astype(np.float32)
                        for k in range(5)))


def detect_and_describe(image, options: SiftOptions = SiftOptions(),
                        device="cuda") -> SiftResult:
    """SIFT on one image: the batched pipeline with a batch of one (the
    per-image path with min_octave < 0, as mve_tpu).

    Returns descriptors in input-pixel coordinates (Sift::process +
    get_descriptors, sift.cc:42-168)."""
    return detect_and_describe_batch([image], options, device)[0]
