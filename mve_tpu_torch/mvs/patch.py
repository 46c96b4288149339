"""Batched NCC patch scoring (reference: libs/dmrecon/patch_sampler.cc
getFastNCC / fastColAndDeriv).

For every reference pixel simultaneously: sample a filter_width^2 patch
in each neighbor view through the reprojection operator
xd = T xs z + t (camera.h:105-125) at the pixel's candidate depth, and
compute normalized cross-correlation against the reference patch. The
reference's per-pixel scalar loops become one (J, K, H, W) tensor
program: the patch loop is unrolled (25 taps), each tap is a bilinear
gather.

Depth convention: candidate depths are RAY LENGTHS (MVE convention,
depthmap.h:55-64); conversion to z-depth uses the per-pixel unit-ray z
component, precomputed once.

Index safety: every corner index goes float -> floor -> clamp -> int64
and is clamped again after the cast, so a NaN or infinite coordinate
reads a pixel inside the image (and is marked out of bounds) instead of
faulting.

Rounding: the arithmetic follows how XLA's CPU backend evaluates
mve_tpu's expressions, so that on the CPU the two packages agree to the
last bit wherever no transcendental function intervenes: prefix sums in
XLA's order (_prefix_sum), a * b + c fused into one rounding where XLA
fuses it (_fma), and division by a constant as multiplication by its
float32 reciprocal. None of it depends on the device: the card follows
the same order, so that card and CPU stay within chip_smoke.py's limits
(with torch.cumsum and plain float32 multiply-adds on the card a view
takes under half the time, but its depths move from the CPU's by about
as much as the solver's own error; PERF.md). On the card the slanted-
plane tap loop (_plane_tap_sums) is one kernel, csrc/plane_ncc.cu, that
keeps this order to the bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops import plane_ncc

_SCAN_BLOCK = 16


def make_patch_offsets(filter_width: int):
    r = filter_width // 2
    offs = []
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            offs.append((dy, dx))
    return tuple(offs)


def _fma(a, b, c):
    """a * b + c rounded once (a fused multiply-add), computed in float64,
    which holds the float32 product exactly."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a.double() * b + c).to(torch.float32)


def _recip(n):
    """The float32 reciprocal of a constant divisor."""
    return float(torch.tensor(1.0 / n, dtype=torch.float32))


def _seq_prefix(x):
    """Inclusive prefix sum along the last dim, left to right in float32.
    It runs on a copy with that dim outermost, so each step is one add
    over contiguous memory."""
    out = x.movedim(-1, 0).contiguous()
    for i in range(1, out.shape[0]):
        out[i] += out[i - 1]
    return out.movedim(0, -1)


def _prefix_sum(x, dim: int):
    """Inclusive prefix sum along `dim` in a fixed summation order: blocks
    of 16 summed left to right, block totals scanned the same way and
    added back. This is the order of XLA's CPU cumsum (mve_tpu's
    jnp.cumsum), and it does not depend on the device."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        out = _seq_prefix(x)
    else:
        pad = (-n) % _SCAN_BLOCK
        xp = F.pad(x, (0, pad))
        blocks = _seq_prefix(xp.reshape(*x.shape[:-1], -1, _SCAN_BLOCK))
        totals = _prefix_sum(blocks[..., -1], -1)
        before = F.pad(totals[..., :-1], (1, 0))
        out = (blocks + before[..., None]).reshape(xp.shape)[..., :n]
    return out.movedim(-1, dim)


def _edge_pad(x, r: int, dim: int):
    """x with r edge-replicated entries added on both sides of `dim`."""
    n = x.shape[dim]
    idx = torch.arange(-r, n + r, device=x.device).clamp_(0, n - 1)
    return x.index_select(dim, idx)


def _box_sum(x, w: int):
    """Separable w x w box sum with edge padding; x: (..., H, W)."""
    r = w // 2
    x = _prefix_sum(_edge_pad(x, r, -2), -2)
    x = x[..., w - 1:, :] - F.pad(x[..., :-w, :], (0, 0, 1, 0))
    x = _prefix_sum(_edge_pad(x, r, -1), -1)
    return x[..., :, w - 1:] - F.pad(x[..., :, :-w], (1, 0))


def _index(x, hi: int):
    """Float corner coordinate (already floored and clipped) -> int64,
    clamped after the cast: a NaN survives the float clip."""
    return x.to(torch.int64).clamp_(0, max(hi, 0))


def _shifted(img, dy: int, dx: int):
    """img(y + dy, x + dx) with edge replication; img: (H, W, ...)."""
    H, W = img.shape[0], img.shape[1]
    ys = (torch.arange(H, device=img.device) + dy).clamp_(0, H - 1)
    xs = (torch.arange(W, device=img.device) + dx).clamp_(0, W - 1)
    return img.index_select(0, ys).index_select(1, xs)


def _grid(H: int, W: int, device):
    ys = torch.arange(H, dtype=torch.float32, device=device)[:, None].expand(H, W)
    xs = torch.arange(W, dtype=torch.float32, device=device)[None, :].expand(H, W)
    return ys, xs


def _project(T, tvec, z, qx, qy):
    """Reprojection h = T (qx, qy, 1) z + t -> (u, v, hz) pixel coords."""
    def row(i):
        return _fma(T[..., i, 0] * qx + T[..., i, 1] * qy + T[..., i, 2], z, tvec[..., i])

    hx, hy, hz = row(0), row(1), row(2)
    hz_safe = torch.where(torch.abs(hz) < 1e-20, 1e-20, hz)
    return hx / hz_safe - 0.5, hy / hz_safe - 0.5, hz


def _corner(x, hi):
    """floor(x) clipped to [0, hi]; hi an int, or a float tensor that
    broadcasts against x (a bound per neighbor)."""
    if isinstance(hi, torch.Tensor):
        return torch.minimum(torch.clamp(torch.floor(x), min=0), hi)
    return torch.clamp(torch.floor(x), 0, hi)


def _warp_bilinear(neigh_imgs, T, tvec, z, qx, qy, hw=None):
    """Warp reference pixels into neighbor views: bilinear corners.

    T: (..., 3, 3), tvec: (..., 3) broadcastable against z's leading axes;
    z, qx, qy broadcast to the output shape. hw: None, or (..., 2) float
    (height, width) of each neighbor's own image inside the padded
    (Hn, Wn) tensor, broadcastable as T: a tap outside it is out of
    bounds and no corner reads the padding. Returns (u0i, v0i, fu, fv,
    in_bounds) with int64 corner indices.
    """
    Hn, Wn = neigh_imgs.shape[-2], neigh_imgs.shape[-1]
    h, w = (Hn, Wn) if hw is None else (hw[..., 0], hw[..., 1])
    u, v, hz = _project(T, tvec, z, qx, qy)
    inb = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1) & (hz > 0)
    u0 = _corner(u, w - 2)
    v0 = _corner(v, h - 2)
    fu = torch.clamp(u - u0, 0.0, 1.0)
    fv = torch.clamp(v - v0, 0.0, 1.0)
    return _index(u0, Wn - 2), _index(v0, Hn - 2), fu, fv, inb


def _gather_views(neigh_imgs, jidx, v0i, u0i):
    """neigh_imgs[jidx, v0i, u0i] for neigh_imgs (J, Hn, Wn), jidx
    broadcastable against the index tensors."""
    J, Hn, Wn = neigh_imgs.shape
    return neigh_imgs.reshape(-1)[(jidx * Hn + v0i) * Wn + u0i]


def _bilinear(gather, v0i, u0i, fu, fv):
    p00 = gather(v0i, u0i)
    p01 = gather(v0i, u0i + 1)
    p10 = gather(v0i + 1, u0i)
    p11 = gather(v0i + 1, u0i + 1)
    # p00 (1-fu)(1-fv) + p01 fu (1-fv) + p10 (1-fu) fv + p11 fu fv
    return _fma(p11 * fu, fv, _fma(p10 * (1 - fu), fv,
                                   _fma(p00 * (1 - fu), 1 - fv, p01 * fu * (1 - fv))))


def _mean_var(total, total_sq, inv_n):
    mean = total * inv_n
    return mean, _fma(total_sq, inv_n, -(mean * mean))


def _ref_stats(ref_img, fw):
    return _mean_var(_box_sum(ref_img, fw), _box_sum(ref_img * ref_img, fw),
                     _recip(fw * fw))


def _box_ncc(ref_img, mean_r, var_r, nv, inb, fw):
    """Box-window NCC of warped neighbor values nv (..., H, W) against the
    reference; returns (ncc without the validity gate, full-window mask)."""
    n_taps = fw * fw
    inv_n = _recip(n_taps)
    nv = torch.where(inb, nv, 0.0)
    cnt = _box_sum(inb.to(torch.float32), fw)
    full = cnt >= n_taps - 0.5
    mean_n, var_n = _mean_var(_box_sum(nv, fw), _box_sum(nv * nv, fw), inv_n)
    cov = _fma(_box_sum(nv * ref_img, fw), inv_n, -(mean_r * mean_n))
    denom = torch.sqrt(torch.clamp(var_r * var_n, min=1e-12))
    return cov / denom, full


def _combine_topk(ncc, valid, k):
    """Mean of the top-k values over dim 0 (the views), gated on >= k
    valid views; returns (score, k-th best)."""
    k = min(k, ncc.shape[0])
    top = torch.topk(ncc, k, dim=0).values
    n_valid = valid.sum(dim=0)
    total = top[0]
    for i in range(1, k):
        total = total + top[i]
    score = total / k
    kth = top[-1]
    score = torch.where(n_valid >= k, score, -1.0)
    kth = torch.where(n_valid >= k, kth, -1.0)
    return score, kth


def _combine_sel(ncc, ok):
    """Mean over dim 0 (the selected views) of the usable entries, gated
    on ALL being usable; returns (score, worst)."""
    S = ncc.shape[0]
    n_ok = ok.sum(dim=0)
    vals = torch.where(ok, ncc, 0.0)
    total = vals[0]
    for i in range(1, S):
        total = total + vals[i]
    score = total / torch.clamp(n_ok, min=1)
    kth = torch.amin(torch.where(ok, ncc, 1.0), dim=0)
    score = torch.where(n_ok >= S, score, -1.0)
    kth = torch.where(n_ok >= S, kth, -1.0)
    return score, kth


def ncc_score_box(ref_img, neigh_imgs, T, tvec, ray_z, depths,
                  filter_width: int = 5, top_k: int = 4):
    """Box-filter NCC over candidate depth stacks — the fast formulation.

    Warps each pixel ONCE per (neighbor, candidate) with its own depth
    and computes windowed statistics with separable box sums instead of
    25 gathers per pixel. Exact when depth is locally constant over the
    patch; at depth edges it mixes neighboring pixels' depths where the
    exact kernel (ncc_score) uses the center's fronto-parallel plane.

    depths: (K, H, W). Returns (score (K, H, W), kth (K, H, W)).
    """
    H, W = ref_img.shape
    J = neigh_imgs.shape[0]
    fw = filter_width
    ys, xs = _grid(H, W, ref_img.device)
    z = depths * ray_z[None]
    u0i, v0i, fu, fv, inb = _warp_bilinear(
        neigh_imgs, T[:, None, None, None], tvec[:, None, None, None],
        z[None], xs + 0.5, ys + 0.5)
    jidx = torch.arange(J, device=ref_img.device)[:, None, None, None]
    nv = _bilinear(lambda v, u: _gather_views(neigh_imgs, jidx, v, u), v0i, u0i, fu, fv)
    mean_r, var_r = _ref_stats(ref_img, fw)
    ncc, full = _box_ncc(ref_img, mean_r, var_r, nv, inb, fw)
    ncc = torch.where(full, ncc, -1.0)
    return _combine_topk(ncc, full, top_k)


def ncc_score_multi(ref_img, neigh_imgs, T, tvec, ray_z, depths,
                    filter_width: int = 5, top_k: int = 4):
    """Score a stack of candidate depth maps: (K, H, W) -> (scores (K, H,
    W), kth-best NCC (K, H, W))."""
    out = [ncc_score(ref_img, neigh_imgs, T, tvec, ray_z, d,
                     filter_width=filter_width, top_k=top_k) for d in depths]
    return torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out])


def ncc_score(ref_img, neigh_imgs, T, tvec, ray_z, depth,
              filter_width: int = 5, top_k: int = 4):
    """Combined NCC score for a candidate ray-length depth map.

    ref_img: (H, W) float32 grayscale reference at the working level.
    neigh_imgs: (J, Hn, Wn) neighbor grayscales (same level).
    T: (J, 3, 3), tvec: (J, 3) — reprojection operators ref -> neighbor.
    ray_z: (H, W) z-component of the unit viewing ray per ref pixel.
    depth: (H, W) candidate ray-length depths.

    Returns (score (H, W), mean NCC over the top_k neighbors).
    """
    H, W = ref_img.shape
    J = neigh_imgs.shape[0]
    offsets = make_patch_offsets(filter_width)
    n_taps = len(offsets)
    dev = ref_img.device
    ys, xs = _grid(H, W, dev)
    z = depth * ray_z

    sum_r = torch.zeros((H, W), device=dev)
    sum_rr = torch.zeros((H, W), device=dev)
    sum_n = torch.zeros((J, H, W), device=dev)
    sum_nn = torch.zeros((J, H, W), device=dev)
    sum_rn = torch.zeros((J, H, W), device=dev)
    valid = torch.ones((J, H, W), dtype=torch.bool, device=dev)
    jidx = torch.arange(J, device=dev)[:, None, None]

    for (dy, dx) in offsets:
        rv = _shifted(ref_img, dy, dx)
        sum_r = sum_r + rv
        sum_rr = _fma(rv, rv, sum_rr)
        # Pixel centers sit at integer + 0.5 (camera.h:80-86).
        u0i, v0i, fu, fv, inb = _warp_bilinear(
            neigh_imgs, T[:, None, None], tvec[:, None, None], z,
            xs + dx + 0.5, ys + dy + 0.5)
        valid = valid & inb
        nv = _bilinear(lambda v, u: _gather_views(neigh_imgs, jidx, v, u), v0i, u0i, fu, fv)
        sum_n = sum_n + nv
        sum_nn = _fma(nv, nv, sum_nn)
        sum_rn = _fma(rv[None], nv, sum_rn)

    inv_n = _recip(n_taps)
    mean_r, var_r = _mean_var(sum_r, sum_rr, inv_n)
    mean_n, var_n = _mean_var(sum_n, sum_nn, inv_n)
    cov = _fma(sum_rn, inv_n, -(mean_r[None] * mean_n))
    denom = torch.sqrt(torch.clamp(var_r[None] * var_n, min=1e-12))
    ncc = torch.where(valid, cov / denom, -1.0)
    # Mean over the top_k best neighbors per pixel; the k-th best rides
    # along so acceptance can require every selected neighbor to reach
    # acceptNCC (patch_optimization.cc:216).
    return _combine_topk(ncc, valid, top_k)


def _plane_tap_sums(ref_img, neigh_imgs, T, tvec, hw, jidx, ray_z,
                    depths, dzx, dzy, filter_width: int):
    """Slanted-patch (plane) NCC of each candidate plane in the views jidx.

    T: (J, 3, 3), tvec: (J, 3) reprojection operators; hw: None, or (J, 2)
    the neighbors' own sizes (_warp_bilinear); jidx: an integer view index
    that broadcasts to (lead, K, H, W) with a lead dim of its own, e.g.
    arange(J)[:, None, None, None] (every view) or sel[:, None] (per-pixel
    selected views); depths/dzx/dzy: (K, H, W) candidate plane stacks.
    Returns (ncc, valid), each (lead, K, H, W). A CUDA tensor runs the
    kernel csrc/plane_ncc.cu (ops/plane_ncc.py), bit-identical to the
    plain tensor program _plane_tap_sums_plain, which a CPU tensor runs.
    """
    if depths.is_cuda:
        return plane_ncc.plane_ncc(ref_img, neigh_imgs, T, tvec, hw, jidx, ray_z,
                                   depths, dzx, dzy, filter_width,
                                   _recip(filter_width * filter_width))
    return _plane_tap_sums_plain(ref_img, neigh_imgs, T, tvec, hw, jidx, ray_z,
                                 depths, dzx, dzy, filter_width)


def _plane_tap_sums_plain(ref_img, neigh_imgs, T, tvec, hw, jidx, ray_z,
                          depths, dzx, dzy, filter_width: int):
    """_plane_tap_sums as one tensor program over the (lead, K, H, W) stack.

    The patch plane is the reference's (depth, dzI, dzJ) parametrization
    (patch_sampler.cc computePatchPoints): the ray length at patch tap
    (di, dj) is depth + di*dzI + dj*dzJ, the 3D point lies on that tap's
    own viewing ray. Each tap warps into the neighbor views with its own
    plane-induced z-depth.
    """
    K, H, W = depths.shape
    fw = filter_width
    n_taps = fw * fw
    dev = depths.device
    ys, xs = _grid(H, W, dev)
    Tg, tg = T[jidx], tvec[jidx]
    hwg = None if hw is None else hw[jidx]

    shape = (jidx.shape[0], K, H, W)
    sum_r = torch.zeros((H, W), device=dev)
    sum_rr = torch.zeros((H, W), device=dev)
    sum_n = torch.zeros(shape, device=dev)
    sum_nn = torch.zeros(shape, device=dev)
    sum_rn = torch.zeros(shape, device=dev)
    valid = torch.ones(shape, dtype=torch.bool, device=dev)

    for (dy, dx) in make_patch_offsets(fw):
        rv = _shifted(ref_img, dy, dx)
        rz = _shifted(ray_z, dy, dx)
        sum_r = sum_r + rv
        sum_rr = _fma(rv, rv, sum_rr)
        L = depths + dx * dzx + dy * dzy      # (K, H, W) tap ray length
        pos_ok = L > 0.0                      # patch_sampler.cc:285-288
        u0i, v0i, fu, fv, inb = _warp_bilinear(
            neigh_imgs, Tg, tg, L * rz, xs + dx + 0.5, ys + dy + 0.5, hwg)
        valid = valid & inb & pos_ok
        nv = _bilinear(lambda v, u: _gather_views(neigh_imgs, jidx, v, u), v0i, u0i, fu, fv)
        sum_n = sum_n + nv
        sum_nn = _fma(nv, nv, sum_nn)
        sum_rn = _fma(rv, nv, sum_rn)

    inv_n = _recip(n_taps)
    mean_r, var_r = _mean_var(sum_r, sum_rr, inv_n)
    mean_n, var_n = _mean_var(sum_n, sum_nn, inv_n)
    cov = _fma(sum_rn, inv_n, -(mean_r * mean_n))
    denom = torch.sqrt(torch.clamp(var_r * var_n, min=1e-12))
    ncc = torch.where(valid, cov / denom, -1.0)
    return ncc, valid


def ncc_score_plane(ref_img, neigh_imgs, T, tvec, ray_z, depths, dzx, dzy,
                    filter_width: int = 5, top_k: int = 4):
    """Slanted-patch NCC over ALL views, top-k combined.

    depths/dzx/dzy: (K, H, W) plane candidates (ray length + per-pixel
    ray-length gradients, the reference's depth/dzI/dzJ). Returns
    (score (K, H, W), kth (K, H, W))."""
    jidx = torch.arange(neigh_imgs.shape[0], device=depths.device)[:, None, None, None]
    ncc, valid = _plane_tap_sums(ref_img, neigh_imgs, T, tvec, None, jidx, ray_z,
                                 depths, dzx, dzy, filter_width)
    return _combine_topk(ncc, valid, top_k)


def ncc_score_plane_sel(ref_img, neigh_imgs, T, tvec, ray_z, depths,
                        dzx, dzy, sel, sel_valid, filter_width: int = 5,
                        neigh_hw=None):
    """Slanted-patch NCC over per-pixel SELECTED views.

    sel: (S, H, W) int; sel_valid: (S, H, W); depths/dzx/dzy: (K, H, W);
    neigh_hw: None, or (J, 2) each neighbor's own (height, width) in the
    padded neigh_imgs (_warp_bilinear).
    Returns (score (K, H, W), kth (K, H, W)) like ncc_score_box_sel."""
    ncc, valid = _plane_tap_sums(ref_img, neigh_imgs, T, tvec, neigh_hw, sel[:, None], ray_z,
                                 depths, dzx, dzy, filter_width)
    ok = valid & sel_valid[:, None]
    return _combine_sel(torch.where(ok, ncc, -1.0), ok)


def ncc_per_view_box(ref_img, neigh_imgs, T, tvec, ray_z, depth,
                     filter_width: int = 5):
    """Box-filter NCC of EVERY neighbor at one depth map: (J, H, W).

    Feeds local view selection (the reference's sampler->getFastNCC per
    candidate view, local_view_selection.cc:77)."""
    H, W = ref_img.shape
    J = neigh_imgs.shape[0]
    fw = filter_width
    ys, xs = _grid(H, W, ref_img.device)
    z = depth * ray_z
    u0i, v0i, fu, fv, inb = _warp_bilinear(
        neigh_imgs, T[:, None, None], tvec[:, None, None], z[None], xs + 0.5, ys + 0.5)
    jidx = torch.arange(J, device=ref_img.device)[:, None, None]
    nv = _bilinear(lambda v, u: _gather_views(neigh_imgs, jidx, v, u), v0i, u0i, fu, fv)
    mean_r, var_r = _ref_stats(ref_img, fw)
    ncc, full = _box_ncc(ref_img, mean_r, var_r, nv, inb, fw)
    return torch.where(full, ncc, -1.0)


def ncc_score_box_sel(ref_img, neigh_imgs, T, tvec, ray_z, depths,
                      sel, sel_valid, filter_width: int = 5):
    """Box-filter NCC over per-pixel SELECTED views only.

    sel: (S, H, W) neighbor indices from local_view_selection;
    sel_valid: (S, H, W) bool. depths: (K, H, W) candidate ray lengths.
    Returns (score (K, H, W) = mean NCC over valid selected views,
    kth (K, H, W) = worst selected NCC).

    Approximation note: the box window around a pixel aggregates warped
    values of *each window pixel's own* i-th selected view; exact when the
    selection is locally constant.
    """
    H, W = ref_img.shape
    fw = filter_width
    ys, xs = _grid(H, W, ref_img.device)
    z = depths * ray_z[None]
    u0i, v0i, fu, fv, inb = _warp_bilinear(
        neigh_imgs, T[sel][:, None], tvec[sel][:, None], z[None], xs + 0.5, ys + 0.5)
    jidx = sel[:, None]
    nv = _bilinear(lambda v, u: _gather_views(neigh_imgs, jidx, v, u), v0i, u0i, fu, fv)
    mean_r, var_r = _ref_stats(ref_img, fw)
    ncc, full = _box_ncc(ref_img, mean_r, var_r, nv, inb, fw)
    ok = sel_valid[:, None] & full
    return _combine_sel(torch.where(ok, ncc, -1.0), ok)
