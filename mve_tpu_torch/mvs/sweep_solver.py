"""Rectified plane-sweep MVS solver — the default dmrecon solver.

The warp solver (solver.py) evaluates NCC by gathering bilinear taps at
per-pixel warped positions for every candidate. This solver gathers
once per pair instead:

1. **Rectify** each (reference, neighbor) pair once on the host: rotate
   both cameras onto the baseline (Fusiello-style closed form) so
   epipolar lines become horizontal scanlines. Two bilinear warps per
   pair.
2. **Sweep** D inverse-rectified-depth planes. In rectified space a
   fronto-parallel plane is a CONSTANT horizontal disparity
   delta = f*|baseline|*w, so each plane evaluation is a fractional
   shift (a column gather + lerp) and box-filtered NCC statistics. All
   D planes of a pair are one tensor program. Result: an NCC cube
   (D, H, W) per neighbor, stored bf16.
3. **Re-index** the cube to reference pixels: the rectified coordinates
   of a reference pixel are fixed per pair, so the cube maps back with
   4 corner row-gathers of D-vectors -> per-pixel NCC-vs-plane tables.
4. **Optimize** like the warp solver (plane sweep init, local view
   selection, PatchMatch propagation, parabolic refinement,
   slanted-plane rounds) — but every score is a 2-tap interpolation
   along the table's D axis: a gather of the two bf16 table entries,
   widened to float32 (mve_tpu computes the same values as one-hot bf16
   contractions, which suit the TPU's matrix unit; with 0/1 weights and
   float32 accumulation the two agree bit for bit).
5. **Exact rescore** of the converged depth with true-warp NCC passes so
   confidences keep the reference's patch semantics
   (patch_optimization.cc computeConfidence).

Depth candidates remain REFERENCE RAY LENGTHS L (MVE convention,
depthmap.h:55-64); the per-pair table index is w' = 1/(L * c_j(p)) with
c_j(p) = e3_j . ray_dir(p) the per-pixel rectified-z cosine.

Round loops are Python loops with a fixed count over device tensors; no
value is read back to the host inside a view's solve.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .patch import _box_sum, _fma, _gather_views, _index, _plane_tap_sums, _recip
from .solver import (_CHUNK, _chunked_best, _combine_sel, _combine_topk, _f32,
                     _local_view_selection, _ncc_box_all, _pick, _plane_normals,
                     _ref_box_stats, _reselect_with_fallback, _roll)
from .view_selection import _dot3
from ..utils.tracing import span


# -----------------------------------------------------------------------
# host-side rectification geometry
# -----------------------------------------------------------------------

def rect_margins(H: int, W: int):
    """The fixed rect-grid margin (y, x) of the legacy rectification
    (rectify_pair with margin_yx, solve_batch_sweep with rect_hw=None)."""
    return H // 8, W // 8


_RECT_PAD = 4  # rect-grid padding per side (NCC window + bilinear taps)


def rectify_pair(K_r, R_r, t_r, K_j, R_j, t_j, min_cross: float = 0.08,
                 margin_yx=(0, 0), image_wh=None):
    """Closed-form rectifying rotation for one (ref, neighbor) pair.

    Returns dict(M_ref, M_nei, H_fwd, e3, fB, rect_wh) or None when the
    baseline is too close to the reference viewing direction (epipole in
    view — rectification degenerates; caller falls back to the warp
    solver).

    M_ref: rect pixel -> ref pixel homography (for warping ref->rect)
    M_nei: rect pixel -> neighbor pixel homography
    H_fwd: ref pixel -> rect pixel homography (fixed table coords)
    e3:    new z axis in world coords (rect depth z' = L * (e3.dir))
    fB:    f_x * |baseline| — disparity per unit inverse rect depth
    rect_wh: (w, h) grid size containing the WHOLE ref image under
        H_fwd. Pixels falling off the rect grid lose this pair, so when
        image_wh=(w, h) is given the grid is FITTED: the rect camera's
        principal point is chosen so the mapped ref-image bbox starts at
        (_RECT_PAD, _RECT_PAD). Without image_wh the principal point is
        shifted by margin_yx instead (the legacy fixed margins,
        rect_margins) and rect_wh is None.
    """
    K_r = np.asarray(K_r, np.float64)
    K_j = np.asarray(K_j, np.float64)
    R_r = np.asarray(R_r, np.float64)
    R_j = np.asarray(R_j, np.float64)
    C_r = -R_r.T @ np.asarray(t_r, np.float64)
    C_j = -R_j.T @ np.asarray(t_j, np.float64)
    b = C_j - C_r
    nb = np.linalg.norm(b)
    if nb < 1e-12:
        return None
    e1 = b / nb
    rz = R_r[2]  # ref viewing direction in world
    a = np.cross(rz, e1)
    na = np.linalg.norm(a)
    if na < min_cross:
        return None  # baseline ~ viewing direction: epipole in image
    e2 = a / na
    e3 = np.cross(e1, e2)
    Rn = np.stack([e1, e2, e3])  # world -> rect rotation
    Kn = K_r.copy()
    rect_wh = None
    if image_wh is not None:
        # Fit: map the ref image corners with the UNSHIFTED rect camera,
        # then place the principal point so the bbox sits at the pad.
        w, h = image_wh
        Hf0 = Kn @ Rn @ R_r.T @ np.linalg.inv(K_r)
        c = np.array([[0.5, 0.5, 1.0], [w - 0.5, 0.5, 1.0],
                      [0.5, h - 0.5, 1.0], [w - 0.5, h - 0.5, 1.0]]).T
        m = Hf0 @ c
        if (m[2] <= 1e-9).any():
            return None  # a ref corner maps behind the rect camera
        uv = (m[:2] / m[2]).T
        lo = np.floor(uv.min(axis=0)) - _RECT_PAD
        hi = np.ceil(uv.max(axis=0)) + _RECT_PAD
        Kn[0, 2] -= lo[0]
        Kn[1, 2] -= lo[1]
        rect_wh = (int(hi[0] - lo[0] + 1), int(hi[1] - lo[1] + 1))
    else:
        Kn[1, 2] += margin_yx[0]  # principal point shift = grid margin
        Kn[0, 2] += margin_yx[1]
    M_ref = K_r @ R_r @ Rn.T @ np.linalg.inv(Kn)
    M_nei = K_j @ R_j @ Rn.T @ np.linalg.inv(Kn)
    H_fwd = Kn @ Rn @ R_r.T @ np.linalg.inv(K_r)
    fB = float(Kn[0, 0]) * nb
    return dict(M_ref=M_ref.astype(np.float32),
                M_nei=M_nei.astype(np.float32),
                H_fwd=H_fwd.astype(np.float32),
                e3=e3.astype(np.float32), fB=fB, rect_wh=rect_wh)


# -----------------------------------------------------------------------
# device primitives
# -----------------------------------------------------------------------

def _homography_coords(M, H, W, device):
    """Pixel coords (u, v) that homography M maps each rect-grid (or
    ref-grid) pixel center of an (H, W) grid to."""
    qy = torch.arange(H, dtype=torch.float32, device=device)[:, None] + 0.5
    qx = torch.arange(W, dtype=torch.float32, device=device)[None, :] + 0.5
    hx = M[0, 0] * qx + M[0, 1] * qy + M[0, 2]
    hy = M[1, 0] * qx + M[1, 1] * qy + M[1, 2]
    hz = M[2, 0] * qx + M[2, 1] * qy + M[2, 2]
    hz = torch.where(torch.abs(hz) < 1e-20, 1e-20, hz)
    return hx / hz - 0.5, hy / hz - 0.5


def _homography_warp(img, M, H, W, fill=-1e3):
    """Sample `img` at homography-mapped rect grid positions.

    img: (Hi, Wi); M: (3, 3) maps rect pixel-centers -> img pixel
    coords. Returns ((H, W) samples, (H, W) validity)."""
    Hi, Wi = img.shape
    u, v = _homography_coords(M, H, W, img.device)
    inb = (u >= 0) & (u <= Wi - 1) & (v >= 0) & (v <= Hi - 1)
    u0 = torch.clamp(torch.floor(u), 0, Wi - 2)
    v0 = torch.clamp(torch.floor(v), 0, Hi - 2)
    fu = (u - u0).to(img.dtype)
    fv = (v - v0).to(img.dtype)
    u0i = _index(u0, Wi - 2)
    v0i = _index(v0, Hi - 2)
    flat = img.reshape(-1)
    p00 = flat[v0i * Wi + u0i]
    p01 = flat[v0i * Wi + u0i + 1]
    p10 = flat[(v0i + 1) * Wi + u0i]
    p11 = flat[(v0i + 1) * Wi + u0i + 1]
    out = (p00 * (1 - fu) * (1 - fv) + p01 * fu * (1 - fv)
           + p10 * (1 - fu) * fv + p11 * fu * fv)
    return torch.where(inb, out, fill), inb


def _frac_shift_x(img, shift):
    """img(y, x - shift) for shift >= 0 by a column gather and a lerp.

    shift: a 0-d tensor, or (D,) to shift by D amounts at once. Returns
    (out (H, W) or (D, H, W), valid (1, W) or (D, 1, W)).

    Rectified disparity moves neighbor content LEFT relative to the
    reference (x_nei = x_ref - f|b|w'), so the reference-grid sample of
    the neighbor is at x - shift."""
    H, W = img.shape
    dev = img.device
    shifts = shift.reshape(-1)
    padded = torch.cat([torch.full((H, W + 1), -1e3, dtype=img.dtype, device=dev), img],
                       dim=1)                                  # (H, 2W+1)
    s = torch.clamp(shifts, 0.0, W)
    fl = torch.floor(s)
    s0 = _index(fl, W)
    f = (s - fl).to(img.dtype)[:, None, None]
    xs_i = torch.arange(W, device=dev)
    cols = (W + 1 - s0)[:, None] + xs_i                        # (D, W): x - s0
    a = padded[:, cols].permute(1, 0, 2)                       # (D, H, W)
    b = padded[:, cols - 1].permute(1, 0, 2)                   # x - s0 - 1
    # a * (1 - f) + b * f with the first product fused into the add
    # (one rounding), as XLA evaluates mve_tpu's vmapped planes.
    out = _fma(a, 1 - f, b * f)
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
    valid = xs - shifts[:, None, None] >= 0
    if shift.dim() == 0:
        return out[0], valid[0]
    return out, valid


def _build_cube(rref, rref_ok, rnei, rnei_ok, fB, w0, dw, D: int, fw: int):
    """NCC cube over D constant-disparity planes for ONE pair, all planes
    in one tensor program.

    rref/rnei: (H, W) rectified images; returns (D, H, W) NCC (bf16)."""
    n_taps = fw * fw
    ok_r = rref_ok
    refv = torch.where(ok_r, rref, 0.0)
    sum_r = _box_sum(refv, fw)
    sum_rr = _box_sum(refv * refv, fw)
    mean_r = sum_r / n_taps
    var_r = sum_rr / n_taps - mean_r * mean_r

    # Plane disparities fB * (w0 + k * dw), the inner multiply-add fused
    # (rounded once), as XLA evaluates mve_tpu's expression.
    k = torch.arange(D, dtype=torch.float32, device=rref.device)
    delta = fB * _fma(k, dw, w0)
    nv, sv = _frac_shift_x(rnei, delta)                    # (D, H, W), (D, 1, W)
    ok = ok_r & rnei_ok & sv & (nv > -1e2)
    nv = torch.where(ok, nv, 0.0)
    cnt = _box_sum(ok.to(torch.float32), fw)
    full = cnt >= n_taps - 0.5
    sum_n = _box_sum(nv, fw)
    sum_nn = _box_sum(nv * nv, fw)
    sum_rn = _box_sum(nv * refv, fw)
    mean_n = sum_n / n_taps
    var_n = sum_nn / n_taps - mean_n * mean_n
    cov = sum_rn / n_taps - mean_r * mean_n
    denom = torch.sqrt(torch.clamp(var_r * var_n, min=1e-12))
    ncc = torch.where(full, cov / denom, -1.0)
    return ncc.to(torch.bfloat16)


def _reindex_cube(cube, H_fwd, H, W):
    """Sample the rect-space cube at each REF pixel's fixed rect coords.

    cube: (D, Hr, Wr) bf16 -> table (H, W, D) bf16 via 4 corner
    row-gathers (contiguous D-vectors per row). The blend is bf16
    arithmetic rounded after every operation, as XLA evaluates mve_tpu's
    (tests/test_torch_mvs.py holds the two tables bit for bit)."""
    D, Hr, Wr = cube.shape
    u, v = _homography_coords(H_fwd, H, W, cube.device)
    inb = (u >= 0) & (u <= Wr - 1) & (v >= 0) & (v <= Hr - 1)
    u0 = torch.clamp(torch.floor(u), 0, Wr - 2)
    v0 = torch.clamp(torch.floor(v), 0, Hr - 2)
    fu = (u - u0).to(torch.bfloat16)[..., None]
    fv = (v - v0).to(torch.bfloat16)[..., None]
    u0i = _index(u0, Wr - 2)
    v0i = _index(v0, Hr - 2)
    rows = cube.permute(1, 2, 0).reshape(Hr * Wr, D)

    def take(vv, uu):
        return rows[vv * Wr + uu]

    t = (take(v0i, u0i) * (1 - fu) * (1 - fv)
         + take(v0i, u0i + 1) * fu * (1 - fv)
         + take(v0i + 1, u0i) * (1 - fu) * fv
         + take(v0i + 1, u0i + 1) * fu * fv)
    return torch.where(inb[..., None], t, torch.tensor(-1.0, dtype=torch.bfloat16,
                                                        device=cube.device))


def _lookup(tab, c_j, w0, dw, nvalid, L):
    """Score candidate ray lengths against the per-pixel plane tables.

    tab: (J, H, W, D) bf16; c_j: (J, H, W); w0/dw: (J,); L: (K, H, W).
    Returns (ncc (J, K, H, W) f32, ok (J, K, H, W) bool).

    The 2-tap interpolation along D gathers the two bf16 entries and
    widens them to float32 (mve_tpu: one-hot contractions, the same
    values); the lerp runs in float32."""
    D = tab.shape[-1]
    Ls = torch.clamp(L, min=1e-12)[None]                                # (1, K, H, W)
    w = 1.0 / (Ls * torch.clamp(c_j[:, None], min=1e-6))               # (J, K, H, W)
    idx = (w - w0[:, None, None, None]) / dw[:, None, None, None]
    ok = (idx >= 0) & (idx <= D - 1) & (c_j[:, None] > 1e-6)
    ok = ok & nvalid[:, None, None, None] & (L > 0)[None]
    idx = torch.clamp(idx, 0.0, D - 1.0001)
    fl = torch.floor(idx)
    i0 = _index(fl, D - 2).permute(0, 2, 3, 1)                          # (J, H, W, K)
    f = idx - fl
    v0 = torch.gather(tab, 3, i0).permute(0, 3, 1, 2).to(torch.float32)
    v1 = torch.gather(tab, 3, i0 + 1).permute(0, 3, 1, 2).to(torch.float32)
    ncc = _fma(v1, f, v0 * (1.0 - f))                                   # v0 (1-f) + v1 f
    # Either tap outside the cube's valid content reads -1 fills; treat
    # strongly negative as invalid.
    ok = ok & (v0 > -0.999) & (v1 > -0.999)
    return torch.where(ok, ncc, -1.0), ok


def _select_views(ncc, ok, sel, sel_valid):
    """Per-pixel selected views of (J, K, H, W) scores: (S, K, H, W)
    scores and usability (mve_tpu: a one-hot contraction over J)."""
    index = sel[:, None].expand(sel.shape[0], ncc.shape[1], *sel.shape[1:])
    ncc_s = torch.gather(ncc, 0, index)
    ok_s = torch.gather(ok, 0, index) & sel_valid[:, None]
    return _combine_sel(torch.where(ok_s, ncc_s, -1.0), ok_s)


def _linspace(start, stop, num: int):
    """jnp.linspace's float32 formula: start * (1 - t) + stop * t, the
    last point exactly `stop`."""
    t = torch.arange(num - 1, dtype=torch.float32, device=start.device) / (num - 1)
    return torch.cat([start * (1 - t) + stop * t, stop[None]])


# -----------------------------------------------------------------------
# the per-view program (sweep-table formulation)
# -----------------------------------------------------------------------

def _solve_view_sweep(ref, neigh, nvalid, T, tvec, ray_z,
                      M_ref, M_nei, H_fwd, e3, fB, w0, dw,
                      init_depth, dmin, dmax, ray_world, cam_rel, scalars, *,
                      fw, k, D, n_prop, n_refine, n_plane_rounds, use_local,
                      rect_hw=None, phase):
    """One reference view end-to-end with table-lookup scoring.

    phase(name): called at each phase's start (see _phase_spans)."""
    H, W = ref.shape
    J = neigh.shape[0]
    dev = ref.device
    min_ncc, min_parallax, accept_ncc, min_refine_diff = (
        scalars[0], scalars[1], scalars[2], scalars[3])
    zeros = torch.zeros_like(init_depth)

    phase("cube")
    # --- per-pair tables (rectify -> sweep -> reindex)
    c_j = _dot3(e3[:, None, None, :], ray_world[None])     # rect z cosine (J, H, W)
    if rect_hw is None:  # legacy fixed margins
        my, mx = rect_margins(H, W)
        Hr, Wr = H + 2 * my, W + 2 * mx
    else:
        Hr, Wr = rect_hw

    tabs = []
    for j in range(J):
        rref, rok = _homography_warp(ref, M_ref[j], Hr, Wr)
        rnei, nok = _homography_warp(neigh[j], M_nei[j], Hr, Wr)
        cube = _build_cube(rref, rok, rnei, nok, fB[j], w0[j], dw[j], D, fw)
        tabs.append(_reindex_cube(cube, H_fwd[j], H, W))
    tab = torch.stack(tabs)                                   # (J, H, W, D)
    del tabs

    def score_all(L):
        ncc, ok = _lookup(tab, c_j, w0, dw, nvalid, L)
        return _combine_topk(ncc, ok, k)

    def score_sel_fn(L, sel, sel_valid):
        ncc, ok = _lookup(tab, c_j, w0, dw, nvalid, L)
        return _select_views(ncc, ok, sel, sel_valid)

    phase("lookup")
    # --- plane sweep init: D_sweep ray-length planes + the seed field
    s0, k0 = score_all(init_depth[None])
    best = (init_depth, s0[0], k0[0])
    n_sweep = D
    lds = torch.exp(_linspace(torch.log(torch.clamp(dmin, min=1e-6)),
                              torch.log(torch.clamp(dmax, min=2e-6)), n_sweep))
    abs_stack = lds[:, None, None].expand(n_sweep, H, W)
    rel_stack = torch.stack([init_depth * f for f in
                             (0.85, 0.93, 1.0 / 0.93, 1.0 / 0.85)])
    best = _chunked_best(score_all, torch.cat([rel_stack, abs_stack]), best, _CHUNK)

    # --- local view selection
    if use_local:
        def reselect(d):
            ncc, _ = _lookup(tab, c_j, w0, dw, nvalid, d[None])
            return _local_view_selection(
                ncc[:, 0], nvalid, d, ray_world, cam_rel, k,
                min_ncc, min_parallax)

        sel, sel_valid = reselect(best[0])
        s1, k1 = score_sel_fn(best[0][None], sel, sel_valid)
        best = (best[0], s1[0], k1[0])
        score_fn = score_sel_fn
    else:
        sel = torch.zeros((k, H, W), dtype=torch.int64, device=dev)
        sel_valid = torch.zeros((k, H, W), dtype=torch.bool, device=dev)

        def score_fn(L, sel, sel_valid):
            return score_all(L)

    # --- PatchMatch propagation rounds
    shifts = ((0, 1), (0, -1), (1, 0), (-1, 0), (0, 3), (3, 0), (0, -3), (-3, 0))
    eps_prop = _f32([0.05 * (0.5 ** it) for it in range(max(n_prop, 1))], dev)
    half = n_prop // 2
    bd, bs, bk = best
    for it in range(n_prop):
        eps = eps_prop[it]
        if use_local and it == half:
            sel, sel_valid = reselect(bd)
            s2, k2 = score_sel_fn(bd[None], sel, sel_valid)
            bs, bk = s2[0], k2[0]
        cands = torch.stack([_roll(bd, dy, dx) for dy, dx in shifts]
                            + [bd * (1.0 - eps), bd * (1.0 + eps)])
        bd, bs, bk = _chunked_best(
            lambda L: score_fn(L, sel, sel_valid), cands, (bd, bs, bk), _CHUNK)

    # --- parabolic refinement
    eps_ref = _f32([0.02 * (0.5 ** s) for s in range(max(n_refine, 1))], dev)
    for i in range(n_refine):
        eps = eps_ref[i]
        d_lo = bd * (1.0 - eps)
        d_hi = bd * (1.0 + eps)
        both, _ = score_fn(torch.stack([d_lo, d_hi]), sel, sel_valid)
        s_lo, s_hi = both[0], both[1]
        denom = s_lo - 2.0 * bs + s_hi
        offset = torch.where(
            torch.abs(denom) > 1e-12,
            torch.clamp(0.5 * (s_lo - s_hi)
                        / torch.where(torch.abs(denom) < 1e-12, 1e-12, denom),
                        -1.0, 1.0),
            0.0)
        cand = bd * (1.0 + offset * eps)
        bd, bs, bk = _chunked_best(lambda L: score_fn(L, sel, sel_valid),
                                   torch.stack([cand, d_lo, d_hi]), (bd, bs, bk), _CHUNK)

    # --- slanted-plane rounds: plane parametrization for propagation,
    # lookup scoring through the per-pixel depth field.
    if n_plane_rounds > 0:
        slope_cap = 0.05 * torch.clamp(bd, min=1e-6)
        bzx = torch.clamp((_roll(bd, 0, -1) - _roll(bd, 0, 1)) * 0.5, -slope_cap, slope_cap)
        bzy = torch.clamp((_roll(bd, -1, 0) - _roll(bd, 1, 0)) * 0.5, -slope_cap, slope_cap)
        eps_pl = _f32([0.3 * (0.5 ** r) for r in range(n_plane_rounds)], dev)
        state = (bd, bzx, bzy, bs, bk)
        prev_mean = torch.tensor(-1e31, dtype=torch.float32, device=dev)
        done = torch.tensor(False, device=dev)
        for r in range(n_plane_rounds):
            eps = eps_pl[r]
            sd, szx, szy, ss, sk = state
            cap = 0.05 * torch.clamp(sd, min=1e-6)
            step = eps * torch.clamp(sd, min=1e-6) * 0.02
            cands, czx, czy = [], [], []
            for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
                nd = _roll(sd, dy, dx)
                nzx = _roll(szx, dy, dx)
                nzy = _roll(szy, dy, dx)
                cands.append(nd + dx * nzx + dy * nzy)
                czx.append(nzx)
                czy.append(nzy)
            for dd, zx, zy in ((0.0, step, None), (0.0, -step, None),
                               (0.0, None, step), (0.0, None, -step),
                               (-1.0, None, None), (1.0, None, None)):
                cands.append(sd + dd * step)
                czx.append(torch.clamp(szx + zx, -cap, cap) if zx is not None else szx)
                czy.append(torch.clamp(szy + zy, -cap, cap) if zy is not None else szy)
            ds = torch.stack(cands)
            cs, ck = score_fn(ds, sel, sel_valid)
            all_s = torch.cat([ss[None], cs])
            new_state = _pick(all_s, torch.cat([sd[None], ds]),
                              torch.cat([szx[None], torch.stack(czx)]),
                              torch.cat([szy[None], torch.stack(czy)]), all_s,
                              torch.cat([sk[None], ck]))
            mean_s = torch.mean(torch.clamp(new_state[3], min=0.0))
            state = tuple(torch.where(done, old, new) for old, new in zip(state, new_state))
            prev_ok = prev_mean > -1e30
            done = done | (prev_ok & (mean_s - prev_mean < min_refine_diff))
            prev_mean = torch.where(done, prev_mean, mean_s)
        bd, bzx, bzy, bs, bk = state
    del tab

    bd = torch.clamp(bd, dmin * 0.5, dmax * 2.0)

    phase("exact")
    # --- exact true-warp polish + rescore. Table scores are
    # piecewise-linear between the D planes, so the lookup refinement
    # snaps toward plane nodes; parabolic steps on the TRUE box NCC
    # restore sub-plane depth accuracy, and the final evaluation keeps
    # the reference's patch semantics for acceptance
    # (patch_optimization.cc computeConfidence).
    rstats = _ref_box_stats(ref, fw)

    def exact_all(L):
        return _ncc_box_all(ref, rstats, neigh, nvalid, T, tvec, ray_z, L, fw)

    def score_exact(L):
        ncc_x, ok_x = exact_all(L)
        if use_local:
            return _select_views(ncc_x, ok_x, sel, sel_valid)
        return _combine_topk(ncc_x, ok_x, k)

    # Reselect views from EXACT NCC first (loose fallback): pixels whose
    # rect tables were partially invalid (off-grid taps, shift margins)
    # but whose TRUE warps are fine — borders, mostly — regain their
    # views here and can participate in the exact rounds below.
    if use_local:
        ncc_x0, _ = exact_all(bd[None])
        sel, sel_valid = _reselect_with_fallback(
            ncc_x0[:, 0], nvalid, bd, ray_world, cam_rel, k,
            min_ncc, min_parallax)

    # Exact PatchMatch rounds: true-warp region growing into pixels the
    # table phase could not score (occlusion bands, image borders) — the
    # batched analog of the reference's sequential growing
    # (dmrecon.cc:334-434 processQueue).
    s_now, k_now = score_exact(bd[None])
    bs, bk = s_now[0], k_now[0]
    for rnd in range(3):
        if use_local and rnd:
            # Refresh the loose selection at the improved depth: stale
            # selections block depths just propagated from neighbors.
            ncc_xr, _ = exact_all(bd[None])
            sel, sel_valid = _reselect_with_fallback(
                ncc_xr[:, 0], nvalid, bd, ray_world, cam_rel, k,
                min_ncc, min_parallax)
            s_now, k_now = score_exact(bd[None])
            bs, bk = s_now[0], k_now[0]
        cands = torch.stack(
            [_roll(bd, dy, dx) for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0),
                                              (0, 3), (0, -3), (3, 0), (-3, 0))])
        cs, ck = score_exact(cands)
        all_s = torch.cat([bs[None], cs])
        bd, bs, bk = _pick(all_s, torch.cat([bd[None], cands]), all_s,
                           torch.cat([bk[None], ck]))

    # Final STRICT selection at the converged depth for acceptance
    # (local_view_selection.cc success semantics).
    if use_local:
        ncc_xf, _ = exact_all(bd[None])
        sel, sel_valid = _local_view_selection(
            ncc_xf[:, 0], nvalid, bd, ray_world, cam_rel, k,
            min_ncc, min_parallax)
    s_now, k_now = score_exact(bd[None])
    bs, bk = s_now[0], k_now[0]
    # Three parabolic polish rounds: the lookup phase's piecewise-linear
    # scores snap depths to inverse-depth plane nodes (up to ~4-5%
    # relative at the far end of a D=64 table), so the exact polish must
    # be able to move that far.
    for eps in (0.025, 0.01, 0.004):
        d_lo = bd * (1.0 - eps)
        d_hi = bd * (1.0 + eps)
        both, both_k = score_exact(torch.stack([d_lo, d_hi]))
        s_lo, s_hi = both[0], both[1]
        denom = s_lo - 2.0 * bs + s_hi
        offset = torch.where(
            denom < -1e-12,
            torch.clamp(0.5 * (s_lo - s_hi)
                        / torch.where(torch.abs(denom) < 1e-12, -1e-12, denom),
                        -1.0, 1.0),
            0.0)
        cand = bd * (1.0 + offset * eps)
        cs, ck = score_exact(cand[None])
        stack_s = torch.stack([bs, cs[0], s_lo, s_hi])
        bd, bs, bk = _pick(stack_s, torch.stack([bd, cand, d_lo, d_hi]), stack_s,
                           torch.stack([bk, ck[0], both_k[0], both_k[1]]))

    # Output plane slopes from the converged surface: lookup scoring is
    # slope-free (box approximation), so the output estimate is the 3x3
    # box-averaged gradient of the polished depth field.
    cap = 0.05 * torch.clamp(bd, min=1e-6)
    gx = (_roll(bd, 0, -1) - _roll(bd, 0, 1)) * 0.5
    gy = (_roll(bd, -1, 0) - _roll(bd, 1, 0)) * 0.5
    bzx = torch.clamp(_box_sum(gx, 3) * _recip(9.0), -cap, cap)
    bzy = torch.clamp(_box_sum(gy, 3) * _recip(9.0), -cap, cap)

    phase("center_plane")
    # Final CENTER-PLANE acceptance pass: the box NCC used through the
    # solve warps every window tap at that tap's OWN depth-field value,
    # so at depth boundaries taps go invalid and the score collapses — a
    # 1-2px rejection band around every filled region. The reference
    # scores the CENTER pixel's patch plane across the whole window
    # (patch_sampler.cc computePatchPoints + getFastNCC), which stays
    # well-defined right up to the boundary. Re-run per-view NCC with the
    # converged center plane, re-select views on THOSE scores, and accept
    # on the better of the two scores.
    if use_local:
        jidx_all = torch.arange(J, device=dev)[:, None, None, None]

        def gather_all(v0i, u0i):
            return _gather_views(neigh, jidx_all, v0i, u0i)

        def select_and_mean(ncc_p, dd):
            """performVS-on-propagated-pixels selection + acceptance
            mean: any positive-NCC diverse view qualifies (min_ncc gates
            only FRESH candidates in the reference,
            local_view_selection.cc:30-44,78)."""
            sel_f, ok_f = _local_view_selection(
                ncc_p, nvalid, dd, ray_world, cam_rel, k, 0.0, min_parallax)
            sel_ncc = torch.gather(ncc_p, 0, sel_f)
            psk, _ = _combine_sel(sel_ncc, ok_f)
            return psk

        # Box-scored region growing into the band the strict phase could
        # not accept: extrapolate each 4-neighbor's converged plane to
        # this pixel (the reference's processQueue pushes neighbors with
        # the optimized patch as the seed) and keep whichever field scores
        # best under propagation-style view selection.
        shifts4 = ((0, 1), (0, -1), (1, 0), (-1, 0))
        for _ in range(2):
            cd = torch.stack([_roll(bd, dy, dx) + _roll(bzx, dy, dx) * dx
                              + _roll(bzy, dy, dx) * dy for dy, dx in shifts4])
            czx = torch.stack([_roll(bzx, dy, dx) for dy, dx in shifts4])
            czy = torch.stack([_roll(bzy, dy, dx) for dy, dx in shifts4])
            ncc_g, ok_g = exact_all(cd)
            ncc_g = torch.where(ok_g & nvalid[:, None, None, None], ncc_g, -1.0)
            cs = torch.stack([select_and_mean(ncc_g[:, ki], cd[ki])
                              for ki in range(len(shifts4))])
            alls = torch.cat([bs[None], cs])
            bd, bzx, bzy, bs = _pick(alls, torch.cat([bd[None], cd]),
                                     torch.cat([bzx[None], czx]),
                                     torch.cat([bzy[None], czy]), alls)

        # ONE final CENTER-PLANE acceptance pass at the converged plane
        # (patch_sampler.cc getFastNCC).
        ncc_pl, valid_pl = _plane_tap_sums(
            ref, neigh, T[:, None, None, None], tvec[:, None, None, None],
            gather_all, ray_z, bd[None], bzx[None], bzy[None], fw, (J,))
        ncc_pl = torch.where(valid_pl & nvalid[:, None, None, None], ncc_pl, -1.0)[:, 0]
        bs = torch.maximum(bs, select_and_mean(ncc_pl, bd))

    phase("accept")
    # --- confidence + acceptance (patch_optimization.cc:120-142): the
    # reference's score is (MEAN selected NCC - acceptNCC)/(1 - accept).
    conf = torch.clamp((bs - accept_ncc) / (1.0 - accept_ncc), min=0.0)
    normal = _plane_normals(bd, bzx, bzy, ray_world, fw // 2)
    dotp = -_dot3(normal, ray_world)
    conf = torch.where(dotp >= 0.2, conf, 0.0)
    # Master-patch in-bounds requirement (patch_sampler.cc
    # computeMasterSamples): the reference never reconstructs pixels
    # whose window leaves the reference image.
    r_b = fw // 2
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(W, device=dev)[None, :]
    in_master = (yy >= r_b) & (yy < H - r_b) & (xx >= r_b) & (xx < W - r_b)
    conf = torch.where(in_master, conf, 0.0)
    accepted = conf > 0.0
    depth_out = torch.where(accepted, bd, 0.0)
    dz_out = torch.where(accepted[..., None], torch.stack([bzx, bzy], dim=-1), 0.0)
    return depth_out, conf, dz_out, accepted.sum()


def solve_batch_sweep(ref, neigh, nvalid, T, tvec, ray_z,
                      M_ref, M_nei, H_fwd, e3, fB, w0, dw,
                      init_depth, dmin, dmax, ray_world, cam_rel, scalars, *,
                      fw: int, k: int, D: int, n_prop: int, n_refine: int,
                      n_plane_rounds: int, use_local: bool, rect_hw=None):
    """Batched rectified-sweep reconstruction, one view after another on
    the device that holds the inputs.

    Shapes as solver.solve_batch plus per-pair rectification data:
    M_ref/M_nei/H_fwd: (B, J, 3, 3); e3: (B, J, 3); fB/w0/dw: (B, J).
    rect_hw: (Hr, Wr) rect-grid size fitted on the host to cover every
    pair's mapped ref image (rectify_pair rect_wh), or None for the legacy
    grid (H + 2 H//8, W + 2 W//8) of rectify_pair(margin_yx=rect_margins).
    Each view's phases are mvs.solve.<phase> spans (_phase_spans).
    """
    outs = []
    for b in range(ref.shape[0]):
        with _phase_spans(ref.device) as phase:
            outs.append(_solve_view_sweep(
                ref[b], neigh[b], nvalid[b], T[b], tvec[b], ray_z[b], M_ref[b], M_nei[b],
                H_fwd[b], e3[b], fB[b], w0[b], dw[b], init_depth[b], dmin[b], dmax[b],
                ray_world[b], cam_rel[b], scalars, fw=fw, k=k, D=D, n_prop=n_prop,
                n_refine=n_refine, n_plane_rounds=n_plane_rounds, use_local=use_local,
                rect_hw=rect_hw, phase=phase))
    return tuple(torch.stack(x) for x in zip(*outs))


@contextlib.contextmanager
def _phase_spans(device):
    """Yields phase(name), which closes the open span of one view's solve
    and opens mvs.solve.<name>, timed on `device`'s CUDA events (read after
    _run_batch's read-back); the block's end closes the last."""
    with contextlib.ExitStack() as open_span:
        def phase(name):
            open_span.close()
            open_span.enter_context(span(f"mvs.solve.{name}", device=device))
        yield phase
