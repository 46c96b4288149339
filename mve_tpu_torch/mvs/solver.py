"""Batched MVS solver with per-candidate warps (the warp solver): the
whole per-view optimization as one sequence of tensor programs on the
device, one reference view after another.

The reference reconstructs each view with a sequential priority-queue
region grower whose inner loop is per-pixel NCC patch optimization
(libs/dmrecon/dmrecon.cc:334-434, patch_optimization.cc). This module
recasts all stages — plane sweep, per-pixel local view selection
(local_view_selection.cc performVS), PatchMatch propagation, parabolic
refinement, joint depth+normal (slanted plane) rounds with the
reference's convergence rule, and confidence/acceptance
(patch_optimization.cc computeConfidence) — as rounds over every pixel
at once. Round loops are Python loops with a fixed count; nothing in
them reads a device value, so the host queues the whole view without
waiting. The rectified sweep solver (sweep_solver.py) is the default;
views whose neighbor pairs do not rectify come here.

Neighbor sets are padded to a common J with a validity mask.
"""

from __future__ import annotations

import torch

from .patch import (_bilinear, _box_ncc, _combine_sel, _combine_topk, _gather_views,
                    _grid, _plane_tap_sums, _shifted, _warp_bilinear)
from .patch import _ref_stats as _ref_box_stats
from .view_selection import (_cross3, _dot3, _greedy_select, _normalize3,
                             _parallax_weight)


# -----------------------------------------------------------------------
# scoring primitives
# -----------------------------------------------------------------------

def _ncc_box_all(ref, rstats, neigh, nvalid, T, tvec, ray_z, depths, fw):
    """Box-NCC of every neighbor for a candidate stack.

    depths: (K, H, W) ray lengths -> (ncc (J, K, H, W), ok (J, K, H, W)).
    """
    H, W = ref.shape
    J = neigh.shape[0]
    mean_r, var_r = rstats
    ys, xs = _grid(H, W, ref.device)
    z = depths * ray_z[None]                                  # (K, H, W)
    u0i, v0i, fu, fv, inb = _warp_bilinear(
        neigh, T[:, None, None, None], tvec[:, None, None, None],
        z[None], xs + 0.5, ys + 0.5)                          # (J, K, H, W)
    jidx = torch.arange(J, device=ref.device)[:, None, None, None]
    nv = _bilinear(lambda v, u: _gather_views(neigh, jidx, v, u), v0i, u0i, fu, fv)
    inb = inb & (depths > 0)[None]
    ncc, full = _box_ncc(ref, mean_r, var_r, nv, inb, fw)
    ok = full & nvalid[:, None, None, None]
    return torch.where(ok, ncc, -1.0), ok


def _ncc_box_sel(ref, rstats, neigh, T, tvec, ray_z, depths, sel, sel_valid, fw):
    """Box-NCC over per-pixel SELECTED views: (S, K, H, W)."""
    H, W = ref.shape
    mean_r, var_r = rstats
    ys, xs = _grid(H, W, ref.device)
    z = depths * ray_z[None]                                  # (K, H, W)
    u0i, v0i, fu, fv, inb = _warp_bilinear(
        neigh, T[sel][:, None], tvec[sel][:, None], z[None], xs + 0.5, ys + 0.5)
    jidx = sel[:, None]
    nv = _bilinear(lambda v, u: _gather_views(neigh, jidx, v, u), v0i, u0i, fu, fv)
    inb = inb & (depths > 0)[None]
    ncc, full = _box_ncc(ref, mean_r, var_r, nv, inb, fw)
    ok = full & sel_valid[:, None]
    return torch.where(ok, ncc, -1.0), ok


def _ncc_plane_all(ref, neigh, nvalid, T, tvec, ray_z, depths, dzx, dzy, fw, k):
    J = neigh.shape[0]
    jidx = torch.arange(J, device=ref.device)[:, None, None, None]
    ncc, valid = _plane_tap_sums(
        ref, neigh, T[:, None, None, None], tvec[:, None, None, None],
        lambda v, u: _gather_views(neigh, jidx, v, u), ray_z, depths, dzx, dzy, fw, (J,))
    ok = valid & nvalid[:, None, None, None]
    return _combine_topk(torch.where(ok, ncc, -1.0), ok, k)


def _ncc_plane_sel(ref, neigh, T, tvec, ray_z, depths, dzx, dzy,
                   sel, sel_valid, fw):
    S = sel.shape[0]
    jidx = sel[:, None]
    ncc, valid = _plane_tap_sums(
        ref, neigh, T[sel][:, None], tvec[sel][:, None],
        lambda v, u: _gather_views(neigh, jidx, v, u), ray_z,
        depths, dzx, dzy, fw, (S,))
    ok = valid & sel_valid[:, None]
    return _combine_sel(torch.where(ok, ncc, -1.0), ok)


# -----------------------------------------------------------------------
# local view selection (local_view_selection.cc performVS) on relative
# camera positions, with a neighbor validity mask
# -----------------------------------------------------------------------

def _topk_views(ncc, nvalid, k):
    """Per-pixel k best views by raw NCC (no quality/parallax gates).

    The OPTIMIZATION fallback where the strict local view selection
    fails: a pixel whose current depth estimate is wrong has no views
    with NCC >= min_ncc, so the strict selection is empty and every
    candidate would score -1. Scoring through the k least-bad views keeps
    the objective defined everywhere; final ACCEPTANCE still requires a
    strict selection at the converged depth.

    A stable descending sort: on ties the lower view index comes first,
    as jax.lax.top_k orders them (torch.topk promises no order)."""
    masked = torch.where(nvalid[:, None, None], ncc, -1e30)
    vals, idx = torch.sort(masked, dim=0, descending=True, stable=True)
    return idx[:k], vals[:k] > -1e29


def _reselect_with_fallback(ncc, nvalid, depth, ray_world, cam_rel, k,
                            min_ncc, min_parallax):
    """Strict per-pixel view selection, falling back to the k best raw
    NCC views where the strict selection found fewer than k."""
    sel, sel_valid = _local_view_selection(
        ncc, nvalid, depth, ray_world, cam_rel, k, min_ncc, min_parallax)
    loose_sel, loose_valid = _topk_views(ncc, nvalid, k)
    strict_ok = sel_valid.all(dim=0)
    sel = torch.where(strict_ok[None], sel, loose_sel)
    sel_valid = torch.where(strict_ok[None], sel_valid, loose_valid)
    return sel, sel_valid


def _local_view_selection(ncc, nvalid, depth, ray_world, cam_rel, k,
                          min_ncc, min_parallax):
    """Greedy per-pixel selection of k diverse views.

    ncc: (J, H, W); cam_rel: (J, 3) neighbor centers minus the reference
    center. Returns (sel (k, H, W) int64, valid (k, H, W) bool)."""
    p_rel = ray_world * depth[..., None]                  # p - ref_pos
    ref_dir = ray_world
    vd = _normalize3(p_rel[None] - cam_rel[:, None, None, :], 1e-12)   # (J, H, W, 3)
    ep = _normalize3(_cross3(vd, ref_dir[None]), 1e-12)
    w = ncc * _parallax_weight(_dot3(vd, ref_dir[None]))
    w = torch.where(ncc < min_ncc, 0.0, w)
    w = torch.where(nvalid[:, None, None], w, 0.0)
    return _greedy_select(w, vd, ep, k, min_parallax)


# -----------------------------------------------------------------------
# plane normals (patch_sampler.cc getPatchNormal)
# -----------------------------------------------------------------------

def _plane_normals(depth, dzx, dzy, ray_world, r):
    def p(dx, dy):
        L = depth + dx * dzx + dy * dzy
        return L[..., None] * _shifted(ray_world, dy, dx)

    a = p(r, 0) - p(-r, 0)
    b = p(0, -r) - p(0, r)
    return _normalize3(_cross3(a, b), 1e-30)


# -----------------------------------------------------------------------
# the per-view program
# -----------------------------------------------------------------------

def _pick(scores, *stacks):
    """Per pixel, the entry of each (K, H, W) stack at argmax(scores) over
    dim 0 (the first on ties: the incumbent stays)."""
    pick = torch.argmax(scores, dim=0)[None]
    return tuple(torch.gather(a, 0, pick)[0] for a in stacks)


# Candidates scored at a time by _chunked_best.
_CHUNK = 8


def _chunked_best(score_fn, cands, best, chunk):
    """Fold a candidate stack into the incumbent, `chunk` at a time.

    cands: (K, H, W); best: (d, s, kth). Peak memory stays at one chunk's
    score tensors regardless of K."""
    K, H, W = cands.shape
    pad = (-K) % chunk
    if pad:
        cands = torch.cat([cands, torch.full((pad, H, W), -1.0, dtype=cands.dtype,
                                             device=cands.device)])
    for ch in cands.reshape(-1, chunk, H, W):
        bd, bs, bk = best
        cs, ck = score_fn(ch)
        best = _pick(torch.cat([bs[None], cs]), torch.cat([bd[None], ch]),
                     torch.cat([bs[None], cs]), torch.cat([bk[None], ck]))
    return best


def _roll(x, dy, dx):
    return torch.roll(x, (dy, dx), (0, 1))


def _f32(values, device):
    return torch.tensor(values, dtype=torch.float32, device=device)


def _solve_view(ref, neigh, nvalid, T, tvec, ray_z, init_depth, dmin, dmax,
                abs_planes, ray_world, cam_rel, scalars, *,
                fw, k, n_prop, n_refine, n_plane_rounds, use_local, exact,
                rel_factors):
    """One reference view end-to-end on the device. `scalars` = (4,)
    float32 [min_ncc, min_parallax, accept_ncc, min_refine_diff]."""
    H, W = ref.shape
    dev = ref.device
    min_ncc, min_parallax, accept_ncc, min_refine_diff = (
        scalars[0], scalars[1], scalars[2], scalars[3])
    rstats = _ref_box_stats(ref, fw)
    zeros = torch.zeros_like(init_depth)

    if exact:
        # Per-tap warps (the plane kernel at zero slope) — the faithful
        # formulation of the reference's fronto-parallel patches.
        def score_all(ds):
            z0 = torch.zeros_like(ds)
            return _ncc_plane_all(ref, neigh, nvalid, T, tvec, ray_z,
                                  ds, z0, z0, fw, k)
    else:
        def score_all(ds):
            ncc, ok = _ncc_box_all(ref, rstats, neigh, nvalid, T, tvec,
                                   ray_z, ds, fw)
            return _combine_topk(ncc, ok, k)

    def score_sel(ds, sel, sel_valid):
        if exact:
            z0 = torch.zeros_like(ds)
            return _ncc_plane_sel(ref, neigh, T, tvec, ray_z, ds, z0, z0,
                                  sel, sel_valid, fw)
        ncc, ok = _ncc_box_sel(ref, rstats, neigh, T, tvec, ray_z, ds,
                               sel, sel_valid, fw)
        return _combine_sel(ncc, ok)

    # --- plane sweep: relative fan around the init + absolute planes.
    s0, k0 = score_all(init_depth[None])
    best = (init_depth, s0[0], k0[0])
    rel_stack = torch.stack([init_depth * f for f in rel_factors])
    abs_stack = abs_planes[:, None, None].expand(abs_planes.shape[0], H, W)
    best = _chunked_best(score_all, torch.cat([rel_stack, abs_stack]), best, _CHUNK)

    # --- local view selection state
    if use_local:
        def reselect(d):
            ncc, _ = _ncc_box_all(ref, rstats, neigh, nvalid, T, tvec,
                                  ray_z, d[None], fw)
            return _reselect_with_fallback(
                ncc[:, 0], nvalid, d, ray_world, cam_rel, k,
                min_ncc, min_parallax)

        sel, sel_valid = reselect(best[0])
        s1, k1 = score_sel(best[0][None], sel, sel_valid)
        best = (best[0], s1[0], k1[0])
        score_fn = score_sel
    else:
        sel = torch.zeros((k, H, W), dtype=torch.int64, device=dev)
        sel_valid = torch.zeros((k, H, W), dtype=torch.bool, device=dev)

        def score_fn(ds, sel, sel_valid):
            return score_all(ds)

    # --- PatchMatch propagation rounds
    shifts = ((0, 1), (0, -1), (1, 0), (-1, 0), (0, 3), (3, 0), (0, -3), (-3, 0))
    eps_prop = _f32([0.05 * (0.5 ** it) for it in range(max(n_prop, 1))], dev)
    half = n_prop // 2
    bd, bs, bk = best
    for it in range(n_prop):
        eps = eps_prop[it]
        if use_local and it == half:
            sel, sel_valid = reselect(bd)
            s2, k2 = score_sel(bd[None], sel, sel_valid)
            bs, bk = s2[0], k2[0]
        cands = torch.stack([_roll(bd, dy, dx) for dy, dx in shifts]
                            + [bd * (1.0 - eps), bd * (1.0 + eps)])
        bd, bs, bk = _chunked_best(
            lambda ds: score_fn(ds, sel, sel_valid), cands, (bd, bs, bk), _CHUNK)

    # --- parabolic refinement (replaces Gauss-Newton depth steps)
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
        bd, bs, bk = _chunked_best(lambda ds: score_fn(ds, sel, sel_valid),
                                   torch.stack([cand, d_lo, d_hi]), (bd, bs, bk), _CHUNK)

    # --- joint depth+normal (slanted plane) rounds
    def plane_score(ds, zxs, zys):
        if use_local:
            return _ncc_plane_sel(ref, neigh, T, tvec, ray_z, ds, zxs, zys,
                                  sel, sel_valid, fw)
        return _ncc_plane_all(ref, neigh, nvalid, T, tvec, ray_z,
                              ds, zxs, zys, fw, k)

    if n_plane_rounds > 0:
        # Slopes from the current surface, capped at ~80 deg obliquity —
        # steeper planes are degenerate.
        slope_cap = 0.05 * torch.clamp(bd, min=1e-6)
        init_zx = torch.clamp((_roll(bd, 0, -1) - _roll(bd, 0, 1)) * 0.5, -slope_cap, slope_cap)
        init_zy = torch.clamp((_roll(bd, -1, 0) - _roll(bd, 1, 0)) * 0.5, -slope_cap, slope_cap)
        s_pl, k_pl = plane_score(bd[None], zeros[None], zeros[None])
        si, ki = plane_score(bd[None], init_zx[None], init_zy[None])
        better = si[0] > s_pl[0]
        state = (bd,
                 torch.where(better, init_zx, zeros),
                 torch.where(better, init_zy, zeros),
                 torch.where(better, si[0], s_pl[0]),
                 torch.where(better, ki[0], k_pl[0]))

        eps_pl = _f32([0.3 * (0.5 ** r) for r in range(n_plane_rounds)], dev)
        prev_mean = torch.tensor(-1e31, dtype=torch.float32, device=dev)
        done = torch.tensor(False, device=dev)
        for r in range(n_plane_rounds):
            eps = eps_pl[r]
            sd, szx, szy, ss, sk = state
            cap = 0.05 * torch.clamp(sd, min=1e-6)
            step = eps * torch.clamp(sd, min=1e-6) * 0.02

            def clampz(z):
                return torch.clamp(z, -cap, cap)

            cands = []
            for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
                nd = _roll(sd, dy, dx)
                nzx = _roll(szx, dy, dx)
                nzy = _roll(szy, dy, dx)
                cands.append((nd + dx * nzx + dy * nzy, nzx, nzy))
            cands += [
                (sd, clampz(szx + step), szy), (sd, clampz(szx - step), szy),
                (sd, szx, clampz(szy + step)), (sd, szx, clampz(szy - step)),
                (sd - step, szx, szy), (sd + step, szx, szy),
            ]
            ds = torch.stack([c[0] for c in cands])
            zxs = torch.stack([c[1] for c in cands])
            zys = torch.stack([c[2] for c in cands])
            cs, ck = plane_score(ds, zxs, zys)
            all_s = torch.cat([ss[None], cs])
            new_state = _pick(all_s, torch.cat([sd[None], ds]), torch.cat([szx[None], zxs]),
                              torch.cat([szy[None], zys]), all_s,
                              torch.cat([sk[None], ck]))
            mean_s = torch.mean(torch.clamp(new_state[3], min=0.0))
            # Convergence freeze (the reference's deltaNCC < min_refine_diff
            # rule, patch_optimization.cc:218): once improvement stalls,
            # later rounds keep the converged state. The flag stays on the
            # device.
            state = tuple(torch.where(done, old, new) for old, new in zip(state, new_state))
            prev_ok = prev_mean > -1e30
            done = done | (prev_ok & (mean_s - prev_mean < min_refine_diff))
            prev_mean = torch.where(done, prev_mean, mean_s)
        bd, bzx, bzy, bs, bk = state
    else:
        bzx, bzy = zeros, zeros

    bd = torch.clamp(bd, dmin * 0.5, dmax * 2.0)

    # --- final STRICT view selection at the converged depth: acceptance
    # keeps the reference's semantics — a pixel needs a successful local
    # view selection of k quality views (local_view_selection.cc success).
    if use_local:
        ncc_f, _ = _ncc_box_all(ref, rstats, neigh, nvalid, T, tvec,
                                ray_z, bd[None], fw)
        sel, sel_valid = _local_view_selection(
            ncc_f[:, 0], nvalid, bd, ray_world, cam_rel, k,
            min_ncc, min_parallax)
        s_f, k_f = plane_score(bd[None], bzx[None], bzy[None])
        bs, bk = s_f[0], k_f[0]

    # --- confidence + acceptance (patch_optimization.cc:120-142): gate
    # on the MEAN selected NCC like the reference.
    conf = torch.clamp((bs - accept_ncc) / (1.0 - accept_ncc), min=0.0)
    normal = _plane_normals(bd, bzx, bzy, ray_world, fw // 2)
    dotp = -_dot3(normal, ray_world)
    conf = torch.where(dotp >= 0.2, conf, 0.0)
    accepted = conf > 0.0
    depth_out = torch.where(accepted, bd, 0.0)
    dz_out = torch.where(accepted[..., None], torch.stack([bzx, bzy], dim=-1), 0.0)
    return depth_out, conf, dz_out, accepted.sum()


def solve_batch(ref, neigh, nvalid, T, tvec, ray_z, init_depth, dmin, dmax,
                abs_planes, ray_world, cam_rel, scalars, *,
                fw: int, k: int, n_prop: int, n_refine: int,
                n_plane_rounds: int, use_local: bool, exact: bool,
                rel_factors: tuple):
    """Reconstruct a batch of reference views, one after another on the
    device that holds the inputs.

    ref: (B, H, W); neigh: (B, J, Hn, Wn) padded; nvalid: (B, J);
    T: (B, J, 3, 3); tvec: (B, J, 3); ray_z/init_depth: (B, H, W);
    dmin/dmax: (B,); abs_planes: (B, n_abs); ray_world: (B, H, W, 3);
    cam_rel: (B, J, 3); scalars: (4,) [min_ncc, min_parallax, accept_ncc,
    min_refine_diff].
    Returns (depth (B, H, W), conf (B, H, W), dz (B, H, W, 2),
    n_accepted (B,)).
    """
    outs = [_solve_view(ref[b], neigh[b], nvalid[b], T[b], tvec[b], ray_z[b],
                        init_depth[b], dmin[b], dmax[b], abs_planes[b],
                        ray_world[b], cam_rel[b], scalars, fw=fw, k=k,
                        n_prop=n_prop, n_refine=n_refine,
                        n_plane_rounds=n_plane_rounds, use_local=use_local,
                        exact=exact, rel_factors=rel_factors)
            for b in range(ref.shape[0])]
    return tuple(torch.stack(x) for x in zip(*outs))
