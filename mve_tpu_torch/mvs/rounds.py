"""The optimization rounds of a reference view, written once for both
MVS solvers: the warp solver (solver.py) and the rectified sweep solver
(sweep_solver.py).

The reference grows each view from seeds with per-pixel patch
optimization (dmrecon.cc:334-434, patch_optimization.cc); here every
step is a round over all pixels at once: the plane sweep (_sweep_start),
local view selection (_start_selection, local_view_selection.cc
performVS), PatchMatch propagation (_propagate), parabolic refinement
(_refine), slanted-plane rounds with the reference's convergence freeze
(_plane_rounds) and confidence/acceptance (_accept, computeConfidence).
Round counts are fixed and nothing reads a device value, so the host
queues a whole view without waiting. What differs between the solvers
comes in as arguments: score_all(ds) and score_sel(ds, sel, sel_valid)
score a (K, H, W) stack of ray lengths over all neighbors or each
pixel's selected views, plane_score(ds, zxs, zys, sel, sel_valid) a
stack of planes, each returning (score, kth) (K, H, W); reselect(d)
gives (sel, sel_valid). A best is (depth, score, kth), each (H, W).
"""

from __future__ import annotations

import contextlib

import torch

from .patch import _bilinear, _box_ncc, _gather_views, _grid, _shifted, _warp_bilinear
from .patch import _ref_stats as _ref_box_stats  # noqa: F401 (_ncc_box_all's rstats)
from .view_selection import (_cross3, _dot3, _greedy_select, _normalize3,
                             _parallax_weight)
from ..utils.tracing import span


# -----------------------------------------------------------------------
# box NCC of every neighbor (the warp solver's scores, the sweep solver's
# exact polish), local view selection (local_view_selection.cc performVS,
# on relative camera positions, with a neighbor validity mask) and plane
# normals (patch_sampler.cc getPatchNormal)
# -----------------------------------------------------------------------

def _ncc_box_all(ref, rstats, neigh, nvalid, T, tvec, ray_z, depths, fw, neigh_hw=None):
    """Box-NCC of every neighbor for a candidate stack.

    depths: (K, H, W) ray lengths -> (ncc (J, K, H, W), ok (J, K, H, W)).
    neigh_hw: None, or (J, 2) each neighbor's own (height, width) in the
    padded neigh (patch._warp_bilinear).
    """
    H, W = ref.shape
    J = neigh.shape[0]
    mean_r, var_r = rstats
    ys, xs = _grid(H, W, ref.device)
    z = depths * ray_z[None]                                  # (K, H, W)
    u0i, v0i, fu, fv, inb = _warp_bilinear(
        neigh, T[:, None, None, None], tvec[:, None, None, None],
        z[None], xs + 0.5, ys + 0.5,
        None if neigh_hw is None else neigh_hw[:, None, None, None])  # (J, K, H, W)
    jidx = torch.arange(J, device=ref.device)[:, None, None, None]
    nv = _bilinear(lambda v, u: _gather_views(neigh, jidx, v, u), v0i, u0i, fu, fv)
    inb = inb & (depths > 0)[None]
    ncc, full = _box_ncc(ref, mean_r, var_r, nv, inb, fw)
    ok = full & nvalid[:, None, None, None]
    return torch.where(ok, ncc, -1.0), ok


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


def _plane_normals(depth, dzx, dzy, ray_world, r):
    def p(dx, dy):
        L = depth + dx * dzx + dy * dzy
        return L[..., None] * _shifted(ray_world, dy, dx)

    a = p(r, 0) - p(-r, 0)
    b = p(0, -r) - p(0, r)
    return _normalize3(_cross3(a, b), 1e-30)


# -----------------------------------------------------------------------
# candidate folds and phase spans
# -----------------------------------------------------------------------

def _pick(scores, *stacks):
    """Per pixel, the entry of each (K, H, W) stack at argmax(scores) over
    dim 0 (the first on ties: the incumbent stays)."""
    pick = torch.argmax(scores, dim=0)[None]
    return tuple(torch.gather(a, 0, pick)[0] for a in stacks)


# Candidates scored at a time by _chunked_best.
_CHUNK = 8


def _chunked_best(score_fn, cands, best):
    """Fold a candidate stack into the incumbent, _CHUNK at a time.

    cands: (K, H, W); best: (d, s, kth). Peak memory stays at one chunk's
    score tensors regardless of K."""
    K, H, W = cands.shape
    pad = (-K) % _CHUNK
    if pad:
        cands = torch.cat([cands, torch.full((pad, H, W), -1.0, dtype=cands.dtype,
                                             device=cands.device)])
    for ch in cands.reshape(-1, _CHUNK, H, W):
        bd, bs, bk = best
        cs, ck = score_fn(ch)
        best = _pick(torch.cat([bs[None], cs]), torch.cat([bd[None], ch]),
                     torch.cat([bs[None], cs]), torch.cat([bk[None], ck]))
    return best


def _roll(x, dy, dx):
    return torch.roll(x, (dy, dx), (0, 1))


def _f32(values, device):
    return torch.tensor(values, dtype=torch.float32, device=device)


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


# -----------------------------------------------------------------------
# the rounds of one view
# -----------------------------------------------------------------------

def _sweep_start(score_all, init_depth, rel_factors, planes):
    """Plane sweep: the seed field, then a relative fan around it
    (init_depth * f for f in rel_factors) and the constant ray lengths
    `planes` (n,), each kept where it scores better. Returns the best."""
    H, W = init_depth.shape
    s0, k0 = score_all(init_depth[None])
    rel_stack = torch.stack([init_depth * f for f in rel_factors])
    abs_stack = planes[:, None, None].expand(planes.shape[0], H, W)
    return _chunked_best(score_all, torch.cat([rel_stack, abs_stack]),
                         (init_depth, s0[0], k0[0]))


def _start_selection(best, score_all, score_sel, reselect, use_local, k):
    """The local view selection at the swept depth, and the incumbent
    rescored through it. reselect(depth) -> (sel, sel_valid).

    Returns (score_fn, sel, sel_valid, best): score_fn(ds, sel, sel_valid)
    is score_sel, or without use_local score_all, the selection then all
    zeros (k, H, W) and never read."""
    d = best[0]
    if not use_local:
        H, W = d.shape
        sel = torch.zeros((k, H, W), dtype=torch.int64, device=d.device)
        sel_valid = torch.zeros((k, H, W), dtype=torch.bool, device=d.device)
        return (lambda ds, sel, sel_valid: score_all(ds)), sel, sel_valid, best
    sel, sel_valid = reselect(d)
    s1, k1 = score_sel(d[None], sel, sel_valid)
    return score_sel, sel, sel_valid, (d, s1[0], k1[0])


def _propagate(best, score_fn, reselect, sel, sel_valid, n_prop, use_local):
    """PatchMatch propagation: n_prop rounds of the 8 shifted neighbors'
    depths and two perturbations, the selection redone half-way with
    use_local. Returns (best, sel, sel_valid)."""
    shifts = ((0, 1), (0, -1), (1, 0), (-1, 0), (0, 3), (3, 0), (0, -3), (-3, 0))
    eps_prop = _f32([0.05 * (0.5 ** it) for it in range(max(n_prop, 1))], best[0].device)
    half = n_prop // 2
    bd, bs, bk = best
    for it in range(n_prop):
        eps = eps_prop[it]
        if use_local and it == half:
            sel, sel_valid = reselect(bd)
            s2, k2 = score_fn(bd[None], sel, sel_valid)
            bs, bk = s2[0], k2[0]
        cands = torch.stack([_roll(bd, dy, dx) for dy, dx in shifts]
                            + [bd * (1.0 - eps), bd * (1.0 + eps)])
        bd, bs, bk = _chunked_best(
            lambda ds: score_fn(ds, sel, sel_valid), cands, (bd, bs, bk))
    return (bd, bs, bk), sel, sel_valid


def _refine(best, score_fn, sel, sel_valid, n_refine):
    """Parabolic refinement (replaces Gauss-Newton depth steps): n_refine
    steps to the vertex of the parabola through the scores at d(1 -/+
    eps), the vertex and both probes folded into the best."""
    bd, bs, bk = best
    eps_ref = _f32([0.02 * (0.5 ** s) for s in range(max(n_refine, 1))], bd.device)
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
                                   torch.stack([cand, d_lo, d_hi]), (bd, bs, bk))
    return bd, bs, bk


def _plane_rounds(best, plane_score, sel, sel_valid, n_rounds, min_refine_diff,
                  pick_slopes: bool):
    """Joint depth+normal (slanted plane) rounds. Returns (depth, zx, zy,
    score, kth); zero slopes and the best as it came without rounds.

    The first slopes are the current surface's (capped at ~80 deg
    obliquity: steeper planes are degenerate) with the incumbent's score;
    with pick_slopes, the better by plane_score of those and zero slopes.
    Each round folds in the 4 neighbors' planes extrapolated to the pixel,
    slope steps and depth steps."""
    bd, bs, bk = best
    if n_rounds <= 0:
        zeros = torch.zeros_like(bd)
        return bd, zeros, zeros, bs, bk
    dev = bd.device
    slope_cap = 0.05 * torch.clamp(bd, min=1e-6)
    init_zx = torch.clamp((_roll(bd, 0, -1) - _roll(bd, 0, 1)) * 0.5, -slope_cap, slope_cap)
    init_zy = torch.clamp((_roll(bd, -1, 0) - _roll(bd, 1, 0)) * 0.5, -slope_cap, slope_cap)
    if pick_slopes:
        zeros = torch.zeros_like(bd)
        s_pl, k_pl = plane_score(bd[None], zeros[None], zeros[None], sel, sel_valid)
        si, ki = plane_score(bd[None], init_zx[None], init_zy[None], sel, sel_valid)
        better = si[0] > s_pl[0]
        state = (bd,
                 torch.where(better, init_zx, zeros),
                 torch.where(better, init_zy, zeros),
                 torch.where(better, si[0], s_pl[0]),
                 torch.where(better, ki[0], k_pl[0]))
    else:
        state = (bd, init_zx, init_zy, bs, bk)

    eps_pl = _f32([0.3 * (0.5 ** r) for r in range(n_rounds)], dev)
    prev_mean = torch.tensor(-1e31, dtype=torch.float32, device=dev)
    done = torch.tensor(False, device=dev)
    for r in range(n_rounds):
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
        cs, ck = plane_score(ds, zxs, zys, sel, sel_valid)
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
    return state


def _accept(bd, bzx, bzy, bs, ray_world, accept_ncc, fw, allowed=None):
    """Confidence and acceptance (patch_optimization.cc:120-142): the
    reference's score (MEAN selected NCC - acceptNCC) / (1 - acceptNCC),
    zero where the plane faces away from the ray or outside `allowed`
    (H, W) bool. Returns (depth, conf, dz (H, W, 2), number accepted)."""
    conf = torch.clamp((bs - accept_ncc) / (1.0 - accept_ncc), min=0.0)
    normal = _plane_normals(bd, bzx, bzy, ray_world, fw // 2)
    dotp = -_dot3(normal, ray_world)
    conf = torch.where(dotp >= 0.2, conf, 0.0)
    if allowed is not None:
        conf = torch.where(allowed, conf, 0.0)
    accepted = conf > 0.0
    depth_out = torch.where(accepted, bd, 0.0)
    dz_out = torch.where(accepted[..., None], torch.stack([bzx, bzy], dim=-1), 0.0)
    return depth_out, conf, dz_out, accepted.sum()


def _solve_views(solve_view, batched, scalars, **kw):
    """Each view of a batch through solve_view(*views_args, scalars,
    phase=..., **kw), one after another on the device that holds the
    inputs, its phases opened by _phase_spans. batched: the per-view
    arguments, each with the batch on dim 0, or None (passed on as None).
    Returns the outputs stacked."""
    outs = []
    for b in range(batched[0].shape[0]):
        with _phase_spans(batched[0].device) as phase:
            outs.append(solve_view(*(None if a is None else a[b] for a in batched), scalars,
                                   phase=phase, **kw))
    return tuple(torch.stack(x) for x in zip(*outs))
