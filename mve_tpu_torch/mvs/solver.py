"""Batched MVS solver with per-candidate warps (the warp solver): the
whole per-view optimization as one sequence of tensor programs on the
device, one reference view after another.

The reference reconstructs each view with a sequential priority-queue
region grower whose inner loop is per-pixel NCC patch optimization
(libs/dmrecon/dmrecon.cc:334-434, patch_optimization.cc). Both solvers
recast it as the rounds of rounds.py over every pixel at once; this one
scores each candidate by warping the window into every neighbor: box NCC
(or, with exact, the per-tap plane kernel at zero slope) for depths, the
per-tap plane kernel for the slanted-plane rounds. The rectified sweep
solver (sweep_solver.py) is the default; views whose neighbor pairs do
not rectify come here.

Neighbor sets are padded to a common J with a validity mask. Each view's
phases are mvs.solve.warp_<phase> spans (rounds._phase_spans).
"""

from __future__ import annotations

import torch

from .patch import (_bilinear, _box_ncc, _combine_sel, _combine_topk, _gather_views,
                    _grid, _plane_tap_sums, _warp_bilinear, ncc_score_plane_sel)
from .rounds import (_accept, _local_view_selection, _ncc_box_all, _plane_rounds,
                     _propagate, _ref_box_stats, _refine, _reselect_with_fallback,
                     _solve_views, _start_selection, _sweep_start)


# -----------------------------------------------------------------------
# scoring primitives
# -----------------------------------------------------------------------

def _ncc_box_sel(ref, rstats, neigh, T, tvec, ray_z, depths, sel, sel_valid, fw,
                 neigh_hw=None):
    """Box-NCC over per-pixel SELECTED views: (S, K, H, W). neigh_hw: as
    rounds._ncc_box_all's."""
    H, W = ref.shape
    mean_r, var_r = rstats
    ys, xs = _grid(H, W, ref.device)
    z = depths * ray_z[None]                                  # (K, H, W)
    u0i, v0i, fu, fv, inb = _warp_bilinear(
        neigh, T[sel][:, None], tvec[sel][:, None], z[None], xs + 0.5, ys + 0.5,
        None if neigh_hw is None else neigh_hw[sel][:, None])
    jidx = sel[:, None]
    nv = _bilinear(lambda v, u: _gather_views(neigh, jidx, v, u), v0i, u0i, fu, fv)
    inb = inb & (depths > 0)[None]
    ncc, full = _box_ncc(ref, mean_r, var_r, nv, inb, fw)
    ok = full & sel_valid[:, None]
    return torch.where(ok, ncc, -1.0), ok


def _ncc_plane_all(ref, neigh, nvalid, T, tvec, ray_z, depths, dzx, dzy, fw, k,
                   neigh_hw=None):
    jidx = torch.arange(neigh.shape[0], device=ref.device)[:, None, None, None]
    ncc, valid = _plane_tap_sums(ref, neigh, T, tvec, neigh_hw, jidx, ray_z,
                                 depths, dzx, dzy, fw)
    ok = valid & nvalid[:, None, None, None]
    return _combine_topk(torch.where(ok, ncc, -1.0), ok, k)


# -----------------------------------------------------------------------
# the per-view program
# -----------------------------------------------------------------------

def _solve_view(ref, neigh, nvalid, T, tvec, ray_z, init_depth, dmin, dmax,
                abs_planes, ray_world, cam_rel, neigh_hw, scalars, *,
                fw, k, n_prop, n_refine, n_plane_rounds, use_local, exact,
                rel_factors, phase):
    """One reference view end-to-end on the device. `scalars` = (4,)
    float32 [min_ncc, min_parallax, accept_ncc, min_refine_diff];
    neigh_hw: (J, 2) the neighbors' own sizes in the padded neigh, or
    None where each fills it.
    phase(name): called at each phase's start (see rounds._phase_spans)."""
    min_ncc, min_parallax, accept_ncc, min_refine_diff = scalars
    rstats = _ref_box_stats(ref, fw)

    def plane_score(ds, zxs, zys, sel, sel_valid):
        if not use_local:
            return _ncc_plane_all(ref, neigh, nvalid, T, tvec, ray_z, ds, zxs, zys, fw, k,
                                  neigh_hw)
        return ncc_score_plane_sel(ref, neigh, T, tvec, ray_z, ds, zxs, zys,
                                   sel, sel_valid, fw, neigh_hw)

    if exact:
        # Per-tap warps (the plane kernel at zero slope) — the faithful
        # formulation of the reference's fronto-parallel patches.
        def score_all(ds):
            z0 = torch.zeros_like(ds)
            return _ncc_plane_all(ref, neigh, nvalid, T, tvec, ray_z, ds, z0, z0, fw, k,
                                  neigh_hw)

        def score_sel(ds, sel, sel_valid):
            z0 = torch.zeros_like(ds)
            return ncc_score_plane_sel(ref, neigh, T, tvec, ray_z, ds, z0, z0,
                                       sel, sel_valid, fw, neigh_hw)
    else:
        def score_all(ds):
            ncc, ok = _ncc_box_all(ref, rstats, neigh, nvalid, T, tvec, ray_z, ds, fw,
                                   neigh_hw)
            return _combine_topk(ncc, ok, k)

        def score_sel(ds, sel, sel_valid):
            ncc, ok = _ncc_box_sel(ref, rstats, neigh, T, tvec, ray_z, ds,
                                   sel, sel_valid, fw, neigh_hw)
            return _combine_sel(ncc, ok)

    def box_all(d):
        ncc, _ = _ncc_box_all(ref, rstats, neigh, nvalid, T, tvec, ray_z, d[None], fw,
                              neigh_hw)
        return ncc[:, 0]

    def reselect(d):
        return _reselect_with_fallback(box_all(d), nvalid, d, ray_world, cam_rel, k,
                                       min_ncc, min_parallax)

    phase("warp_sweep")
    best = _sweep_start(score_all, init_depth, rel_factors, abs_planes)

    phase("warp_propagate")
    score_fn, sel, sel_valid, best = _start_selection(best, score_all, score_sel,
                                                      reselect, use_local, k)
    best, sel, sel_valid = _propagate(best, score_fn, reselect, sel, sel_valid,
                                      n_prop, use_local)

    phase("warp_refine")
    best = _refine(best, score_fn, sel, sel_valid, n_refine)

    phase("warp_plane")
    bd, bzx, bzy, bs, _ = _plane_rounds(best, plane_score, sel, sel_valid, n_plane_rounds,
                                        min_refine_diff, pick_slopes=True)

    phase("warp_accept")
    bd = torch.clamp(bd, dmin * 0.5, dmax * 2.0)
    # Final STRICT view selection at the converged depth: acceptance
    # keeps the reference's semantics — a pixel needs a successful local
    # view selection of k quality views (local_view_selection.cc success).
    if use_local:
        sel, sel_valid = _local_view_selection(box_all(bd), nvalid, bd, ray_world, cam_rel,
                                               k, min_ncc, min_parallax)
        bs = plane_score(bd[None], bzx[None], bzy[None], sel, sel_valid)[0][0]
    return _accept(bd, bzx, bzy, bs, ray_world, accept_ncc, fw)


def solve_batch(ref, neigh, nvalid, T, tvec, ray_z, init_depth, dmin, dmax,
                abs_planes, ray_world, cam_rel, scalars, *,
                fw: int, k: int, n_prop: int, n_refine: int,
                n_plane_rounds: int, use_local: bool, exact: bool,
                rel_factors: tuple, neigh_hw=None):
    """Reconstruct a batch of reference views, one after another on the
    device that holds the inputs.

    ref: (B, H, W); neigh: (B, J, Hn, Wn) padded; nvalid: (B, J);
    neigh_hw: None, or (B, J, 2) float each neighbor's own (height, width)
    inside the padding: its taps outside that are out of bounds (None:
    every neighbor fills (Hn, Wn));
    T: (B, J, 3, 3); tvec: (B, J, 3); ray_z/init_depth: (B, H, W);
    dmin/dmax: (B,); abs_planes: (B, n_abs); ray_world: (B, H, W, 3);
    cam_rel: (B, J, 3); scalars: (4,) [min_ncc, min_parallax, accept_ncc,
    min_refine_diff].
    Returns (depth (B, H, W), conf (B, H, W), dz (B, H, W, 2),
    n_accepted (B,)).
    Each view's phases are mvs.solve.warp_<phase> spans (rounds._phase_spans).
    """
    return _solve_views(
        _solve_view, (ref, neigh, nvalid, T, tvec, ray_z, init_depth, dmin, dmax,
                      abs_planes, ray_world, cam_rel, neigh_hw), scalars,
        fw=fw, k=k, n_prop=n_prop, n_refine=n_refine, n_plane_rounds=n_plane_rounds,
        use_local=use_local, exact=exact, rel_factors=rel_factors)
