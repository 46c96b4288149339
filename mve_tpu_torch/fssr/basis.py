"""FSSR basis/weight evaluation over influence pairs, on the device
(reference: libs/fssr/basis_function.h:23-71, basis_function.cc; port of
mve_tpu/fssr/basis.py, the pair-list evaluator behind
MVE_TPU_FSSR_PAIRWISE=1).

The basis is a Gaussian derivative along the sample normal:
    f(d) = <d, n> exp(-|d|^2 / 2 s^2) / (2 pi s^4)
and the weight function is radially symmetric with support 3s:
    w(q) = 1 - 2/3 q + 8/27 q^{3/2} - 1/27 q^2,  q = |d|^2/s^2 < 9.
Both are symmetric around the normal axis, so the evaluation reduces to
dot products: one elementwise program over the influence pairs, then a
sum per voxel. Derivatives are the analytic world-space gradients (the
reference's weight derivative divides by `scale` once,
basis_function.h:147-152, where the chain rule gives 1/scale^2; mve_tpu
and the port use the consistent form).

Per-voxel sums: mve_tpu uses jax.ops.segment_sum, which XLA's CPU backend
adds in index order. On CUDA, index_add_ adds with atomics, in an order
that changes from run to run; here the pairs are sorted by voxel first
and each voxel's run is summed in order (torch.segment_reduce), so two
runs on the card are bit-identical.
"""

from __future__ import annotations

import math

import torch

__all__ = ["evaluate_pairs", "evaluate_pairs_indexed", "scale_filter_pairs",
           "evaluate_pairs_masked"]


def _stack(out) -> torch.Tensor:
    """(P, 10) per-pair contributions [vw, w, cw, sw, dvw(3), c(3)]."""
    return torch.cat([out["vw"][:, None], out["w"][:, None], out["cw"][:, None],
                      out["sw"][:, None], out["dvw"], out["c"]], dim=1)


def _segment_sum_sorted(values: torch.Tensor, seg: torch.Tensor,
                        num_segments: int) -> torch.Tensor:
    """(num_segments, ...) sums of the rows of `values` per segment id;
    `seg` is non-decreasing and below num_segments, and each segment is
    summed in row order (deterministic on every device)."""
    lengths = torch.bincount(seg, minlength=num_segments)
    return torch.segment_reduce(values, "sum", lengths=lengths, initial=0.0)


def evaluate_pairs(voxel_pos, sample_pos, sample_normal, sample_scale,
                   sample_conf, sample_color) -> dict:
    """Evaluate basis*weight contributions for influence pairs.

    All inputs are per-pair float32 tensors: voxel_pos (P,3) the voxel
    position of the pair, sample_* the paired sample attributes. Returns
    a dict of per-pair contributions ready for summing per voxel:
      vw   = f * w * conf
      w    = w * conf
      dvw  = grad(f w) * conf      (P, 3)
      dw   = grad(w) * conf        (P, 3)
      cw   = color weight (normalized gaussian at s/5 * conf)
      c    = color * cw            (P, 3)
      sw   = scale * cw
    """
    d = voxel_pos - sample_pos  # (P, 3)
    s = sample_scale
    s2 = s * s
    # The three-term sums are written out, in block_eval.py's order: a
    # reduction kernel may add them in another order on each device, and
    # at the rim of the weight (q near 9, where w(q) cancels to +-4e-7)
    # the last bit decides the sign of a voxel's confidence.
    dist2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    n = sample_normal
    x = d[:, 0] * n[:, 0] + d[:, 1] * n[:, 1] + d[:, 2] * n[:, 2]  # along the normal

    g = torch.exp(-dist2 / (2.0 * s2))
    value_norm = 2.0 * math.pi * s2 * s2
    f = x * g / value_norm

    q = dist2 / s2
    inside = q < 9.0
    sq = torch.sqrt(torch.clamp(q, min=0.0))
    zero = torch.zeros_like(q)
    w = torch.where(inside, 1.0 - (2.0 / 3.0) * q + (8.0 / 27.0) * q * sq
                    - (1.0 / 27.0) * q * q, zero)

    # grad f = g/(norm s^2) * ((s^2 - x^2) n - x (d - x n))
    d_perp = d - x[..., None] * sample_normal
    grad_f = (g / (value_norm * s2))[..., None] * (
        (s2 - x * x)[..., None] * sample_normal - x[..., None] * d_perp)
    # grad w = w'(q) * 2 d / s^2, w' = -2/3 + 4/9 sqrt(q) - 2/27 q
    wprime = -2.0 / 3.0 + (4.0 / 9.0) * sq - (2.0 / 27.0) * q
    grad_w = torch.where(inside[..., None], (2.0 * wprime / s2)[..., None] * d,
                         torch.zeros_like(d))

    conf = sample_conf
    vw = f * w * conf
    wc = w * conf
    dvw = (grad_f * w[..., None] + grad_w * f[..., None]) * conf[..., None]
    dw = grad_w * conf[..., None]

    # Colour accumulation (iso_octree.cc:152-158): normalised gaussian
    # with sigma = scale/5.
    sigma_c = s / 5.0
    cw = torch.exp(-dist2 / (2.0 * sigma_c * sigma_c)) / (
        sigma_c * math.sqrt(2.0 * math.pi)) * conf
    return {
        "vw": vw, "w": wc, "dvw": dvw, "dw": dw,
        "cw": cw, "c": sample_color * cw[..., None], "sw": s * cw,
    }


def evaluate_pairs_indexed(positions, pos, normal, scale, conf, color,
                           pair_v, pair_s, num_segments: int) -> torch.Tensor:
    """Gather the pairs' operands on the device, evaluate, and sum per
    voxel: (num_segments, 10) sums [vw, w, cw, sw, dvw(3), c(3)].

    positions (V, 3); sample arrays (N, ...); pair_v/pair_s (P,) int64 in
    any order (mve_tpu passes a (V,)-shaped array to fix the segment count
    under jit; here it is the int). The pairs are sorted by voxel, stably,
    before the sums."""
    order = torch.sort(pair_v, stable=True).indices
    pv, ps = pair_v[order], pair_s[order]
    out = evaluate_pairs(positions[pv], pos[ps], normal[ps], scale[ps], conf[ps], color[ps])
    return _segment_sum_sorted(_stack(out), pv, num_segments)


def scale_filter_pairs(scale, pair_v, pair_s, num_voxels: int):
    """Per-voxel scale filter on the device (iso_octree.cc:104-112): sort
    the influence pairs by (voxel, sample scale) and mark the pairs whose
    scale exceeds 2x the voxel's 10th-percentile (index count//10)
    influencing scale. Padded pairs carry pair_v == num_voxels and sort to
    the end of their (last) segment with an infinite key.

    mve_tpu sorts with lax.sort on two keys, which is not stable, so the
    order of pair_s among equal keys is free there; the port sorts
    lexicographically and stably (by scale, then stably by voxel), so
    equal keys keep the order of the given pair list. The keep mask of
    each (voxel, sample) pair is the same either way.

    Returns (sorted_pair_v, sorted_pair_s, keep_mask), all (Pb,)."""
    Vb = num_voxels
    pscale = scale[pair_s]
    key_scale = torch.where(pair_v >= Vb, torch.full_like(pscale, float("inf")), pscale)
    by_scale = torch.sort(key_scale, stable=True).indices
    order = by_scale[torch.sort(pair_v[by_scale], stable=True).indices]
    s_pv, ss, s_ps = pair_v[order], key_scale[order], pair_s[order]
    counts = torch.bincount(s_pv, minlength=Vb + 1)
    starts = torch.cumsum(counts, 0) - counts
    nth = torch.minimum(torch.maximum(starts + counts // 10, starts),
                        starts + torch.clamp(counts - 1, min=0))
    thresh = 2.0 * ss[torch.clamp(nth, 0, ss.shape[0] - 1)]
    keep = (ss <= thresh[s_pv]) & (s_pv < Vb)
    return s_pv, s_ps, keep


def evaluate_pairs_masked(positions, pos, normal, scale, conf, color,
                          pair_v, pair_s, keep) -> torch.Tensor:
    """Evaluate one fixed-size chunk of influence pairs, sorted by voxel
    (as scale_filter_pairs returns them), and sum per voxel, with the
    masked-out (scale-filtered or padding) pairs zeroed.

    positions (Vb, 3); sample arrays (Nb, ...); chunk arrays (CHUNK,);
    padding pairs carry pair_v == Vb and land in a row that is dropped.
    Returns (Vb, 10) sums [vw, w, cw, sw, dvw(3), c(3)]."""
    Vb = positions.shape[0]
    vpos = positions[torch.clamp(pair_v, max=Vb - 1)]
    out = evaluate_pairs(vpos, pos[pair_s], normal[pair_s], scale[pair_s],
                         conf[pair_s], color[pair_s])
    flat = _stack(out)
    flat = torch.where(keep[:, None], flat, torch.zeros_like(flat))
    return _segment_sum_sorted(flat, torch.clamp(pair_v, max=Vb), Vb + 1)[:Vb]
