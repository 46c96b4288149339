"""Descriptor nearest-neighbour ops, plain PyTorch versions (reference:
libs/sfm/nearest_neighbor.cc; port of mve_tpu/ops/matching.py).

Max inner product against a reference set: scores = Q @ R^T with a top-2
reduction per query row. For unit-length descriptors the squared L2
distance is 2 - 2*dot (nearest_neighbor.h:20-45).

These store the full score matrix. They are what a CPU tensor runs and
what the CUDA kernel in csrc/top2.cu (wrapped by ops/top2.py) is held
against; the kernel computes the same function without that matrix.
"""

from __future__ import annotations

import math

import torch


def _scores(query, refs, use_bf16: bool):
    if use_bf16:
        # bf16 inputs, float32 accumulation: bf16 products are exact in
        # float32, so rounding the inputs and multiplying in float32 is it.
        query = query.to(torch.bfloat16).to(torch.float32)
        refs = refs.to(torch.bfloat16).to(torch.float32)
    return torch.matmul(query, refs.transpose(-1, -2))


def _top2_rows(scores):
    """(…, N2) -> best index (first among equals), best, second best."""
    if scores.shape[-1] == 0:
        inf = torch.full(scores.shape[:-1], -math.inf, dtype=scores.dtype,
                         device=scores.device)
        return torch.zeros(scores.shape[:-1], dtype=torch.int64,
                           device=scores.device), inf, inf
    best = torch.max(scores, dim=-1).values
    idx1 = torch.argmax(scores, dim=-1)
    cols = torch.arange(scores.shape[-1], device=scores.device)
    scores2 = torch.where(cols == idx1[..., None], -math.inf, scores)
    second = torch.max(scores2, dim=-1).values
    return idx1, best, second


def descriptor_top2(query, refs, n_query=None, n_refs=None, use_bf16: bool = False):
    """Top-2 nearest neighbours by max inner product.

    query: (N1, D), refs: (N2, D); reference rows at or past n_refs are
    padding and never chosen (n_query is accepted for mve_tpu's signature;
    padded query rows are computed and left to the caller).
    Returns (idx1 int32, dist1, dist2): best index and the squared L2
    distances of best and second best (dist^2 = 2 - 2 dot).
    """
    scores = _scores(query, refs, use_bf16)
    if n_refs is not None:
        col_ok = torch.arange(refs.shape[0], device=refs.device) < n_refs
        scores = torch.where(col_ok[None, :], scores, -math.inf)
    idx1, best, second = _top2_rows(scores)
    return idx1.to(torch.int32), 2.0 - 2.0 * best, 2.0 - 2.0 * second


# Bytes of score matrices the pair version holds at once.
_PAIR_SCORE_BYTES = 1 << 29


def descriptor_top2_pairs(desc, n_desc, pair_a, pair_b, use_bf16: bool = False):
    """descriptor_top2 for every pair p: desc[pair_a[p]] against
    desc[pair_b[p]], reference rows masked at n_desc[pair_b[p]].

    desc: (V, N, D); n_desc: (V,); pair_a/pair_b: (P,).
    Returns (idx int32, dist1, dist2), each (P, N).
    """
    V, N, D = desc.shape
    P = pair_a.shape[0]
    idx = torch.empty((P, N), dtype=torch.int32, device=desc.device)
    d1 = torch.empty((P, N), dtype=torch.float32, device=desc.device)
    d2 = torch.empty((P, N), dtype=torch.float32, device=desc.device)
    cols = torch.arange(N, device=desc.device)
    chunk = max(1, _PAIR_SCORE_BYTES // max(N * N * 4, 1))
    for c0 in range(0, P, chunk):
        pa = pair_a[c0:c0 + chunk].long()
        pb = pair_b[c0:c0 + chunk].long()
        scores = _scores(desc[pa], desc[pb], use_bf16)          # (p, N, N)
        col_ok = cols[None, :] < n_desc[pb].long()[:, None]
        scores = torch.where(col_ok[:, None, :], scores, -math.inf)
        i1, best, second = _top2_rows(scores)
        idx[c0:c0 + chunk] = i1.to(torch.int32)
        d1[c0:c0 + chunk] = 2.0 - 2.0 * best
        d2[c0:c0 + chunk] = 2.0 - 2.0 * second
    return idx, d1, d2
