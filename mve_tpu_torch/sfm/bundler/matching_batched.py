"""All-pairs matching as a few batched device calls (port of
mve_tpu/sfm/bundler/matching_batched.py; sfmrecon's default matcher).

  1. descriptors padded per view to a common row count -> (V, N, D)
  2. every pair's nearest-neighbour search: two launches of the batched
     top-2 kernel (a->b, then b->a), Lowe ratio and the mutual check as
     plain tensor ops on the device -> per-pair match rows
  3. one batched 8-point RANSAC over all pairs -> inlier masks

Semantics equal the per-pair path (same Lowe ratio, two-way
consistency, Sampson threshold); RANSAC samples come from one host
RandomState, drawn pair by pair in mve_tpu's order. The matcher scores
in float32, as mve_tpu's batched matcher does at precision "highest".
The kernel keeps no score matrix, so the matching passes need no pair
chunking; the RANSAC pass is chunked to bound its (pairs, hypotheses,
matches) temporaries.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ... import resolve_device
from ...ops.top2 import top2_pairs
from ...utils.timer import WallTimer
from .. import fundamental as fu
from .common import TwoViewMatching, Viewport
from .matching import MatchingOptions, all_pairs

# Bytes of (pairs x hypotheses x matches) float32 temporaries per RANSAC
# chunk; the Sampson evaluation holds about eight of them.
_RANSAC_CHUNK_BYTES = 1 << 30


def _match_pairs(desc, n_desc, pair_a, pair_b, lowe_sq: float):
    """desc: (V, N, D); n_desc: (V,) int32; pair_a/b: (P,) int32.
    Returns the mutual-match target per (pair, feature of a), -1 for
    none: (P, N) on the device."""
    N = desc.shape[1]
    i12, d12_1, d12_2 = top2_pairs(desc, n_desc, pair_a, pair_b, bf16=False)
    i21, d21_1, d21_2 = top2_pairs(desc, n_desc, pair_b, pair_a, bf16=False)
    ar = torch.arange(N, device=desc.device)
    row_ok = ar[None, :] < n_desc[pair_a.long()][:, None]
    col_ok = ar[None, :] < n_desc[pair_b.long()][:, None]
    ok12 = (d12_1 / torch.clamp(d12_2, min=1e-30) <= lowe_sq) & row_ok
    ok21 = (d21_1 / torch.clamp(d21_2, min=1e-30) <= lowe_sq) & col_ok
    m12 = torch.where(ok12, i12.long(), -1)
    m21 = torch.where(ok21, i21.long(), -1)
    back = torch.gather(m21, 1, torch.clamp(m12, 0, N - 1))
    mutual = (m12 >= 0) & (back == ar[None, :])
    return torch.where(mutual, m12, -1)


def _ransac_pairs(p1, p2, n_matches, sample_idx, threshold_sq: float):
    """Batched RANSAC-F over pairs. p1/p2: (P, M, 2) padded matches;
    n_matches: (P,); sample_idx: (P, H, 8). Returns inlier masks (P, M):
    for every (pair, hypothesis) an 8-point SVD solve and Sampson scoring,
    then the hypothesis with the most inliers (first among equals)."""
    P, M, _ = p1.shape
    H = sample_idx.shape[1]
    out = torch.empty((P, M), dtype=torch.bool, device=p1.device)
    chunk = max(1, _RANSAC_CHUNK_BYTES // (H * M * 4 * 8))
    cols = torch.arange(M, device=p1.device)
    for c0 in range(0, P, chunk):
        pp1, pp2 = p1[c0:c0 + chunk], p2[c0:c0 + chunk]
        sidx = sample_idx[c0:c0 + chunk]
        rows = torch.arange(len(pp1), device=p1.device)
        F = fu.fundamental_8_point(pp1[rows[:, None, None], sidx],
                                   pp2[rows[:, None, None], sidx])   # (p, H, 3, 3)
        d = fu.sampson_distance(F, pp1[:, None], pp2[:, None])      # (p, H, M)
        valid_col = cols[None, :] < n_matches[c0:c0 + chunk][:, None]
        inl = (d < threshold_sq) & valid_col[:, None, :]
        best = torch.argmax(inl.sum(dim=-1), dim=1)
        out[c0:c0 + chunk] = inl[rows, best]
    return out


def _stack_descriptors(blocks, dim: int, device):
    """Per-view descriptor arrays -> (V, N, dim) zero-padded tensor and
    (V,) int32 counts."""
    V = len(blocks)
    nmax = max(max((len(b) for b in blocks), default=1), 1)
    desc = np.zeros((V, nmax, dim), np.float32)
    n_desc = np.zeros(V, np.int32)
    for i, b in enumerate(blocks):
        desc[i, :len(b)] = b
        n_desc[i] = len(b)
    return torch.from_numpy(desc).to(device), torch.from_numpy(n_desc).to(device)


class BatchedMatching:
    """All-pairs matcher; same options and results as bundler.Matching."""

    def __init__(self, options: Optional[MatchingOptions] = None, device="cuda"):
        self.opts = options or MatchingOptions()
        self.device = resolve_device(device)
        # Stage sizes of the last compute(), and its RANSAC times: host
        # sampling (ransac_sample_ms) and the device solve (ransac_ms).
        self.last_stats: dict = {}

    def compute(self, viewports: List[Viewport], seed: int = 0,
                pairs=None) -> List[TwoViewMatching]:
        """pairs: optional explicit (v2, v1) list; default all pairs."""
        opts = self.opts
        dev = self.device
        V = len(viewports)
        rng = np.random.RandomState(seed)
        if pairs is None:
            pairs = all_pairs(V, opts.max_num_pairs_per_view)
        stats = self.last_stats = {"n_pairs": len(pairs)}
        if not pairs:
            return []

        # --- stage 1: nearest-neighbour matching over all pairs
        desc, n_desc = _stack_descriptors([vp.descriptors for vp in viewports], 128, dev)
        stats["sift_bucket"] = desc.shape[1]
        pair_a = torch.tensor([a for a, _ in pairs], dtype=torch.int32, device=dev)
        pair_b = torch.tensor([b for _, b in pairs], dtype=torch.int32, device=dev)
        lowe_sq = opts.lowe_ratio ** 2

        if opts.use_lowres_matching:
            # Low-res prefilter (bundler_matching.cc low-res pass): match
            # only the first num_lowres_features descriptors of every pair;
            # pairs under min_lowres_matches are rejected.
            nl = opts.num_lowres_features
            m_lr = _match_pairs(desc[:, :min(nl, desc.shape[1])].contiguous(),
                                torch.clamp(n_desc, max=nl), pair_a, pair_b, lowe_sq)
            counts = (m_lr >= 0).sum(dim=1).cpu().numpy()
            sel = np.nonzero(counts >= opts.min_lowres_matches)[0]
            if opts.verbose and len(sel) < len(pairs):
                print(f"Low-res matching rejected "
                      f"{len(pairs) - len(sel)} of {len(pairs)} pairs.")
            stats["n_lowres_pairs"] = len(sel)
            pairs = [pairs[k] for k in sel]
            if not pairs:
                return []
            keep_t = torch.from_numpy(sel).to(dev)
            pair_a, pair_b = pair_a[keep_t], pair_b[keep_t]

        m12 = _match_pairs(desc, n_desc, pair_a, pair_b, lowe_sq).cpu().numpy()
        n_sift = n_desc.cpu().numpy()

        # SURF blocks matched separately and merged with offsets.
        surf_sizes = [len(vp.surf_descriptors) for vp in viewports]
        m12_surf = None
        if any(surf_sizes):
            sdesc, sn = _stack_descriptors([vp.surf_descriptors for vp in viewports], 64, dev)
            stats["surf_bucket"] = sdesc.shape[1]
            m12_surf = _match_pairs(sdesc, sn, pair_a, pair_b, 0.7 ** 2).cpu().numpy()

        # --- collect raw matches per pair (host)
        raw = []
        for k, (a, b) in enumerate(pairs):
            row = m12[k][:n_sift[a]]
            i1 = np.nonzero(row >= 0)[0]
            matches = np.stack([i1, row[i1]], axis=1).astype(np.int32)
            if m12_surf is not None and surf_sizes[a] and surf_sizes[b]:
                srow = m12_surf[k][:surf_sizes[a]]
                si = np.nonzero(srow >= 0)[0]
                if len(si):
                    sm = np.stack([si + viewports[a].num_sift,
                                   srow[si] + viewports[b].num_sift], axis=1)
                    matches = np.concatenate([matches, sm.astype(np.int32)])
            raw.append(matches)

        keep = [k for k in range(len(pairs)) if len(raw[k]) >= opts.min_feature_matches]
        stats["n_ransac_pairs"] = len(keep)
        if not keep:
            return []

        # --- stage 2: batched geometric verification
        timer = WallTimer()
        M = max(max(len(raw[k]) for k in keep), 8)
        P = len(keep)
        H = opts.ransac_opts.max_iterations
        p1 = np.zeros((P, M, 2), np.float32)
        p2 = np.zeros((P, M, 2), np.float32)
        nm = np.zeros(P, np.int64)
        sample_idx = np.zeros((P, H, 8), np.int64)
        for j, k in enumerate(keep):
            a, b = pairs[k]
            m = raw[k]
            p1[j, :len(m)] = viewports[a].positions[m[:, 0]]
            p2[j, :len(m)] = viewports[b].positions[m[:, 1]]
            nm[j] = len(m)
            # Unique 8-subsets per hypothesis via random-key argpartition.
            sample_idx[j] = np.argpartition(rng.rand(H, len(m)), 8, axis=1)[:, :8]
        stats["ransac_sample_ms"] = timer.get_elapsed()
        timer.reset()
        inl = _ransac_pairs(
            torch.from_numpy(p1).to(dev), torch.from_numpy(p2).to(dev),
            torch.from_numpy(nm).to(dev), torch.from_numpy(sample_idx).to(dev),
            opts.ransac_opts.threshold ** 2).cpu().numpy()
        stats["ransac_ms"] = timer.get_elapsed()
        stats["ransac_max_matches"] = M

        result = []
        for j, k in enumerate(keep):
            a, b = pairs[k]
            mask = inl[j][:nm[j]]
            if int(mask.sum()) < opts.min_matching_inliers:
                continue
            result.append(TwoViewMatching(a, b, raw[k][mask]))
            if opts.verbose:
                print(f"Pair ({a},{b}): {int(mask.sum())} matches")
        return result
