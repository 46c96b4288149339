"""Feature matching with Lowe ratio + two-way consistency
(reference: libs/sfm/matching.h:22-146, matching.cc; port of
mve_tpu/sfm/matching.py).

oneway_match -> twoway_match -> remove_inconsistent_matches keep the
reference's semantics. The nearest-neighbour search runs through
ops/top2.top2: on a CUDA device the hand-written kernel, in bf16 where
D % 128 == 0 and in float32 otherwise (mve_tpu sends only such widths to
its bf16 Pallas kernel on its accelerator and scores 64-D SURF in
float32), on the CPU the plain float32 version (mve_tpu's CPU path).

Unlike mve_tpu's Pallas path, reference rows are masked by count on
both devices, never seen as zero vectors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..ops.top2 import top2


@dataclasses.dataclass
class MatchingOptions:
    """matching.h Options; defaults from matching_base.h:28-31 (SIFT)."""

    lowe_ratio_threshold: float = 0.8
    distance_threshold: float = float("inf")


@dataclasses.dataclass
class MatchingResult:
    """matching.h Result: per-element target index, -1 if unmatched."""

    matches_1_2: np.ndarray
    matches_2_1: np.ndarray


def use_bf16(device: torch.device, d: int) -> bool:
    """bf16 scoring for width d on device: a CUDA device and d % 128 == 0,
    as mve_tpu/sfm/matching.py:60 picks its bf16 Pallas kernel."""
    return device.type == "cuda" and d % 128 == 0


def oneway_match(opts: MatchingOptions, set1: np.ndarray, set2: np.ndarray,
                 device="cuda") -> np.ndarray:
    """Match each descriptor of set1 into set2 (matching.h:115-146)."""
    dev = resolve_device(device)
    n1, n2 = len(set1), len(set2)
    if n1 == 0 or n2 == 0:
        return np.full(n1, -1, np.int32)
    q = torch.from_numpy(np.ascontiguousarray(set1, np.float32)).to(dev)
    r = torch.from_numpy(np.ascontiguousarray(set2, np.float32)).to(dev)
    idx, d1, d2 = (t.cpu().numpy() for t in top2(q, r, n2, bf16=use_bf16(dev, q.shape[1])))
    sq_lowe = opts.lowe_ratio_threshold**2
    sq_dist = opts.distance_threshold**2 if np.isfinite(opts.distance_threshold) else np.inf
    ok = (d1 <= sq_dist) & (d1 / np.maximum(d2, 1e-30) <= sq_lowe)
    return np.where(ok, idx, -1).astype(np.int32)


def twoway_match(opts: MatchingOptions, set1: np.ndarray, set2: np.ndarray,
                 device="cuda") -> MatchingResult:
    return MatchingResult(
        matches_1_2=oneway_match(opts, set1, set2, device),
        matches_2_1=oneway_match(opts, set2, set1, device),
    )


def remove_inconsistent_matches(result: MatchingResult) -> None:
    """Keep only mutual best matches (matching.cc remove_inconsistent)."""
    m12, m21 = result.matches_1_2, result.matches_2_1
    idx1 = np.arange(len(m12))
    ok12 = (m12 >= 0) & (m21[np.clip(m12, 0, max(len(m21) - 1, 0))] == idx1)
    result.matches_1_2 = np.where(ok12, m12, -1).astype(np.int32)
    idx2 = np.arange(len(m21))
    ok21 = (m21 >= 0) & (m12[np.clip(m21, 0, max(len(m12) - 1, 0))] == idx2)
    result.matches_2_1 = np.where(ok21, m21, -1).astype(np.int32)


def count_consistent_matches(result: MatchingResult) -> int:
    m12, m21 = result.matches_1_2, result.matches_2_1
    idx1 = np.arange(len(m12))
    valid = m12 >= 0
    return int(np.sum(valid & (m21[np.clip(m12, 0, max(len(m21) - 1, 0))] == idx1)))


def combine_results(sift_result: MatchingResult, surf_result: MatchingResult,
                    sift_offset_2: int, surf_offset_1: int, surf_offset_2: int) -> MatchingResult:
    """Concatenate SIFT and SURF matching results into one index space
    (matching.cc combine_results; SURF indices are shifted past SIFT)."""
    m12 = np.concatenate([
        np.where(sift_result.matches_1_2 >= 0, sift_result.matches_1_2, -1),
        np.where(surf_result.matches_1_2 >= 0, surf_result.matches_1_2 + sift_offset_2, -1),
    ]).astype(np.int32)
    m21 = np.concatenate([
        np.where(sift_result.matches_2_1 >= 0, sift_result.matches_2_1, -1),
        np.where(surf_result.matches_2_1 >= 0, surf_result.matches_2_1 + surf_offset_1, -1),
    ]).astype(np.int32)
    return MatchingResult(m12, m21)


def match_pair(set1: np.ndarray, set2: np.ndarray,
               opts: MatchingOptions = MatchingOptions(),
               device="cuda") -> np.ndarray:
    """Consistent matches as an (M, 2) index array."""
    result = twoway_match(opts, set1, set2, device)
    remove_inconsistent_matches(result)
    i1 = np.nonzero(result.matches_1_2 >= 0)[0]
    return np.stack([i1, result.matches_1_2[i1]], axis=1).astype(np.int32)
