"""All-pairs geometrically verified matching, one pair at a time
(reference: libs/sfm/bundler_matching.cc; port of
mve_tpu/sfm/bundler/matching.py without cascade hashing).

Per pair: optional low-res prefilter (match the first N descriptors,
reject if < min_lowres_matches), full two-way Lowe matching of SIFT and
of SURF (combined with index offsets past the SIFT block), reject below
min_feature_matches, RANSAC fundamental, reject below
min_matching_inliers. sfmrecon's default matcher is the batched one in
matching_batched.py.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ... import resolve_device
from .. import matching as M
from ..ransac import ransac_fundamental, RansacOptions
from .common import Viewport, TwoViewMatching


@dataclasses.dataclass
class MatchingOptions:
    """bundler_matching.h Options defaults."""

    min_lowres_matches: int = 5
    num_lowres_features: int = 500
    min_feature_matches: int = 24
    min_matching_inliers: int = 12
    use_lowres_matching: bool = False
    max_num_pairs_per_view: int = 0  # 0 = all pairs; >0 = video mode window
    ransac_opts: RansacOptions = dataclasses.field(
        default_factory=lambda: RansacOptions(max_iterations=1000, threshold=0.0015))
    lowe_ratio: float = 0.8
    verbose: bool = False


def all_pairs(n_views: int, max_num_pairs_per_view: int = 0):
    """(v2, v1) for v2 < v1, in the reference's order
    (bundler_matching.cc:59-89); a window > 0 keeps only v1 - v2 <= window."""
    return [(v2, v1) for v1 in range(n_views) for v2 in range(v1)
            if not (max_num_pairs_per_view > 0 and v1 - v2 > max_num_pairs_per_view)]


class Matching:
    def __init__(self, options: Optional[MatchingOptions] = None, device="cuda"):
        self.opts = options or MatchingOptions()
        self.device = resolve_device(device)

    def two_view_matching(self, vp1: Viewport, vp2: Viewport,
                          rng: np.random.RandomState) -> Optional[np.ndarray]:
        """(M, 2) verified matches or None (bundler_matching.cc
        two_view_matching)."""
        opts = self.opts
        dev = self.device
        sift_opts = M.MatchingOptions(lowe_ratio_threshold=opts.lowe_ratio)
        if opts.use_lowres_matching:
            n = opts.num_lowres_features
            lowres = M.match_pair(vp1.descriptors[:n], vp2.descriptors[:n],
                                  sift_opts, dev)
            if len(lowres) < opts.min_lowres_matches:
                return None
        pairs = M.match_pair(vp1.descriptors, vp2.descriptors, sift_opts, dev)
        if len(vp1.surf_descriptors) and len(vp2.surf_descriptors):
            surf_pairs = M.match_pair(
                vp1.surf_descriptors, vp2.surf_descriptors,
                M.MatchingOptions(lowe_ratio_threshold=0.7), dev)
            if len(surf_pairs):
                surf_pairs = surf_pairs + np.array([vp1.num_sift, vp2.num_sift], np.int32)
                pairs = np.concatenate([pairs, surf_pairs]) if len(pairs) else surf_pairs
        if len(pairs) < opts.min_feature_matches:
            return None
        p1 = vp1.positions[pairs[:, 0]]
        p2 = vp2.positions[pairs[:, 1]]
        try:
            result = ransac_fundamental(p1, p2, opts.ransac_opts, rng=rng, device=dev)
        except ValueError:  # fewer than 8 correspondences
            return None
        if len(result.inliers) < opts.min_matching_inliers:
            return None
        return pairs[result.inliers]

    def compute(self, viewports: List[Viewport], seed: int = 0) -> List[TwoViewMatching]:
        """Match all O(N^2/2) pairs (bundler_matching.cc:59-89)."""
        rng = np.random.RandomState(seed)
        result = []
        for a, b in all_pairs(len(viewports), self.opts.max_num_pairs_per_view):
            matches = self.two_view_matching(viewports[a], viewports[b], rng)
            if matches is None:
                continue
            result.append(TwoViewMatching(a, b, matches))
            if self.opts.verbose:
                print(f"Pair ({a},{b}): {len(matches)} matches")
        return result
