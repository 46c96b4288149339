"""Initial pair selection (reference: libs/sfm/bundler_init_pair.cc).

Candidates are pairs sharing tracks, sorted by match count descending.
The first pair passing: >= min matches, homography-inlier fraction below
threshold, valid 8-point pose, median triangulation angle above threshold
and >=50% successful triangulations wins; otherwise the best-scoring pair
(logistic score product, bundler_init_pair.cc:317-333).

Port of mve_tpu/sfm/bundler/init_pair.py: the homography RANSAC and the
N-point F -> E -> pose solve run as tensor ops on the given device, the
rest is host numpy, as in mve_tpu.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ... import resolve_device
from .. import fundamental as fu
from ..pose import CameraPose
from ..ransac import ransac_homography, RansacOptions
from ..triangulate import triangulate_match, TriangulateOptions
from .common import Track, Viewport


@dataclasses.dataclass
class InitialPairOptions:
    """bundler_init_pair.h:117-123 defaults."""

    max_homography_inliers: float = 0.6
    min_num_matches: int = 50
    min_triangulation_angle: float = np.deg2rad(5.0)
    homography_opts: RansacOptions = dataclasses.field(
        default_factory=lambda: RansacOptions(max_iterations=1000, threshold=0.005))
    verbose: bool = False


@dataclasses.dataclass
class InitialPairResult:
    view_1_id: int = -1
    view_2_id: int = -1
    view_1_pose: CameraPose = dataclasses.field(default_factory=CameraPose)
    view_2_pose: CameraPose = dataclasses.field(default_factory=CameraPose)


@dataclasses.dataclass
class _CandidatePair:
    view_1_id: int
    view_2_id: int
    p1: list = dataclasses.field(default_factory=list)
    p2: list = dataclasses.field(default_factory=list)


class InitialPair:
    def __init__(self, options: Optional[InitialPairOptions] = None, device="cuda"):
        self.opts = options or InitialPairOptions()
        self.device = resolve_device(device)
        self.viewports: List[Viewport] = []
        self.tracks: List[Track] = []

    def initialize(self, viewports: List[Viewport], tracks: List[Track]) -> None:
        self.viewports = viewports
        self.tracks = tracks

    # ------------------------------------------------------------------
    def compute_pair(self) -> InitialPairResult:
        result = InitialPairResult()
        candidates = self._compute_candidate_pairs()
        candidates.sort(key=lambda c: len(c.p1), reverse=True)

        scores = np.zeros(len(candidates))
        for i, cand in enumerate(candidates):
            num_matches = len(cand.p1)
            if num_matches < self.opts.min_num_matches:
                continue
            p1 = np.asarray(cand.p1, np.float64)
            p2 = np.asarray(cand.p2, np.float64)
            # Homography-explained rejection.
            h_res = ransac_homography(p1, p2, self.opts.homography_opts,
                                      device=self.device)
            num_inliers = len(h_res.inliers)
            if num_inliers / num_matches > self.opts.max_homography_inliers:
                continue
            poses = self._compute_pose(cand)
            if poses is None:
                continue
            pose1, pose2 = poses
            angle = self._angle_for_pose(cand, pose1, pose2)
            scores[i] = self._score_for_pair(num_matches, num_inliers, angle)
            if angle < self.opts.min_triangulation_angle:
                continue
            # >= 50% successful triangulations (bundler_init_pair.cc:88-105).
            if not self._triangulation_ok(cand, pose1, pose2):
                continue
            result.view_1_id = cand.view_1_id
            result.view_2_id = cand.view_2_id
            result.view_1_pose = pose1
            result.view_2_pose = pose2
            return result

        # Fallback: best score (bundler_init_pair.cc:124-148).
        if scores.max(initial=0.0) > 0.0:
            best = int(np.argmax(scores))
            cand = candidates[best]
            poses = self._compute_pose(cand)
            if poses is not None:
                result.view_1_id = cand.view_1_id
                result.view_2_id = cand.view_2_id
                result.view_1_pose, result.view_2_pose = poses
        return result

    def compute_pair_fixed(self, view_1_id: int, view_2_id: int) -> InitialPairResult:
        if view_1_id > view_2_id:
            view_1_id, view_2_id = view_2_id, view_1_id
        candidates = self._compute_candidate_pairs()
        for cand in candidates:
            if cand.view_1_id == view_1_id and cand.view_2_id == view_2_id:
                poses = self._compute_pose(cand)
                if poses is None:
                    raise RuntimeError("Cannot compute pose for initial pair")
                r = InitialPairResult(view_1_id, view_2_id, *poses)
                return r
        raise RuntimeError("No matches for initial pair")

    # ------------------------------------------------------------------
    def _compute_candidate_pairs(self) -> List[_CandidatePair]:
        lookup = {}
        candidates: List[_CandidatePair] = []
        for track in self.tracks:
            feats = track.features
            for j in range(1, len(feats)):
                for k in range(j):
                    v1, f1 = feats[j].view_id, feats[j].feature_id
                    v2, f2 = feats[k].view_id, feats[k].feature_id
                    if v1 > v2:
                        v1, v2 = v2, v1
                        f1, f2 = f2, f1
                    key = (v1, v2)
                    if key not in lookup:
                        lookup[key] = len(candidates)
                        candidates.append(_CandidatePair(v1, v2))
                    cand = candidates[lookup[key]]
                    cand.p1.append(self.viewports[v1].positions[f1])
                    cand.p2.append(self.viewports[v2].positions[f2])
        return candidates

    def _compute_pose(self, cand: _CandidatePair):
        """8-point F -> E -> 4-way decomposition -> chirality test
        (bundler_init_pair.cc:241-283)."""
        p1 = np.asarray(cand.p1, np.float64)
        p2 = np.asarray(cand.p2, np.float64)
        if len(p1) > 1000:
            rng = np.random.RandomState(0)
            sel = rng.permutation(len(p1))[:1000]
            p1s, p2s = p1[sel], p2[sel]
        else:
            p1s, p2s = p1, p2
        # Padded to a power-of-two bucket as mve_tpu pads it. Zero rows
        # leave the least-squares system unchanged (they add nothing to
        # A^T A), but the SVD of the padded system is the one mve_tpu takes.
        n_s = len(p1s)
        Nb = 1 << max(4, int(np.ceil(np.log2(max(n_s, 1)))))
        p1b = np.zeros((Nb, 2), np.float32)
        p1b[:n_s] = p1s
        p2b = np.zeros((Nb, 2), np.float32)
        p2b[:n_s] = p2s
        dev = self.device
        F = fu.fundamental_least_squares(torch.from_numpy(p1b).to(dev)[None],
                                         torch.from_numpy(p2b).to(dev)[None])
        F = fu.enforce_fundamental_constraints(F).cpu().numpy()[0].astype(np.float64)

        vp1 = self.viewports[cand.view_1_id]
        vp2 = self.viewports[cand.view_2_id]
        pose1 = CameraPose()
        pose1.set_k_matrix(vp1.focal_length, 0.0, 0.0)
        pose1.init_canonical_form()
        pose2 = CameraPose()
        pose2.set_k_matrix(vp2.focal_length, 0.0, 0.0)

        E = pose2.K.T @ F @ pose1.K
        Rs, ts = fu.pose_from_essential(
            torch.from_numpy(E.astype(np.float32)).to(dev)[None])
        Rs, ts = Rs.cpu().numpy()[0].astype(np.float64), ts.cpu().numpy()[0].astype(np.float64)
        for k in range(4):
            cand_pose = CameraPose(K=pose2.K.copy(), R=Rs[k], t=ts[k])
            if self._is_consistent(p1[0], p2[0], pose1, cand_pose):
                return pose1, cand_pose
        return None

    @staticmethod
    def _is_consistent(x1, x2, pose1: CameraPose, pose2: CameraPose) -> bool:
        """Chirality: triangulated point in front of both cameras
        (triangulate.cc is_consistent_pose)."""
        X = np.asarray(triangulate_match(  # numpy DLT (no device trip)
            np.asarray(x1, np.float64), np.asarray(x2, np.float64),
            pose1.fill_p_matrix(), pose2.fill_p_matrix()))
        z1 = (pose1.R @ X + pose1.t)[2]
        z2 = (pose2.R @ X + pose2.t)[2]
        return z1 > 0 and z2 > 0

    def _angle_for_pose(self, cand: _CandidatePair, pose1: CameraPose,
                        pose2: CameraPose) -> float:
        """Median triangulation angle (bundler_init_pair.cc:286-311)."""
        T1 = pose1.R.T @ np.linalg.inv(pose1.K)
        T2 = pose2.R.T @ np.linalg.inv(pose2.K)
        p1 = np.concatenate([np.asarray(cand.p1), np.ones((len(cand.p1), 1))], axis=1)
        p2 = np.concatenate([np.asarray(cand.p2), np.ones((len(cand.p2), 1))], axis=1)
        d1 = (T1 @ p1.T).T
        d2 = (T2 @ p2.T).T
        d1 /= np.linalg.norm(d1, axis=1, keepdims=True)
        d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
        cos_angles = np.sum(d1 * d2, axis=1)
        median = np.partition(cos_angles, len(cos_angles) // 2)[len(cos_angles) // 2]
        return float(np.arccos(np.clip(median, -1.0, 1.0)))

    def _triangulation_ok(self, cand: _CandidatePair, pose1: CameraPose,
                          pose2: CameraPose) -> bool:
        p1 = np.asarray(cand.p1, np.float32)
        p2 = np.asarray(cand.p2, np.float32)
        n = len(p1)
        P1 = np.tile(pose1.fill_p_matrix(), (n, 1, 1))
        P2 = np.tile(pose2.fill_p_matrix(), (n, 1, 1))
        X = triangulate_match(p1.astype(np.float64), p2.astype(np.float64),
                              P1, P2)
        z1 = (pose1.R @ X.T).T[:, 2] + pose1.t[2]
        z2 = (pose2.R @ X.T).T[:, 2] + pose2.t[2]
        # Reference criteria via Triangulate: angle, error, chirality; the
        # dominant filter is chirality + angle. Count successes.
        ok = (z1 > 0) & (z2 > 0)
        c1 = pose1.fill_camera_pos()
        c2 = pose2.fill_camera_pos()
        r1 = X - c1
        r2 = X - c2
        r1 /= np.maximum(np.linalg.norm(r1, axis=1, keepdims=True), 1e-30)
        r2 /= np.maximum(np.linalg.norm(r2, axis=1, keepdims=True), 1e-30)
        angle_ok = np.sum(r1 * r2, axis=1) < np.cos(TriangulateOptions().angle_threshold)
        ok = ok & angle_ok
        return int(ok.sum()) * 2 >= n

    @staticmethod
    def _score_for_pair(num_matches: int, num_inliers: int, angle: float) -> float:
        """Logistic score product (bundler_init_pair.cc:317-333)."""
        matches = float(num_matches)
        inliers = num_inliers / matches
        angle_d = np.rad2deg(angle)
        f1 = 2.0 / (1.0 + np.exp((20.0 - matches) * 6.0 / 200.0)) - 1.0
        f2 = 2.0 / (1.0 + np.exp((1.0 - angle_d) * 6.0 / 8.0)) - 1.0
        f3 = 2.0 / (1.0 + np.exp((inliers - 0.7) * 6.0 / 0.4)) - 1.0
        return float(np.clip(f1, 0, 1) * np.clip(f2, 0, 1) * np.clip(f3, 0, 1))
