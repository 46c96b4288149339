"""Triangulation (reference: libs/sfm/triangulate.h/.cc).

DLT two-view and N-view triangulation, plus the Triangulate
class-equivalent with angle/error/behind-camera statistics used by
incremental SfM (triangulate.h:26-128).

A numpy copy of mve_tpu/sfm/triangulate.py: these are small 4x4 SVD
solves on the host, as in mve_tpu, so that both packages triangulate
with the same LAPACK calls.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def triangulate_match(p1, p2, P1, P2):
    """Batched two-view DLT. p1/p2: (..., 2); P1/P2: (..., 3, 4).

    Returns (..., 3) world points (triangulate.cc triangulate_match).
    """
    rows = []
    for p, P in ((p1, P1), (p2, P2)):
        x, y = p[..., 0], p[..., 1]
        rows.append(x[..., None] * P[..., 2, :] - P[..., 0, :])
        rows.append(y[..., None] * P[..., 2, :] - P[..., 1, :])
    A = np.stack(rows, axis=-2)  # (..., 4, 4)
    _, _, vt = np.linalg.svd(A)
    X = vt[..., -1, :]
    return X[..., :3] / np.where(np.abs(X[..., 3:]) < 1e-30, 1e-30, X[..., 3:])


def triangulate_track(positions, pmatrices, valid=None):
    """N-view DLT with a fixed max view count via masking.

    positions: (V, 2); pmatrices: (V, 3, 4); valid: (V,) bool.
    Rows of invalid views are zeroed (they do not constrain the SVD).
    """
    positions = np.asarray(positions)
    pmatrices = np.asarray(pmatrices)
    x = positions[..., 0:1]
    y = positions[..., 1:2]
    r0 = x * pmatrices[..., 2, :] - pmatrices[..., 0, :]
    r1 = y * pmatrices[..., 2, :] - pmatrices[..., 1, :]
    A = np.concatenate([r0, r1], axis=-2) if r0.ndim > 2 else np.stack([r0, r1], axis=-2).reshape(-1, 4)
    if valid is not None:
        mask = np.repeat(np.asarray(valid), 2)
        # Normalize rows then zero invalid ones so scale doesn't skew SVD.
        A = np.where(mask[:, None], A, 0.0)
    _, _, vt = np.linalg.svd(A, full_matrices=True)
    X = vt[-1, :]
    return X[:3] / np.where(np.abs(X[3]) < 1e-30, 1e-30, X[3])


def triangulate_tracks_batched(positions, pmatrices, valid):
    """Batched masked N-view DLT.

    positions: (T, V, 2); pmatrices: (T, V, 3, 4); valid: (T, V) bool.
    Returns (T, 3).
    """
    x = positions[..., 0:1]
    y = positions[..., 1:2]
    r0 = x * pmatrices[..., 2, :] - pmatrices[..., 0, :]
    r1 = y * pmatrices[..., 2, :] - pmatrices[..., 1, :]
    A = np.concatenate([r0, r1], axis=-2)  # (T, 2V, 4)
    mask = np.repeat(valid, 2, axis=-1)
    A = np.where(mask[..., None], A, 0.0)
    _, _, vt = np.linalg.svd(A, full_matrices=True)
    X = vt[..., -1, :]
    return X[..., :3] / np.where(np.abs(X[..., 3:]) < 1e-30, 1e-30, X[..., 3:])


@dataclasses.dataclass
class TriangulateOptions:
    """triangulate.h Options (error/angle/behind-camera tests)."""

    error_threshold: float = 0.01
    angle_threshold: float = np.deg2rad(1.0)
    min_num_views: int = 2


@dataclasses.dataclass
class TriangulateStatistics:
    num_new_tracks: int = 0
    num_large_error: int = 0
    num_behind_camera: int = 0
    num_too_small_angle: int = 0


def triangulate_with_checks(positions, poses, opts: TriangulateOptions,
                            stats: TriangulateStatistics):
    """Reference Triangulate::triangulate: DLT over all views, then reject
    by (1) behind-camera, (2) reprojection error, (3) triangulation angle
    (triangulate.cc Triangulate::triangulate)."""
    V = len(poses)
    pmats = np.stack([p.fill_p_matrix() for p in poses])
    pos = np.asarray(positions, np.float64)
    X = triangulate_tracks_batched(pos[None], pmats[None], np.ones((1, V), bool))[0]

    # Behind-camera test.
    for pose in poses:
        z = (pose.R @ X + pose.t)[2]
        if z <= 0:
            stats.num_behind_camera += 1
            return None
    # Reprojection error.
    errors = []
    for i, pose in enumerate(poses):
        p = pmats[i] @ np.append(X, 1.0)
        p = p[:2] / p[2]
        errors.append(np.linalg.norm(p - pos[i]))
    if np.mean(errors) > opts.error_threshold:
        stats.num_large_error += 1
        return None
    # Triangulation angle: largest pairwise angle between viewing rays.
    dirs = []
    for pose in poses:
        c = pose.fill_camera_pos()
        d = X - c
        dirs.append(d / max(np.linalg.norm(d), 1e-30))
    cos_min = 1.0
    for i in range(V):
        for j in range(i + 1, V):
            cos_min = min(cos_min, float(np.dot(dirs[i], dirs[j])))
    if np.arccos(np.clip(cos_min, -1, 1)) < opts.angle_threshold:
        stats.num_too_small_angle += 1
        return None
    stats.num_new_tracks += 1
    return X
