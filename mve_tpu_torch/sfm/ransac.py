"""RANSAC estimators (reference: libs/sfm/ransac_fundamental.cc,
ransac_homography.cc, ransac_pose_p3p.cc; port of mve_tpu/sfm/ransac.py).

All max_iterations hypotheses are solved and scored at once: the
minimal-sample solves are one batched SVD or closed form, and inlier
counting one (B, N) reduction; the best hypothesis is the first with the
most inliers (torch.argmax, like jnp.argmax, returns the first maximum).
The minimal samples are drawn on the host with numpy's RandomState, draw
for draw as mve_tpu draws them, so both packages see the same samples
from the same seed. Each estimator reads its result back once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from . import fundamental as fu
from . import homography as ho
from . import p3p as p3p_mod


@dataclasses.dataclass
class RansacOptions:
    max_iterations: int = 1000
    threshold: float = 0.0015  # ransac_fundamental.h:88-90 default
    verbose_output: bool = False
    # Minimum padded correspondence count of the P3P scorer. Incremental
    # SfM sets it once, to the largest feature count of any view, so every
    # resection of a run scores at one shape (as in mve_tpu, where each
    # shape is a compile).
    min_pad: int = 0


def _sample_indices(rng: np.random.RandomState, n: int, k: int, batch: int) -> np.ndarray:
    """(batch, k) unique-per-row random index samples.

    Vectorised redraw-on-collision; collisions at k<=8, n>=2k are rare, so
    a few redraw sweeps converge; tiny n takes the exact per-row draw."""
    if n < 2 * k or k > 8:
        out = np.empty((batch, k), np.int64)
        for i in range(batch):
            out[i] = rng.choice(n, size=k, replace=False)
        return out
    out = rng.randint(0, n, size=(batch, k))
    for _ in range(64):
        out_sorted = np.sort(out, axis=1)
        bad = (out_sorted[:, 1:] == out_sorted[:, :-1]).any(axis=1)
        if not bad.any():
            return out
        out[bad] = rng.randint(0, n, size=(int(bad.sum()), k))
    # Pathological leftovers (shouldn't happen with the n >= 2k guard).
    for i in np.nonzero(bad)[0]:
        out[i] = rng.choice(n, size=k, replace=False)
    return out


@dataclasses.dataclass
class RansacResult:
    model: np.ndarray
    inliers: np.ndarray  # indices into the correspondence array
    score: int = 0


def ransac_fundamental(p1, p2, opts: RansacOptions = RansacOptions(),
                       rng: np.random.RandomState | None = None,
                       device="cuda") -> RansacResult:
    """8-point RANSAC for F with Sampson scoring (ransac_fundamental.cc:107)."""
    dev = resolve_device(device)
    rng = rng or np.random.RandomState(0)
    p1 = np.asarray(p1, np.float32)
    p2 = np.asarray(p2, np.float32)
    n = len(p1)
    if n < 8:
        raise ValueError("At least 8 correspondences required")
    idx = _sample_indices(rng, n, 8, opts.max_iterations)
    t1 = torch.from_numpy(p1).to(dev)
    t2 = torch.from_numpy(p2).to(dev)
    tidx = torch.from_numpy(idx).to(dev)
    F = fu.fundamental_8_point(t1[tidx], t2[tidx])              # (B, 3, 3)
    d = fu.sampson_distance(F, t1[None], t2[None])              # (B, n)
    inl = d < opts.threshold ** 2
    counts = inl.sum(dim=1)
    best = int(torch.argmax(counts))
    return RansacResult(
        model=F[best].cpu().numpy(),
        inliers=np.nonzero(inl[best].cpu().numpy())[0].astype(np.int32),
        score=int(counts[best]),
    )


def ransac_homography(p1, p2, opts: RansacOptions | None = None,
                      rng: np.random.RandomState | None = None,
                      device="cuda") -> RansacResult:
    """4-point DLT RANSAC for H with symmetric transfer error scoring
    (ransac_homography.cc:100)."""
    dev = resolve_device(device)
    opts = opts or RansacOptions(threshold=0.005)  # ransac_homography.h:85-87
    rng = rng or np.random.RandomState(0)
    p1 = np.asarray(p1, np.float32)
    p2 = np.asarray(p2, np.float32)
    n = len(p1)
    if n < 4:
        raise ValueError("At least 4 correspondences required")
    idx = _sample_indices(rng, n, 4, opts.max_iterations)
    t1 = torch.from_numpy(p1).to(dev)
    t2 = torch.from_numpy(p2).to(dev)
    tidx = torch.from_numpy(idx).to(dev)
    H = ho.homography_dlt(t1[tidx], t2[tidx])                      # (B, 3, 3)
    err = ho.symmetric_transfer_error(H, t1[None], t2[None])       # (B, n)
    inl = err < opts.threshold ** 2
    counts = inl.sum(dim=1)
    best = torch.argmax(counts)
    model, mask, score = H[best].cpu(), inl[best].cpu(), counts[best].cpu()
    return RansacResult(
        model=model.numpy(),
        inliers=np.nonzero(mask.numpy())[0].astype(np.int32),
        score=int(score),
    )


@dataclasses.dataclass
class RansacPoseResult:
    R: np.ndarray
    t: np.ndarray
    inliers: np.ndarray


def ransac_pose_p3p(points_3d, points_2d, K, opts: RansacOptions | None = None,
                    rng: np.random.RandomState | None = None,
                    device="cuda") -> RansacPoseResult:
    """P3P RANSAC for 2D-3D pose (ransac_pose_p3p.cc:124).

    points_2d are normalised image coordinates, and so is the threshold
    (ransac_pose_p3p.h:31-55). All 4 P3P roots of every sample are scored.
    The correspondences are padded to a power of two, or to opts.min_pad
    when that is larger.
    """
    dev = resolve_device(device)
    opts = opts or RansacOptions(threshold=0.005)
    rng = rng or np.random.RandomState(0)
    points_3d = np.asarray(points_3d, np.float64)
    points_2d = np.asarray(points_2d, np.float64)
    n = len(points_3d)
    if n < 3:
        raise ValueError("At least 3 correspondences required")
    K = np.asarray(K, np.float64)
    h2d = np.concatenate([points_2d, np.ones((n, 1))], axis=1)
    bearings = (np.linalg.inv(K) @ h2d.T).T
    bearings /= np.linalg.norm(bearings, axis=1, keepdims=True)

    idx = _sample_indices(rng, n, 3, opts.max_iterations)
    Nb = max(1 << max(6, int(np.ceil(np.log2(n)))), opts.min_pad)
    X = np.zeros((Nb, 3), np.float32)
    X[:n] = points_3d
    p2d = np.zeros((Nb, 2), np.float32)
    p2d[:n] = points_2d

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    R, t, mask = _p3p_solve_score(f32(points_3d[idx]), f32(bearings[idx]), f32(X),
                                  f32(p2d), torch.from_numpy(np.arange(Nb) < n).to(dev),
                                  f32(K), opts.threshold)
    R, t, mask = R.cpu().numpy(), t.cpu().numpy(), mask.cpu().numpy()
    return RansacPoseResult(
        R=R.astype(np.float64),
        t=t.astype(np.float64),
        inliers=np.nonzero(mask[:n])[0].astype(np.int32),
    )


def _p3p_solve_score(sample_X, sample_bearing, X, p2d, valid_n, K, threshold):
    """P3P hypotheses, inlier scoring and best-pose selection.

    sample_X/sample_bearing: (B, 3, 3); X: (Nb, 3) padded points; p2d:
    (Nb, 2); valid_n: (Nb,). Returns (R (3,3), t (3,), mask (Nb,))."""
    Rs, ts, valid = p3p_mod.pose_p3p(sample_X, sample_bearing)
    pc = torch.einsum("bkij,nj->bkni", Rs, X) + ts[:, :, None, :]  # (B, 4, Nb, 3)
    z_ok = pc[..., 2] > 1e-9
    proj = torch.einsum("ij,bknj->bkni", K, pc)
    z = proj[..., 2:]
    uv = proj[..., :2] / torch.where(torch.abs(z) < 1e-20, 1e-20, z)
    err = torch.linalg.vector_norm(uv - p2d[None, None], dim=-1)
    inl = (err < threshold) & z_ok & valid[..., None] & valid_n[None, None]
    counts = inl.sum(dim=-1)                                        # (B, 4)
    flat = torch.argmax(counts.reshape(-1))
    bi, bk = flat // 4, flat % 4
    return Rs[bi, bk], ts[bi, bk], inl[bi, bk]
