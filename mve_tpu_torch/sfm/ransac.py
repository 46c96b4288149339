"""RANSAC for the fundamental matrix (reference:
libs/sfm/ransac_fundamental.cc; port of the fundamental part of
mve_tpu/sfm/ransac.py).

All max_iterations hypotheses are solved and scored at once: the
minimal-sample solves are one batched SVD and inlier counting one (B, N)
reduction. The minimal samples are drawn on the host with numpy's
RandomState, draw for draw as mve_tpu draws them, so both packages see
the same samples from the same seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from . import fundamental as fu


@dataclasses.dataclass
class RansacOptions:
    max_iterations: int = 1000
    threshold: float = 0.0015  # ransac_fundamental.h:88-90 default
    verbose_output: bool = False


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
