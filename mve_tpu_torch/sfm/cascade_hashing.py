"""Cascade-hashing matcher (reference: libs/sfm/cascade_hashing.h:29-219;
port of mve_tpu/sfm/cascade_hashing.py).

Descriptors hash through one product with a random projection and a sign
(128-bit codes of zero-mean descriptors, packed into four 32-bit lanes);
Hamming distances are XOR plus a population count; the k nearest codes
are re-ranked by exact inner products. mve_tpu runs this as plain XLA,
so here it is plain PyTorch on the chosen device.

Three details keep the port's choices those of mve_tpu:

- This torch has no popcount op and little uint32 support, so the packed
  codes live in int64 with values in [0, 2^32); the XOR and a SWAR
  popcount then never meet a sign bit. Callers get the codes as uint32
  numpy, as from mve_tpu.
- The Hamming top-k is taken over the unique key ham * N2 + index, so
  among equal distances the lower index comes first (jax.lax.top_k's
  order); the re-ranking sorts stably (jnp.argsort's order).
- A code bit is the sign of a float32 product, so a product within
  rounding of zero can take the other sign than in mve_tpu (another
  summation order); tests/test_torch_cascade.py counts such bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from .matching import MatchingOptions, MatchingResult, remove_inconsistent_matches

# (N1, N2) int64 Hamming rows per step of _cascade_oneway: 4 M entries,
# 32 MB for each of the few temporaries.
_HAM_ENTRIES = 1 << 22


@dataclasses.dataclass
class CascadeHashingOptions:
    num_hash_bits: int = 128
    num_candidates: int = 10  # top-k by Hamming distance for exact re-ranking
    seed: int = 0


class CascadeHashing:
    """Mirrors sfm::CascadeHashing (init + pairwise_match API)."""

    def __init__(self, options: CascadeHashingOptions | None = None,
                 dim: int = 128, device="cuda"):
        self.opts = options or CascadeHashingOptions()
        self.device = resolve_device(device)
        rng = np.random.RandomState(self.opts.seed)
        # Random projections for the primary hash (cascade_hashing.h:86).
        self.proj = rng.randn(dim, self.opts.num_hash_bits).astype(np.float32)
        self._codes = {}   # set index -> (N, B/32) int64 tensor on the device
        self._descs = {}   # set index -> (N, D) float32 tensor on the device
        self._mean = None

    def init(self, descriptor_sets):
        """Hash codes for all sets, of descriptors made zero-mean over all
        of them (cascade_hashing.h init)."""
        all_desc = np.concatenate([d for d in descriptor_sets if len(d)], axis=0)
        self._mean = all_desc.mean(axis=0).astype(np.float32)
        proj = torch.from_numpy(self.proj).to(self.device)
        mean = torch.from_numpy(self._mean).to(self.device)
        for i, d in enumerate(descriptor_sets):
            self._descs[i] = torch.from_numpy(np.asarray(d, np.float32)).to(self.device)
            self._codes[i] = hash_codes(self._descs[i], proj, mean)

    def codes(self, i: int) -> np.ndarray:
        """Set i's packed codes, (N, B/32) uint32, as mve_tpu returns them."""
        return self._codes[i].cpu().numpy().astype(np.uint32)

    def pairwise_match(self, id1: int, id2: int,
                       opts: MatchingOptions = MatchingOptions()) -> MatchingResult:
        d1, d2 = self._descs[id1], self._descs[id2]
        c1, c2 = self._codes[id1], self._codes[id2]
        result = MatchingResult(self._oneway(d1, c1, d2, c2, opts),
                                self._oneway(d2, c2, d1, c1, opts))
        remove_inconsistent_matches(result)
        return result

    def _oneway(self, d1, c1, d2, c2, opts) -> np.ndarray:
        n1, n2 = len(d1), len(d2)
        if n1 == 0 or n2 == 0:
            return np.full(n1, -1, np.int32)
        k = min(self.opts.num_candidates, n2)
        idx, dist1, dist2 = (t.cpu().numpy() for t in _cascade_oneway(d1, c1, d2, c2, k))
        sq_lowe = opts.lowe_ratio_threshold**2
        ok = dist1 / np.maximum(dist2, 1e-30) <= sq_lowe
        if np.isfinite(opts.distance_threshold):
            ok &= dist1 <= opts.distance_threshold**2
        return np.where(ok, idx, -1).astype(np.int32)


def hash_codes(descs: torch.Tensor, proj: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """(N, D) float descriptors -> (N, B/32) packed sign codes, int64 in
    [0, 2^32): bit j of lane l is the sign of projection 32 l + j."""
    bits = (((descs - mean) @ proj) > 0).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=descs.device) << torch.arange(
        32, device=descs.device)
    return (bits.reshape(len(descs), -1, 32) * weights).sum(dim=-1)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 entry in [0, 2^32) (SWAR; no shift ever sees
    a sign bit, and the final product stays below 2^57)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def hamming(c1: torch.Tensor, c2: torch.Tensor) -> torch.Tensor:
    """(N1, N2) Hamming distances between packed codes (N1, L) and (N2, L)."""
    ham = popcount32(c1[:, None, 0] ^ c2[None, :, 0])
    for lane in range(1, c1.shape[1]):
        ham += popcount32(c1[:, None, lane] ^ c2[None, :, lane])
    return ham


def hamming_candidates(ham: torch.Tensor, k: int) -> torch.Tensor:
    """The k smallest distances of each row, ascending, the lower index
    first among equals (jax.lax.top_k(-ham, k)'s order)."""
    n2 = ham.shape[1]
    key = ham * n2 + torch.arange(n2, device=ham.device)
    return torch.topk(key, k, dim=1, largest=False, sorted=True).indices


def _cascade_oneway(d1, c1, d2, c2, k: int):
    """Hamming top-k candidates, then exact nearest-neighbour re-ranking:
    (best index, best and second-best squared distance) per row of d1."""
    rows = max(1, _HAM_ENTRIES // max(len(d2), 1))
    cand = torch.cat([hamming_candidates(hamming(c1[r:r + rows], c2), k)
                      for r in range(0, len(c1), rows)])
    dots = torch.einsum("nd,nkd->nk", d1, d2[cand])
    dist = 2.0 - 2.0 * dots
    order = torch.argsort(dist, dim=1, stable=True)
    best = torch.gather(cand, 1, order[:, :1])[:, 0]
    d_best = torch.gather(dist, 1, order[:, :1])[:, 0]
    if k > 1:
        d_second = torch.gather(dist, 1, order[:, 1:2])[:, 0]
    else:
        d_second = torch.full_like(d_best, float("inf"))
    return best.to(torch.int32), d_best, d_second
