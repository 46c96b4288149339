"""Memory-bounded FSSR: stream the point set, never materialize it
(port of mve_tpu/fssr/streaming.py; the passes C and D on the device).

The reference pipes samples one-by-one from the PLY straight into
octree insertion (sample_io.cc:471 next_sample + fssrecon.cc:24-60), so
point sets larger than RAM reconstruct fine. This module is the batched
equivalent over chunked streams (sample.stream_samples_from_ply): the
per-voxel accumulators are plain sums, so sample chunks ADD — the only
global coupling is the per-voxel scale filter, resolved with a
histogram pass.

Four passes over the input, each at O(chunk + voxels) memory:

  A. scan:      influence-dilated AABB + a fixed-log-bin scale
                histogram (grid cell size = approximate median scale,
                within one bin = ~1.4% relative).
  B. cells:     union of per-chunk active-cell codes (the same
                mark_active_cells used in-memory).
  C. histogram: per-voxel 64-bin log-scale histograms of in-radius
                samples (block_eval.run_chunk mode='hist'); per-voxel
                thresholds = 2 x the histogram's count//10 quantile bin
                upper edge — the streaming form of the reference's
                sort-based 10th-percentile filter (iso_octree.cc:
                104-112), exact to one bin width.
  D. evaluate:  block_eval.run_chunk mode='thresh' accumulates the
                (V, 10) sums against the fixed thresholds.

The result is a VoxelGrid identical (up to the histogram's bin
quantization of the scale filter) to the in-memory path's.
"""

from __future__ import annotations

from typing import Callable, Iterable

import numpy as np

from .. import resolve_device
from . import block_eval
from .iso_octree import (VoxelGrid, _normalize_sums, grid_geometry,
                         mark_active_cells, voxel_positions,
                         voxels_from_cells)
from .sample import SampleList

# Pass-A global scale histogram: fixed log-spaced bins spanning any
# plausible scale, 4096 bins over 18 decades = ~1% relative resolution.
_GLOBAL_BINS = 4096
_GLOBAL_LO, _GLOBAL_HI = 1e-12, 1e6


def _approx_median_from_hist(hist: np.ndarray) -> float:
    total = hist.sum()
    if total == 0:
        raise RuntimeError("No valid samples in stream")
    k = np.searchsorted(np.cumsum(hist), (total + 1) // 2)
    edges = np.exp(np.linspace(np.log(_GLOBAL_LO), np.log(_GLOBAL_HI),
                               _GLOBAL_BINS + 1))
    return float(np.sqrt(edges[k] * edges[k + 1]))  # bin geometric center


def compute_voxels_streaming(chunks: Callable[[], Iterable[SampleList]],
                             cell_size: float | None = None,
                             max_grid_dim: int = 1024,
                             verbose: bool = False,
                             device="cuda") -> VoxelGrid:
    """Evaluate the FSSR implicit function from a re-iterable stream.

    chunks: zero-argument callable returning a FRESH iterator of
    SampleList chunks each time (the stream is consumed four times).
    """
    dev = resolve_device(device)
    block_eval.reset_stats("stream")
    # --- pass A: AABB + global scale histogram.
    aabb_min = np.full(3, np.inf)
    aabb_max = np.full(3, -np.inf)
    ghist = np.zeros(_GLOBAL_BINS, np.int64)
    smin, smax = np.inf, 0.0
    n_total = 0
    log_edges = np.linspace(np.log(_GLOBAL_LO), np.log(_GLOBAL_HI),
                            _GLOBAL_BINS + 1)
    for ch in chunks():
        if not len(ch):
            continue
        n_total += len(ch)
        s = ch.scale.astype(np.float64)
        p = ch.pos.astype(np.float64)
        aabb_min = np.minimum(aabb_min, (p - 3.0 * s[:, None]).min(axis=0))
        aabb_max = np.maximum(aabb_max, (p + 3.0 * s[:, None]).max(axis=0))
        idx = np.clip(np.searchsorted(log_edges, np.log(np.maximum(
            s, _GLOBAL_LO))) - 1, 0, _GLOBAL_BINS - 1)
        ghist += np.bincount(idx, minlength=_GLOBAL_BINS)
        smin = min(smin, float(s.min()))
        smax = max(smax, float(s.max()))
    if n_total == 0:
        raise RuntimeError("No valid samples in stream")
    h = cell_size or _approx_median_from_hist(ghist)
    origin, h, dims = grid_geometry(aabb_min, aabb_max, h, max_grid_dim)
    if verbose:
        print(f"Streaming FSSR: {n_total} samples, cell {h:.5g}, "
              f"grid {dims[0]}x{dims[1]}x{dims[2]}.")

    # --- pass B: active cells (union over chunks).
    cell_codes = np.zeros(0, np.int64)
    for ch in chunks():
        if not len(ch):
            continue
        codes = mark_active_cells(ch.pos.astype(np.float64),
                                  ch.scale.astype(np.float64),
                                  origin, h, dims)
        cell_codes = np.union1d(cell_codes, codes)
    voxel_codes, cells = voxels_from_cells(cell_codes, dims)
    positions = voxel_positions(voxel_codes, origin, h, dims)
    V = len(positions)
    part = block_eval.partition_positions(positions, 4.0 * max(h, 1e-12))
    if verbose:
        print(f"Streaming FSSR: {len(cells)} cells, {V} voxels.")

    # --- pass C: per-voxel scale histograms -> thresholds.
    log_lo = np.log(max(smin, 1e-12))
    log_hi = np.log(max(smax, smin * (1 + 1e-9), 1e-12)) + 1e-9
    inv_width = block_eval.HIST_BINS / max(log_hi - log_lo, 1e-9)
    hists = np.zeros((V, block_eval.HIST_BINS), np.float64)
    for ch in chunks():
        if len(ch):
            block_eval.run_chunk(part, ch, hists, mode="hist",
                                 hist_log_lo=log_lo,
                                 hist_inv_width=inv_width, device=dev)
    counts = hists.sum(axis=1)
    k = (counts // 10).astype(np.int64)
    cum = np.cumsum(hists, axis=1)
    bin_idx = np.argmax(cum >= (k + 1)[:, None], axis=1)
    edges = np.exp(log_lo + np.arange(block_eval.HIST_BINS + 1)
                   / inv_width)
    thresh = 2.0 * edges[bin_idx + 1]
    thresh = np.where(counts > 0, thresh, 0.0)

    # --- pass D: accumulate the implicit-function sums.
    sums = np.zeros((V, 10), np.float64)
    for ch in chunks():
        if len(ch):
            block_eval.run_chunk(part, ch, sums, mode="thresh",
                                 thresh=thresh, device=dev)
    data = _normalize_sums(sums)
    return VoxelGrid(
        origin=origin, cell_size=h, dims=dims, voxel_codes=voxel_codes,
        value=data["value"], conf=data["conf"], deriv=data["deriv"],
        scale=data["scale"], color=data["color"], active_cells=cells)
