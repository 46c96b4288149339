"""Dense block evaluation of the FSSR implicit function (port of
mve_tpu/fssr/block_eval.py).

Voxels are grouped into spatial blocks; each block collects its candidate
samples (every sample whose influence ball |x-p| < 3*scale touches the
block's AABB) on the host with vectorised numpy hashing, and the device
then evaluates one regular (B, V, S) program per shape bucket:

    d = vox[b,v] - samp[b,s]
    mask = |d|^2 < 9 scale^2              (exact influence test)
    scale filter per (b,v): bisection for the count//10-th smallest
      in-radius scale (iso_octree.cc:104-112 semantics)
    basis/weight/gradient evaluation      (basis.py math)
    sum over s  ->  (B, V, 10)

The device code is plain PyTorch in float32, written one vector
component at a time: no (B, V, S, 3) intermediate is built, and each
three-term sum has a fixed order, ((x + y) + z), on every device. The
host plan (block partition, block expansion, sample table, SB buckets,
dispatch order) is mve_tpu's. All dispatches are queued before one read
back, and the host accumulates the results in float64 in mve_tpu's order.
A dispatch holds the rows it has: the last one of a bucket is not padded
to B (eager PyTorch compiles nothing per shape).

Streaming (fssr/streaming.py) reuses the same machinery with sample
chunks: a first device pass accumulates per-voxel log-scale histograms
(a float32 bmm of 0/1 values, exact for counts below 2^24), per-voxel
thresholds come from the histogram's count//10 quantile, and a second
pass evaluates each chunk against fixed thresholds; the accumulators are
plain sums, so chunk results add.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from .. import resolve_device
from ..parallel.mesh import Mesh

_VB = 64            # voxels per eval-block (dense padding unit)
_SB_MIN = 256       # smallest candidate-sample bucket
_ELEMS_PER_DISPATCH = 1 << 24  # bound (B, V, S) intermediate size
HIST_BINS = 64      # per-voxel scale-histogram resolution (streaming)

# float32(sqrt(float32(2 pi))), the value jnp.sqrt(2.0 * jnp.pi) takes.
_SQRT_2PI = float(np.sqrt(np.float32(2.0 * np.pi)))

#: Host and device split of the run_chunk calls since the last reset:
#: path ('bisect' or 'octave-hist', set by evaluate_positions_blocked),
#: expand_ms (host block expansion), dispatch_ms (host tables and queued
#: launches), sync_ms (waiting for the device and the one read back),
#: accumulate_ms (float64 sums on the host), buckets {SB: dispatches},
#: rows (eval rows) and pairs (B x V x S elements evaluated).
STATS: dict = {}


def reset_stats(path: str = "") -> None:
    STATS.clear()
    STATS.update(path=path, expand_ms=0.0, dispatch_ms=0.0, sync_ms=0.0,
                 accumulate_ms=0.0, buckets={}, rows=0, pairs=0)


reset_stats()


# ---------------------------------------------------------------------------
# device programs
# ---------------------------------------------------------------------------

def _pair_terms(vox_pos, samp, sidx, s_mask):
    """Shared per-pair geometry: gather sample rows on the device and
    compute distances and the influence mask. Vector fields are tuples of
    their three (B, V, S) components."""
    rows = samp[sidx]                                    # (B, S, 13)
    s_scale = torch.clamp_min(rows[..., 6], 1e-12)       # (B, S)
    d = tuple(vox_pos[:, :, None, i] - rows[:, None, :, i] for i in range(3))
    dist2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]      # (B, V, S)
    s = s_scale[:, None, :]                              # (B, 1, S)
    s2 = s * s
    q = dist2 / s2
    in_rad = (q < 9.0) & s_mask[:, None, :]
    return dict(d=d, dist2=dist2, s=s, s2=s2, q=q, in_rad=in_rad,
                s_norm=tuple(rows[:, None, :, 3 + i] for i in range(3)),
                s_scale=s_scale, s_conf=rows[..., 7],
                s_color=tuple(rows[:, None, :, 8 + i] for i in range(3)))


def _accumulate(t, keep, vox_mask):
    """Basis/weight/derivative accumulators over kept pairs
    (basis.evaluate_pairs math; basis_function.h:23-71). Returns
    (B, V, 10) sums [vw, w, cw, sw, dvw(3), c(3)]. Expressions keep
    mve_tpu's order and constant folding."""
    d, dist2, s, s2, q = t["d"], t["dist2"], t["s"], t["s2"], t["q"]
    n = t["s_norm"]

    x = d[0] * n[0] + d[1] * n[1] + d[2] * n[2]          # (B, V, S)
    g = torch.exp(-dist2 / (2.0 * s2))
    value_norm = 2.0 * math.pi * s2 * s2
    f = x * g / value_norm
    sq = torch.sqrt(torch.clamp_min(q, 0.0))
    w = 1.0 - (2.0 / 3.0) * q + (8.0 / 27.0) * q * sq - (1.0 / 27.0) * q * q

    conf = torch.where(keep, t["s_conf"][:, None, :], 0.0)
    vw = (f * w * conf).sum(-1)
    wc = (w * conf).sum(-1)

    # grad f = g/(norm s^2) ((s^2 - x^2) n - x (d - x n)); grad w =
    # w'(q) 2 d / s^2 with w' = -2/3 + 4/9 sqrt(q) - 2/27 q.
    gscale = g / (value_norm * s2)
    along = s2 - x * x
    wprime = -2.0 / 3.0 + (4.0 / 9.0) * sq - (2.0 / 27.0) * q
    wscale = 2.0 * wprime / s2
    dvw = []
    for i in range(3):
        grad_f = gscale * (along * n[i] - x * (d[i] - x * n[i]))
        grad_w = wscale * d[i]
        dvw.append(((grad_f * w + grad_w * f) * conf).sum(-1))

    # Colour/scale accumulators: normalised gaussian at sigma = scale/5
    # (iso_octree.cc:152-158).
    sigma_c = s / 5.0
    cw_pair = torch.exp(-dist2 / (2.0 * sigma_c * sigma_c)) / (sigma_c * _SQRT_2PI)
    cw_pair = torch.where(keep, cw_pair * t["s_conf"][:, None, :], 0.0)
    cw = cw_pair.sum(-1)
    sw = (cw_pair * s).sum(-1)
    c = [(cw_pair * t["s_color"][i]).sum(-1) for i in range(3)]

    out = torch.stack([vw, wc, cw, sw, *dvw, *c], dim=-1)    # (B, V, 10)
    return torch.where(vox_mask[..., None], out, 0.0)


def _scale_bisect(in_rad, s, s_scale, s_mask):
    """(B, V) upper ends of the bisection for each voxel's count//10-th
    smallest in-radius scale: a fixed 25 steps in float32 with integer
    counts, as mve_tpu's fori_loop does, and no read back."""
    k1 = in_rad.sum(-1) // 10 + 1                          # (B, V) int64
    smax = torch.where(s_mask, s_scale, 0.0).amax(-1)      # (B,)
    lo = torch.zeros(k1.shape, dtype=torch.float32, device=k1.device)
    hi = smax[:, None].expand(k1.shape).contiguous()
    # Out-of-radius pairs never count: their scale is +inf here.
    s_in = torch.where(in_rad, s, math.inf)
    for _ in range(25):
        mid = 0.5 * (lo + hi)
        ge = (s_in <= mid[..., None]).sum(-1) >= k1
        lo, hi = torch.where(ge, lo, mid), torch.where(ge, mid, hi)
    return hi


def _eval_dense(vox_pos, vox_mask, samp, sidx, s_mask):
    """All-in-one evaluation: in-radius test, on-device bisection for the
    per-voxel scale-filter threshold, accumulators. Used when the whole
    sample set is resident (non-streaming path)."""
    t = _pair_terms(vox_pos, samp, sidx, s_mask)
    hi = _scale_bisect(t["in_rad"], t["s"], t["s_scale"], s_mask)
    keep = t["in_rad"] & (t["s"] <= (2.0 * hi)[..., None])
    return _accumulate(t, keep, vox_mask)


def _eval_dense_thresh(vox_pos, vox_mask, samp, sidx, s_mask, thresh):
    """Evaluation against pre-computed per-voxel scale thresholds
    (streaming passes: thresholds come from the histogram pass)."""
    t = _pair_terms(vox_pos, samp, sidx, s_mask)
    keep = t["in_rad"] & (t["s"] <= thresh[..., None])
    return _accumulate(t, keep, vox_mask)


def _hist_dense(vox_pos, vox_mask, samp, sidx, s_mask, log_lo, inv_width):
    """Per-voxel log-scale histograms of in-radius samples: one-hot bin
    assignment contracted over the sample axis, as a float32 bmm of 0/1
    values (exact). log_lo and inv_width are float32 values. Returns
    (B, V, HIST_BINS) float32 counts."""
    t = _pair_terms(vox_pos, samp, sidx, s_mask)
    bins = torch.clamp(torch.floor(
        (torch.log(t["s_scale"]) - log_lo) * inv_width), 0, HIST_BINS - 1)
    nb = torch.arange(HIST_BINS, dtype=bins.dtype, device=bins.device)
    oh = (bins[..., None] == nb).float()                  # (B, S, NB)
    counts = torch.bmm(t["in_rad"].float(), oh)
    return torch.where(vox_mask[..., None], counts, 0.0)


# ---------------------------------------------------------------------------
# host-side plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BlockPartition:
    """Spatial partition of the evaluation positions, computed once and
    reused for every sample chunk."""
    origin: np.ndarray
    block_w: float
    bdims: np.ndarray
    order: np.ndarray       # position indices sorted by block code
    ublocks: np.ndarray     # sorted unique block codes
    bstart: np.ndarray
    bcount: np.ndarray
    eb_block: np.ndarray    # eval-row -> ublock index
    eb_vstart: np.ndarray
    eb_vcount: np.ndarray
    pos32: np.ndarray       # (V, 3) float32 positions (original order)


def partition_positions(positions: np.ndarray,
                        block_w: float) -> BlockPartition:
    positions = np.asarray(positions, np.float64)
    origin = positions.min(axis=0) - block_w
    pb = np.floor((positions - origin) / block_w).astype(np.int64)
    bdims = pb.max(axis=0) + 2
    bcode = (pb[:, 2] * bdims[1] + pb[:, 1]) * bdims[0] + pb[:, 0]
    order = np.argsort(bcode, kind="stable")
    ublocks, bstart = np.unique(bcode[order], return_index=True)
    bcount = np.diff(np.append(bstart, len(order)))
    # Split each block's voxel list into eval-rows of <= _VB voxels.
    nch = (bcount + _VB - 1) // _VB
    eb_block = np.repeat(np.arange(len(ublocks)), nch)
    within = np.arange(len(eb_block)) - np.repeat(np.cumsum(nch) - nch, nch)
    return BlockPartition(
        origin=origin, block_w=block_w, bdims=bdims, order=order,
        ublocks=ublocks, bstart=bstart, bcount=bcount, eb_block=eb_block,
        eb_vstart=bstart[eb_block] + within * _VB,
        eb_vcount=np.minimum(bcount[eb_block] - within * _VB, _VB),
        pos32=positions.astype(np.float32))


def _expand_sample_blocks(pos, scale, origin, block_w, bdims):
    """(sample, block-code) entries for every block whose AABB is within
    each sample's influence radius 3*scale: a vectorised range expansion
    with an exact point-to-AABB distance test. mve_tpu's entries in
    mve_tpu's order (span group, then dz, dy, dx, then sample); the
    per-axis distances to each slab of blocks are computed once per
    group, not once per offset."""
    r = 3.0 * scale
    lo = np.floor((pos - r[:, None] - origin) / block_w).astype(np.int64)
    hi = np.floor((pos + r[:, None] - origin) / block_w).astype(np.int64)
    lo = np.clip(lo, 0, bdims - 1)
    hi = np.clip(hi, 0, bdims - 1)
    span = (hi - lo).max(axis=1)
    ent_s, ent_b = [], []
    for m in np.unique(span):
        sel = np.nonzero(span == m)[0]
        p, r2 = pos[sel], r[sel] * r[sel]
        # Per axis a and offset o: block coordinate, whether it is in the
        # sample's range, and the squared distance to its slab.
        cell, within, dist2 = [], [], []
        for a in range(3):
            c = lo[sel, a][None, :] + np.arange(m + 1)[:, None]
            bmin = origin[a] + c * block_w
            dd = np.maximum(bmin - p[:, a], 0.0) + np.maximum(p[:, a] - (bmin + block_w), 0.0)
            cell.append(c)
            within.append(c <= hi[sel, a])
            dist2.append(dd * dd)
        for dz in range(m + 1):
            for dy in range(m + 1):
                ok_zy = within[2][dz] & within[1][dy]
                for dx in range(m + 1):
                    i = np.nonzero(ok_zy & within[0][dx])[0]
                    if not len(i):
                        continue
                    near = (dist2[0][dx, i] + dist2[1][dy, i]) + dist2[2][dz, i] < r2[i]
                    i = i[near]
                    ent_s.append(sel[i])
                    ent_b.append((cell[2][dz, i] * bdims[1] + cell[1][dy, i]) * bdims[0]
                                 + cell[0][dx, i])
    if not ent_s:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(ent_s), np.concatenate(ent_b)


def _sample_table(samples) -> np.ndarray:
    """Pack sample fields into the padded (Nb, 13) device table."""
    n = len(samples.pos)
    Nb = 1 << max(8, int(np.ceil(np.log2(max(n, 1)))))
    table = np.zeros((Nb, 13), np.float32)
    table[:n, 0:3] = samples.pos
    table[:n, 3:6] = samples.normal
    table[:n, 6] = samples.scale
    table[:n, 7] = samples.confidence
    table[:n, 8:11] = samples.color
    return table


def _to_device(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on dev; to the card through pinned memory, so that the
    copy is queued behind earlier launches instead of waiting for them."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


def _evaluate(mode, args, thresh, log_lo, inv_width):
    if mode == "bisect":
        return _eval_dense(*args)
    if mode == "thresh":
        return _eval_dense_thresh(*args, thresh)
    return _hist_dense(*args, log_lo, inv_width)


def run_chunk(part: BlockPartition, samples, out: np.ndarray,
              mode: str = "bisect", thresh: np.ndarray | None = None,
              hist_log_lo: float = 0.0, hist_inv_width: float = 1.0,
              device="cuda", mesh=None):
    """Evaluate one sample chunk against the partitioned positions and
    ADD the per-position results into `out`.

    mode: 'bisect' (self-contained scale filter; out is (V, 10)),
    'thresh' (fixed per-position thresholds; out is (V, 10)), or
    'hist' (accumulate scale histograms; out is (V, HIST_BINS)).

    mesh: a mesh (mve_tpu_torch.parallel) whose devices take the place of
    `device` (default: one shard on `device`). Eval-rows are independent,
    so each dispatch batch is padded to a multiple of mesh.size and split
    over the shards, each evaluates its rows on its device, and the rows
    are gathered in order before the host sums (mve_tpu's sharding, with
    no collective but the gather): the accumulators are those of one
    shard on the same device type, bit for bit."""
    mesh = mesh or Mesh([resolve_device(device)])
    if mode not in ("bisect", "thresh", "hist"):
        raise ValueError(f"unknown mode {mode!r}")
    pos = samples.pos.astype(np.float64)
    scale = samples.scale.astype(np.float64)
    if len(pos) == 0 or len(part.order) == 0:
        return

    t0 = time.perf_counter()
    ent_s, ent_b = _expand_sample_blocks(
        pos, scale, part.origin, part.block_w, part.bdims)
    j = np.searchsorted(part.ublocks, ent_b)
    j = np.clip(j, 0, len(part.ublocks) - 1)
    okb = part.ublocks[j] == ent_b
    ent_s, ent_blk = ent_s[okb], j[okb]
    eorder = np.argsort(ent_blk, kind="stable")
    ent_s = ent_s[eorder]
    scount = np.bincount(ent_blk[eorder], minlength=len(part.ublocks))
    sstart = np.concatenate([[0], np.cumsum(scount)[:-1]])
    eb_scount = scount[part.eb_block]

    sb = np.maximum(_SB_MIN, 1 << np.ceil(
        np.log2(np.maximum(eb_scount, 1))).astype(np.int64))
    # Rows with no candidate samples contribute exactly zero; skip them
    # (on octave-grouped scale-diverse runs most rows are empty for most
    # groups).
    sb = np.where(eb_scount > 0, sb, -1)
    t1 = time.perf_counter()
    table = _sample_table(samples)
    devices = mesh.local_devices()
    # The sample table on each device (shards may share one).
    d_tables = {d: _to_device(table, d) for d in set(devices)}
    if mode == "hist":
        log_lo = float(np.float32(hist_log_lo))
        inv_width = float(np.float32(hist_inv_width))
    else:
        log_lo = inv_width = None

    pending = []  # (device result, vidx, vmask)
    for SB in np.unique(sb):
        if SB < 0:
            continue
        rows = np.nonzero(sb == SB)[0]
        SBi = int(SB)
        # mve_tpu's dispatch shape (B, _VB, SB) per SB bucket; a
        # dispatch holds only its real rows, padded to a multiple of the
        # mesh's size with rows that evaluate to zero.
        B = max(1, _ELEMS_PER_DISPATCH // (_VB * SBi))
        m = mesh.size
        B = (B + m - 1) // m * m
        STATS["buckets"][SBi] = STATS["buckets"].get(SBi, 0) \
            + (len(rows) + B - 1) // B
        STATS["rows"] += len(rows)
        STATS["pairs"] += len(rows) * _VB * SBi
        for c0 in range(0, len(rows), B):
            sel = rows[c0:c0 + B]
            n = len(sel)
            sel = np.concatenate([sel, np.full(-n % m, sel[0])])
            real = (np.arange(len(sel)) < n)[:, None]
            vs = part.eb_vstart[sel]
            vc = part.eb_vcount[sel]
            ar = np.arange(_VB)
            vidx = part.order[np.minimum(vs[:, None] + ar[None, :],
                                         len(part.order) - 1)]
            vmask = (ar[None, :] < vc[:, None]) & real
            ss = sstart[part.eb_block[sel]]
            sc = eb_scount[sel]
            ar_s = np.arange(SBi)
            sidx = ent_s[np.minimum(ss[:, None] + ar_s[None, :],
                                    max(len(ent_s) - 1, 0))]
            smask = (ar_s[None, :] < sc[:, None]) & real
            batch = [part.pos32[vidx], vmask, sidx.astype(np.int64), smask]
            if mode == "thresh":
                batch.append(thresh[vidx].astype(np.float32))
            k = len(sel) // m
            shards = [[a[i * k:(i + 1) * k] for a in batch] for i in mesh.local_shards]
            res = []
            for d, (pos32, vm, si, sm, *th) in zip(devices, shards):
                args = (_to_device(pos32, d), _to_device(vm, d), d_tables[d],
                        _to_device(si, d), _to_device(sm, d))
                res.append(_evaluate(mode, args, _to_device(th[0], d) if th else None,
                                     log_lo, inv_width))
                del args
            res = mesh.gather_rows(res)
            pending.append((res[:n].reshape(-1, res.shape[-1]), vidx[:n], vmask[:n]))
    t2 = time.perf_counter()
    # One read back at the end: the device computes while the host
    # assembles the tables of later dispatches.
    if not pending:
        return
    host = torch.cat([r for r, _, _ in pending]).cpu().numpy()
    t3 = time.perf_counter()
    r0 = 0
    for res, vidx, vmask in pending:
        arr = host[r0:r0 + len(res)].reshape(vidx.shape + (-1,)).astype(np.float64)
        r0 += len(res)
        out[vidx[vmask]] += arr[vmask]
    t4 = time.perf_counter()
    for key, a, b in (("expand_ms", t0, t1), ("dispatch_ms", t1, t2),
                      ("sync_ms", t2, t3), ("accumulate_ms", t3, t4)):
        STATS[key] += 1e3 * (b - a)


def evaluate_positions_blocked(samples, positions: np.ndarray,
                               block_cells: float = 4.0,
                               device="cuda", mesh=None) -> np.ndarray:
    """Compute the per-voxel FSSR accumulator sums (V, 10) for arbitrary
    positions with the dense block program on `device`, or with each
    dispatch batch split over the shards of `mesh` (run_chunk); every
    process of a process-group mesh gets all the sums.

    Scale-DIVERSE sample sets (max/min scale > 32) evaluate per scale
    octave, each octave against a partition sized to ITS influence
    radius: one median-derived block size makes a coarse sample touch
    O((scale/median)^3) blocks. The per-voxel scale filter couples
    octaves, so the diverse path uses the streaming two-pass form
    (per-voxel log-scale histograms -> fixed thresholds -> additive
    evaluation), exact to one histogram bin like fssr/streaming.py."""
    mesh = mesh or Mesh([resolve_device(device)])
    positions = np.asarray(positions, np.float64)
    V = len(positions)
    sums = np.zeros((V, 10), np.float64)
    if V == 0 or len(samples.pos) == 0:
        return sums
    scale = samples.scale.astype(np.float64)
    smin = max(float(scale.min()), 1e-12)
    smax = float(scale.max())
    # The octave-grouped two-pass runs the block expansion and the
    # device sweep once per (group, pass): worth it only for genuinely
    # scale-diverse inputs. Ordinary point sets (span < ~30) stay on the
    # one-pass bisect path.
    if smax / smin <= 32.0:
        reset_stats("bisect")
        h = float(np.median(scale))
        part = partition_positions(positions, block_cells * max(h, 1e-12))
        run_chunk(part, samples, sums, mode="bisect", mesh=mesh)
        return sums

    reset_stats("octave-hist")
    # --- octave groups (3 octaves per group keeps group count small
    # while bounding per-sample touched blocks at ~(6/4*8+2)^3).
    oct_id = np.floor(np.log2(scale / smin) / 3.0).astype(np.int64)
    groups = []
    for g in np.unique(oct_id):
        m = oct_id == g
        sub = samples.subset(m)
        gmax = float(scale[m].max())
        part = partition_positions(positions, block_cells * gmax)
        groups.append((sub, part))

    # Pass 1: per-voxel log-scale histograms over all groups.
    log_lo = np.log(smin)
    log_hi = np.log(max(smax, smin * (1 + 1e-9))) + 1e-9
    inv_width = HIST_BINS / max(log_hi - log_lo, 1e-9)
    hists = np.zeros((V, HIST_BINS), np.float64)
    for sub, part in groups:
        run_chunk(part, sub, hists, mode="hist", hist_log_lo=log_lo,
                  hist_inv_width=inv_width, mesh=mesh)
    counts = hists.sum(axis=1)
    k = (counts // 10).astype(np.int64)
    cum = np.cumsum(hists, axis=1)
    bin_idx = np.argmax(cum >= (k + 1)[:, None], axis=1)
    edges = np.exp(log_lo + np.arange(HIST_BINS + 1) / inv_width)
    thresh = np.where(counts > 0, 2.0 * edges[bin_idx + 1], 0.0)

    # Pass 2: additive evaluation against the fixed thresholds.
    for sub, part in groups:
        run_chunk(part, sub, sums, mode="thresh", thresh=thresh, mesh=mesh)
    return sums
