"""The plain reference of fssrecon: FSSR's implicit function in float64,
and the scene's true surface.

The implicit function (Fuhrmann and Goesele, "Floating Scale Surface
Reconstruction", SIGGRAPH 2014; MVE's libs/fssr basis_function.h and
iso_octree.cc) is summed here at a corner x over the samples i whose
support holds it, |x - p_i| < 3 s_i, that pass the scale filter: with k
the count of such samples, the (k // 10 + 1)-th smallest of their scales
s_k, keep s_i <= 2 s_k. Per kept sample, with d = x - p_i, q = |d|^2/s^2,
x_n = d . n_i and confidence c_i:

    f  = x_n exp(-|d|^2 / 2s^2) / (2 pi s^4)          (value basis)
    w  = 1 - 2/3 q + 8/27 q^(3/2) - 1/27 q^2          (weight)
    grad f = exp(-|d|^2/2s^2)/(2 pi s^6) ((s^2 - x_n^2) n - x_n (d - x_n n))
    grad w = 2 d / s^2 (-2/3 + 4/9 sqrt(q) - 2/27 q)
    g_c = exp(-|d|^2 / 2 sc^2) / (sc sqrt(2 pi)) with sc = s / 5

and the ten sums are [sum f w c, sum w c, sum g_c c, sum g_c c s,
sum (grad f w + grad w f) c (three), sum g_c c colour (three)], the
columns the program hands from its evaluation to its extraction. The
samples are the benchmark's own, cleaned as MVE's sample reader cleans
them (zero confidence dropped). It imports nothing of the program.

Numbers read per call (a cell's workload file names those it compares,
each against its limit, as the worst over the calls of the window):
- sums_err: over a sample of the call's corners, each column's largest
  difference from the reference over that column's largest magnitude;
- surf_median: the median over the written surface's vertices of their
  distance to the nearer of the scene's planes over their distance to
  the nearest camera;
- surf_gross: the share of those vertices more than GROSS off;
- octree_coarse: the share of samples whose node is coarser than FSSR's
  octree makes it (octree.cc, find_node_descend: a sample goes down to
  the first level whose node size is at most its scale, so the leaf that
  holds it is no larger). Read from the corners the program evaluated:
  they are the corners of leaves that tile a root cube, so the cube is
  their bounding box, and where the leaf holding a sample is no larger
  than h = root / 2^L (L = ceil(log2(root / scale))), all eight corners
  of the dyadic cell of size h around the sample are evaluated; where it
  is larger, one of them lies inside the leaf and is not. A sample that
  lies on a cell's face or whose level lies on a power of two is left
  out (rounding decides it).
A call whose surface is missing or has no face has failed.
"""

from __future__ import annotations

import math

import numpy as np

from mvebench.harness import scene as gen

GROSS = 0.05


def clean(samples_by_view: dict, group) -> dict:
    """The group's samples as float64 arrays, zero confidence dropped."""
    cat = {k: np.concatenate([samples_by_view[v][k] for v in group]) for k in
           ("pos", "normal", "color", "conf", "scale")}
    keep = cat["conf"] > 0
    n = cat["normal"][keep].astype(np.float64)
    gray = cat["color"][keep].astype(np.float64) / 255.0      # written as red = green = blue
    return {"pos": cat["pos"][keep].astype(np.float64),
            "normal": n / np.linalg.norm(n, axis=1, keepdims=True),
            "color": np.repeat(gray[:, None], 3, axis=1),
            "conf": cat["conf"][keep].astype(np.float64),
            "scale": cat["scale"][keep].astype(np.float64)}


def sums_at(S: dict, positions: np.ndarray, dtype=None):
    """((m, 10) sums, (m,) ambiguous) at the positions. A corner is
    ambiguous where float32 rounding may decide a sample's membership: a
    sample on its support's rim, or a scale at the filter's threshold
    within the program's bisection step (2^-25 of the largest scale)."""
    import torch
    from scipy.spatial import cKDTree

    dtype = dtype or torch.float64
    tree = cKDTree(S["pos"])
    smax = float(S["scale"].max())
    out = np.zeros((len(positions), 10), np.float64)
    amb = np.zeros(len(positions), bool)
    for r, x in enumerate(positions):
        idx = np.asarray(tree.query_ball_point(x, 3.0 * smax), np.int64)
        if len(idx) == 0:
            continue
        d = x[None, :] - S["pos"][idx]
        s = S["scale"][idx]
        q = np.sum(d * d, axis=1) / (s * s)
        inr = q < 9.0
        amb[r] = bool(np.any(np.abs(q - 9.0) < 1e-4))
        k = int(inr.sum())
        if k == 0:
            continue
        thr = 2.0 * np.sort(s[inr])[k // 10]
        keep = inr & (s <= thr)
        amb[r] |= bool(np.any(inr & (np.abs(s - thr) <= 2.0 * smax * 2.0 ** -22)))
        out[r] = _terms(x, S, idx[keep], dtype)
    return out, amb


def _terms(x, S, idx, dtype):
    """The ten sums at x over the samples idx. The offsets d = x - p_i are
    taken in float64; everything after them is computed in `dtype` (a
    torch dtype: float64 for the reference, bfloat16 for the control)."""
    import torch

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a)).to(dtype)

    d = t(x[None, :] - S["pos"][idx])
    n, s, c, col = (t(S[k][idx]) for k in ("normal", "scale", "conf", "color"))
    dist2 = (d * d).sum(1)
    s2 = s * s
    q = dist2 / s2
    xn = (d * n).sum(1)
    g = torch.exp(-dist2 / (2 * s2))
    f = xn * g / (2 * math.pi * s2 * s2)
    sq = torch.sqrt(q)
    w = 1 - (2 / 3) * q + (8 / 27) * q * sq - (1 / 27) * q * q
    gscale = g / (2 * math.pi * s2 * s2 * s2)
    wscale = 2 * (-2 / 3 + (4 / 9) * sq - (2 / 27) * q) / s2
    grad_f = gscale[:, None] * ((s2 - xn * xn)[:, None] * n - xn[:, None] * (d - xn[:, None] * n))
    grad = (grad_f * w[:, None] + (wscale[:, None] * d) * f[:, None]) * c[:, None]
    sc = s / 5
    gc = torch.exp(-dist2 / (2 * sc * sc)) / (sc * math.sqrt(2 * math.pi)) * c
    out = torch.cat([torch.stack([(f * w * c).sum(), (w * c).sum(), gc.sum(), (gc * s).sum()]),
                     grad.sum(0), (gc[:, None] * col).sum(0)])
    return out.double().numpy()


def sums_err(got: np.ndarray, want: np.ndarray) -> float:
    scale = np.abs(want).max(axis=0)
    rel = np.abs(got - want).max(axis=0) / np.where(scale > 0, scale, 1.0)
    return float(rel.max())


def octree_coarse(S: dict, corners: np.ndarray) -> float:
    """The share of S's samples whose octree node is coarser than their
    scale asks, judged from the evaluated corners (see the module's
    docstring)."""
    corners = np.asarray(corners, np.float64)
    lo = corners.min(axis=0)
    root = float((corners.max(axis=0) - lo).max())
    # The corners lie on the finest level's grid; its spacing is the
    # smallest gap between distinct coordinates.
    xs = np.unique(corners[:, 0])
    finest = int(round(np.log2(root / np.diff(xs).min())))
    fine = root / 2.0 ** finest
    B = 21

    def pack(c):
        return (c[:, 2] << (2 * B)) | (c[:, 1] << B) | c[:, 0]

    have = np.sort(pack(np.rint((corners - lo) / fine).astype(np.int64)))
    lvl = np.log2(root / S["scale"])
    level = np.ceil(lvl).astype(np.int64)
    t = (S["pos"] - lo) / (root / 2.0 ** level)[:, None]
    frac = t - np.floor(t)
    clear = (np.abs(lvl - np.rint(lvl)) > 1e-9) & (np.minimum(frac, 1 - frac) > 1e-9).all(axis=1)
    if not clear.any():
        return 0.0
    level, cell = level[clear], np.floor(t[clear]).astype(np.int64)
    coarse = level > finest
    fine_ok = ~coarse
    mult = np.int64(1) << np.maximum(finest - level, 0)
    offs = np.array([[i, j, k] for k in (0, 1) for j in (0, 1) for i in (0, 1)], np.int64)
    want = ((cell[fine_ok, None, :] + offs[None]) * mult[fine_ok, None, None]).reshape(-1, 3)
    code = pack(want)
    j = np.clip(np.searchsorted(have, code), 0, len(have) - 1)
    missing = (have[j] != code).reshape(-1, 8).any(axis=1)
    return float((coarse.sum() + missing.sum()) / clear.sum())


def surface_numbers(path: str, cams: list):
    """The surface's numbers, or None where it is missing or empty."""
    try:
        verts, n_faces = gen.read_ply(path)
    except (OSError, ValueError):
        return None
    if len(verts) == 0 or n_faces == 0:
        return None
    p = np.stack([verts["x"], verts["y"], verts["z"]], axis=1).astype(np.float64)
    off = np.minimum(np.abs(p[:, 2] - gen.NEAR_Z), np.abs(p[:, 2] - gen.PLANE_Z))
    near = np.min([np.linalg.norm(p - c.centre, axis=1) for c in cams], axis=0)
    rel = np.where(np.isfinite(off), off / near, np.inf)
    return {"surf_median": float(np.median(rel)), "surf_gross": float((rel > GROSS).mean())}


def judge(samples_by_view: dict, cams: list, workload: dict, calls: list):
    """(checks, attempted, failed, per-call numbers) over the window's
    calls, each given as (group, surface path, (checked corner positions,
    program's sums there, every corner the program evaluated))."""
    limits = workload["limits"]
    worst = {k: 0.0 for k in limits}
    failed, per_call = 0, []
    for group, surface, (positions, got, corners) in calls:
        nums = surface_numbers(surface, cams)
        if nums is None:
            per_call.append(None)
            failed += 1
            continue
        S = clean(samples_by_view, group)
        nums["octree_coarse"] = octree_coarse(S, corners)
        want, amb = sums_at(S, positions)
        nums["sums_err"] = sums_err(got[~amb], want[~amb]) if (~amb).any() else 1.0
        nums["ambiguous"] = int(amb.sum())
        per_call.append(nums)
        if any(nums[k] > limits[k] for k in limits):
            failed += 1
        for k in limits:
            worst[k] = max(worst[k], nums[k])
    checks = {k: {"value": worst[k], "limit": limits[k]} for k in limits}
    return checks, len(calls), failed, per_call
