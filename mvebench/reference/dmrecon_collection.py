"""The plain reference of dmrecon --max-pixels on the community photo
collection (landmark36): the true depth of every pixel of each view, at
the level the max-pixels rule gives that view.

The collection (harness/collection.py) is harness/scene.py's two planes
seen by cameras of many formats, so the depth MVE's dmrecon should write
is known exactly at every pixel: the length of the pixel's ray from the
camera centre to the visible plane (MVE's depth convention), on the grid
of the view's level, in float64. The level is worked out here from the
view's own image size and the workload's max_pixels (the smallest s with
(w >> s) * (h >> s) <= max_pixels), not read from the program. Maps are
read with reference/dmrecon's MVEI reader and scored with its
view_numbers. It imports nothing of the program.

Numbers read per view (printed with the run's details): seen_bad_share,
the share of the pixels whose surface point at least SEEN_BY other views
see (in front, inside their own image, not behind the near patch) that
carry no depth or one more than 5% off; seen_bad_1pct, the same with
1% for 5%; seen_px, how many such pixels; gross_share, the share of
accepted depths more than 5% off; median_err, the median relative error
of accepted depths; conf_bad, the share of pixels whose confidence is
not above 0 exactly where a depth is; level, bad_share, fill.

The workload's limits compare gross_share, median_err and conf_bad, each
as the worst over the views due, and seen_bad_1pct_pooled: the seen
pixels of all the views due that carry no depth within 1% of the truth,
over all their seen pixels. The coverage is pooled because it varies
with the format mix more than with the program: a 4000x3000 view at
level 3, beside neighbours of coarser formats loaded at that level,
leaves 0.42 of its seen pixels without a depth within 5% on average and
up to 0.77, views at levels 1 and 2 0.05 and 0.09 (PERF.md §2). It
counts depths within 1% because the control (camera-z depth, every pixel
filled) is within 5% of the ray length wherever a pixel lies within 18
degrees of the axis, on most of a zoomed view, but within 1% only inside
8 degrees; the program's median error is 0.03-0.19%. A view due whose
depth or confidence map is missing, not at its level, or not of its
level's size, has failed; so has a view past a per-view limit.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mvebench.harness import collection, scene as gen
from mvebench.reference.dmrecon import read_mvei, view_numbers

SEEN_BY = 4
TIGHT = 0.01    # seen_bad_1pct's relative tolerance


def levels(cfg: dict, max_pixels: int) -> list:
    """(level, width, height at that level) of each view, by the
    max-pixels rule (harness/collection.level_for)."""
    out = []
    for w, h in collection.view_formats(cfg):
        s = collection.level_for(w, h, max_pixels)
        out.append((s, *gen.level_dims(w, h, s)))
    return out


def truth(cam, w: int, h: int, device="cpu") -> np.ndarray:
    return gen.truth_depth(cam, w, h, torch, device)


def z_depth_control(cam, w: int, h: int, device="cpu") -> np.ndarray:
    """The control: the truth put in the program's place with one
    guarantee broken, the depth measured along the optical axis (camera
    z) instead of along the pixel's ray. Its confidence is 1 everywhere."""
    dirs, _ = gen.pixel_rays(cam, w, h, torch, device)
    return truth(cam, w, h, device) * (dirs.cpu().numpy() @ cam.R[2])


def sees(cam, pts, on_near, w: int, h: int):
    """harness/scene.seen_by on torch float64 tensors, on their device:
    which of the points (P, 3) cam sees in front of it, inside its (w, h)
    image and, for a background point, not behind the near patch."""
    x0, x1, y0, y1 = gen.NEAR_BOUNDS
    R, t, K = (torch.tensor(a, dtype=torch.float64, device=pts.device)
               for a in (cam.R, cam.t, cam.K(w, h)))
    pc = pts @ R.T + t
    proj = pc @ K.T
    u, v = proj[:, 0] / proj[:, 2], proj[:, 1] / proj[:, 2]
    inside = (pc[:, 2] > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    c = cam.centre
    s = (gen.NEAR_Z - c[2]) / (pts[:, 2] - c[2])
    cx, cy = c[0] + s * (pts[:, 0] - c[0]), c[1] + s * (pts[:, 1] - c[1])
    hidden = ~on_near & (cx >= x0) & (cx <= x1) & (cy >= y0) & (cy <= y1)
    return inside & ~hidden


def seen(cams: list, sizes: list, v: int, w: int, h: int, device="cpu") -> np.ndarray:
    """(h, w) bool: the pixels of view v (at w x h) whose surface point at
    least SEEN_BY of the other views see, each at its own size."""
    dirs, centre = gen.pixel_rays(cams[v], w, h, torch, device)
    depth, _, _, near = gen.surface_hits(dirs, centre, torch)
    pts = (centre + dirs * depth[..., None]).reshape(-1, 3)
    on_near = near.reshape(-1)
    count = sum(sees(c, pts, on_near, *sizes[i]).to(torch.int64)
                for i, c in enumerate(cams) if i != v)
    return (count >= SEEN_BY).reshape(h, w).cpu().numpy()


def judge(scene: str, cams: list, cfg: dict, workload: dict, due: list, maps=None,
          device="cpu"):
    """(checks, attempted, failed, {view: numbers}) over the views due.
    maps, where given, replaces what the program wrote: {view: (depth,
    conf)} (the control)."""
    limits = workload["limits"]
    per_view_limits = {k: x for k, x in limits.items() if k != "seen_bad_1pct_pooled"}
    sizes = collection.view_formats(cfg)
    at = levels(cfg, workload["max_pixels"])
    worst = {name: 0.0 for name in per_view_limits}
    failed, per_view, seen_bad, seen_px = 0, {}, 0, 0
    for v in due:
        level, w, h = at[v]
        if maps is not None:
            depth, conf = maps[v]
        else:
            d = gen.view_dir(scene, v)
            try:
                depth = read_mvei(os.path.join(d, f"depth-L{level}.mvei"))[..., 0]
                conf = read_mvei(os.path.join(d, f"conf-L{level}.mvei"))[..., 0]
            except (OSError, KeyError, ValueError):
                depth = conf = None
        if depth is None or depth.shape != (h, w) or conf.shape != (h, w):
            per_view[v] = None
            failed += 1
            continue
        mask = seen(cams, sizes, v, w, h, device)
        true = truth(cams[v], w, h, device)
        nums = view_numbers(depth, conf, true, mask)
        off = (depth <= 0) | (np.abs(depth.astype(np.float64) - true) > TIGHT * true)
        n_seen, n_off = int(mask.sum()), int(off[mask].sum())
        nums.update(level=level, seen_px=n_seen,
                    seen_bad_1pct=n_off / n_seen if n_seen else 0.0)
        per_view[v] = nums
        seen_px += n_seen
        seen_bad += n_off
        if any(nums[k] > per_view_limits[k] for k in per_view_limits):
            failed += 1
        for k in per_view_limits:
            worst[k] = max(worst[k], nums[k])
    if "seen_bad_1pct_pooled" in limits:
        worst["seen_bad_1pct_pooled"] = seen_bad / seen_px if seen_px else 1.0
    checks = {k: {"value": worst[k], "limit": limits[k]} for k in limits}
    return checks, len(due), failed, per_view
