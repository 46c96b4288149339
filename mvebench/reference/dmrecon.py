"""The plain reference of dmrecon: the true depth of the benchmark's scene.

The scene is two planes seen by cameras the benchmark made, so the depth
MVE's dmrecon should write is known exactly at every pixel: the length
of the pixel's ray from the camera centre to the visible plane (MVE's
depth convention), on the grid of the level's image. This module
computes it in float64 from the benchmark's own cameras and reads what
the program wrote (depth-L<n>.mvei and conf-L<n>.mvei) with its own MVEI
reader. It imports nothing of the program.

Numbers read per view (a cell's workload file names those it compares,
each against its limit, as the worst over the views due in the window):
- bad_share: the share of the view's pixels that carry no depth or a
  depth more than GROSS (relative) off the truth;
- seen_bad_share: the same share over the pixels whose surface point at
  least SEEN_BY other views of the scene see (in front, inside the
  image, not behind the near patch): SEEN_BY is MVE's default number of
  views a pixel is reconstructed from (nrReconNeighbors, 4), so these
  are the pixels dmrecon can reconstruct; a view's place in the ring
  decides how many of its pixels are among them;
- gross_share: the share of its accepted depths more than GROSS off;
- median_err: the median relative error of its accepted depths;
- conf_bad: the share of its pixels whose confidence is not a number,
  is negative, or is positive where no depth was accepted or 0 where one
  was (MVE's dmrecon accepts a pixel exactly where its confidence is
  above 0);
- fill: the share of its pixels with a depth (read, never compared).
A view due whose depth or confidence map is missing, or not of the
level's size, has failed.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

from mvebench.harness import scene as gen

GROSS = 0.05
SEEN_BY = 4
MVEI_SIGNATURE = b"\x89MVE_IMAGE\n"
_MVEI_TYPES = {9: np.float32, 10: np.float64}


def read_mvei(path: str) -> np.ndarray:
    """(H, W, C) float array of an MVEI image (MVE's image_io.cc layout)."""
    with open(path, "rb") as f:
        if f.read(len(MVEI_SIGNATURE)) != MVEI_SIGNATURE:
            raise IOError(f"{path}: not an MVEI image")
        w, h, c, t = struct.unpack("<iiii", f.read(16))
        data = np.frombuffer(f.read(), _MVEI_TYPES[t], count=w * h * c)
    return data.reshape(h, w, c)


def truth(cam, w: int, h: int) -> np.ndarray:
    return gen.truth_depth(cam, w, h, torch, "cpu")


def z_depth_control(cam, w: int, h: int) -> np.ndarray:
    """The control: the truth put in the program's place with one
    guarantee broken, the depth measured along the optical axis (camera
    z) instead of along the pixel's ray. Its confidence is 1 everywhere."""
    dirs, _ = gen.pixel_rays(cam, w, h, torch, "cpu")
    return truth(cam, w, h) * (dirs.numpy() @ cam.R[2])


def seen(cams: list, v: int, w: int, h: int) -> np.ndarray:
    """(H, W) bool: the pixels of view v whose surface point at least
    SEEN_BY of the other views see."""
    dirs, centre = gen.pixel_rays(cams[v], w, h, torch, "cpu")
    depth, _, _, near = gen.surface_hits(dirs, centre, torch)
    pts = (centre + dirs * depth[..., None]).reshape(-1, 3).numpy()
    on_near = near.reshape(-1).numpy()
    count = sum(gen.seen_by(c, pts, on_near, w, h).astype(np.int64)
                for i, c in enumerate(cams) if i != v)
    return (count >= SEEN_BY).reshape(h, w)


def view_numbers(depth: np.ndarray, conf: np.ndarray, true: np.ndarray,
                 seen_mask=None) -> dict:
    """A view's numbers; seen_bad_share only where seen_mask is given."""
    filled = depth > 0
    rel = np.abs(depth.astype(np.float64) - true) / true
    good = filled & (rel <= GROSS)
    conf_ok = np.isfinite(conf) & (conf >= 0) & ((conf > 0) == filled)
    n = int(filled.sum())
    nums = {"bad_share": float(1.0 - good.mean()),
            "gross_share": float((filled & ~good).sum() / n) if n else 1.0,
            "median_err": float(np.median(rel[filled])) if n else 1.0,
            "conf_bad": float(1.0 - conf_ok.mean()),
            "fill": float(filled.mean())}
    if seen_mask is not None:
        nums["seen_bad_share"] = float(1.0 - good[seen_mask].mean()) if seen_mask.any() else 0.0
    return nums


def judge(scene: str, cams: list, cfg: dict, workload: dict, due: list, maps=None):
    """(checks, attempted, failed, {view: numbers}) over the views due.
    maps, where given, replaces what the program wrote: {view: (depth,
    conf)} (the control)."""
    level = workload["level"]
    w, h = gen.level_dims(cfg["width"], cfg["height"], level)
    limits = workload["limits"]
    worst = {name: 0.0 for name in limits}
    failed, per_view = 0, {}
    for v in due:
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
        mask = seen(cams, v, w, h) if "seen_bad_share" in limits else None
        nums = per_view[v] = view_numbers(depth, conf, truth(cams[v], w, h), mask)
        if any(nums[k] > limits[k] for k in limits):
            failed += 1
        for k in limits:
            worst[k] = max(worst[k], nums[k])
    checks = {k: {"value": worst[k], "limit": limits[k]} for k in limits}
    return checks, len(due), failed, per_view
