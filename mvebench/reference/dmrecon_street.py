"""The plain reference of dmrecon on the street (kitti00): the true depth
of every pixel of a frame, and the pixels that can be triangulated.

The street (harness/street.py) is planes seen by cameras the benchmark
made, so the depth MVE's dmrecon should write is known exactly at every
pixel: the length of the pixel's ray from the camera centre to the first
surface it meets (MVE's depth convention), on the grid of the level's
image, in float64. Near the focus of expansion no pair of frames
triangulates, and beyond the track range no SfM point seeds the depth
range, so res_bad_share counts only the resolvable pixels
(harness/street.resolvable: within 30 m, and at least 4 other frames see
the point within 30 m with a parallax of at least 2 degrees). Maps are
read with reference/dmrecon's MVEI reader and scored with its
view_numbers. It imports nothing of the program.

Numbers read per view (a cell's workload file names those it compares,
each against its limit, as the worst over the views due in the window;
the others are readings, printed with the run's details):
- res_bad_share: the share of the resolvable pixels that carry no depth
  or a depth more than GROSS (5%, relative) off the truth: it holds the
  coverage, so depths left out fail it;
- gross_share: the share of accepted depths, anywhere, more than 5% off:
  the guarantee that accepted depths lie on the surface;
- resolvable: the share of the view's pixels that are resolvable;
- bad_share, median_err, conf_bad, fill: as reference/dmrecon has them.
A view due whose depth or confidence map is missing, or not of the
level's size, has failed.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mvebench.harness import scene as gen
from mvebench.harness import street
from mvebench.reference.dmrecon import read_mvei, view_numbers


def truth(cams: list, v: int, w: int, h: int, device="cpu") -> np.ndarray:
    return street.truth_depth(cams[v], w, h, street.cross_wall_z(len(cams)), torch, device)


def z_depth_control(cams: list, v: int, w: int, h: int, device="cpu") -> np.ndarray:
    """The control: the truth put in the program's place with one
    guarantee broken, the depth measured along the optical axis (camera
    z) instead of along the pixel's ray. Its confidence is 1 everywhere.
    At 1241 wide and KITTI's focal length (81.6 degrees across) it is
    more than 5% short beyond about 18 degrees off the axis."""
    dirs, _ = street.pixel_rays(cams[v], w, h, torch, device)
    return truth(cams, v, w, h, device) * (dirs.cpu().numpy() @ cams[v].R[2])


def judge(scene: str, cams: list, cfg: dict, workload: dict, due: list, maps=None,
          device="cpu"):
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
        mask = street.resolvable(cams, v, w, h, torch, device)
        nums = view_numbers(depth, conf, truth(cams, v, w, h, device), mask)
        nums["res_bad_share"] = nums.pop("seen_bad_share")
        nums["resolvable"] = float(mask.mean())
        per_view[v] = nums
        if any(nums[k] > limits[k] for k in limits):
            failed += 1
        for k in limits:
            worst[k] = max(worst[k], nums[k])
    checks = {k: {"value": worst[k], "limit": limits[k]} for k in limits}
    return checks, len(due), failed, per_view
