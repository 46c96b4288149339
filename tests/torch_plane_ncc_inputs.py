"""Inputs of the slanted-plane NCC kernel (csrc/plane_ncc.cu): seeded
arguments of mvs/patch._plane_tap_sums at tiny forms and at the main
path's forms. tests/test_torch_plane_ncc.py imports it; chip_smoke.py
phase 3c loads it from its file (the tests directory is not a package).
"""

import math

import numpy as np
import torch

F32 = np.float32

FW = 5
# (J, K, H, W, Hn, Wn, lead form, own sizes or None, special values)
TINY = {
    "all": (3, 2, 12, 10, 14, 13, "all", None, True),
    "all-hw": (3, 2, 12, 10, 14, 13, "all", ((14, 13), (11, 9), (13, 12)), True),
    "sel": (3, 2, 12, 10, 14, 13, "sel", None, True),
    "sel-hw": (3, 2, 12, 10, 14, 13, "sel", ((14, 13), (11, 9), (13, 12)), True),
}
_FORMATS = ((612, 816), (816, 612), (512, 768), (384, 512), (600, 800), (750, 563))
MAIN = {
    "kitti00": (20, 10, 376, 1241, 376, 1241, "sel", None, False),
    "landmark36": (20, 10, 612, 816, 816, 816, "sel",
                   tuple(_FORMATS[j % len(_FORMATS)] for j in range(20)), False),
    "centre-plane": (20, 1, 300, 400, 300, 400, "all", None, False),
}


def case(form, seed=0):
    """Inputs of one form as float32 / int64 numpy arrays: a dict of
    _plane_tap_sums' arguments. The operators map each reference pixel
    near its own place in the view's own size (scaled), so that most
    windows inside the image stay in bounds; with `special`, some depths
    and slopes are NaN, infinite, or put a tap's ray length at or below 0."""
    J, K, H, W, Hn, Wn, lead, own, special = form
    rng = np.random.default_rng(seed)
    own = np.array(own if own is not None else [(Hn, Wn)] * J, F32)
    T = np.zeros((J, 3, 3), np.float64)
    tvec = np.zeros((J, 3), np.float64)
    for j in range(J):
        sy, sx = own[j, 0] / H, own[j, 1] / W
        T[j] = np.eye(3) + rng.normal(0, 1, (3, 3)) * [[0.01, 0.01, 1.0], [0.01, 0.01, 1.0],
                                                         [1e-5, 1e-5, 0.01]]
        T[j, 0] *= sx
        T[j, 1] *= sy
        tvec[j] = rng.normal(0, 1, 3) * [3.0 * sx, 3.0 * sy, 0.02]
    yy, xx = np.mgrid[0:Hn, 0:Wn]
    neigh = np.stack([(0.5 + 0.25 * np.sin(0.37 * xx + 0.21 * yy + j)
                       + 0.2 * rng.random((Hn, Wn))) for j in range(J)])
    for j in range(J):
        neigh[j, int(own[j, 0]):, :] = 0.0
        neigh[j, :, int(own[j, 1]):] = 0.0
    ry, rx = np.mgrid[0:H, 0:W]
    ref = 0.5 + 0.3 * np.cos(0.29 * rx - 0.17 * ry) + 0.2 * rng.random((H, W))
    depths = rng.uniform(2.0, 6.0, (K, H, W))
    dzx = rng.normal(0, 0.02, (K, H, W))
    dzy = rng.normal(0, 0.02, (K, H, W))
    if special:
        flat = depths.reshape(-1), dzx.reshape(-1), dzy.reshape(-1)
        picks = rng.choice(K * H * W, 14, replace=False)
        for i, (arr, val) in zip(picks, [(0, math.nan), (0, math.inf), (0, -math.inf), (0, 0.0),
                                         (0, -1.0), (0, 0.03), (1, math.inf), (1, math.nan),
                                         (2, -math.inf), (2, math.nan), (1, 1.5), (2, -1.5),
                                         (1, 1e30), (0, 1e-30)]):
            flat[arr][i] = val
    if lead == "all":
        jidx = np.arange(J, dtype=np.int64)[:, None, None, None]
    else:
        jidx = rng.integers(0, J, (4 if J > 4 else J - 1, H, W)).astype(np.int64)[:, None]
    return dict(ref_img=ref.astype(F32), neigh_imgs=neigh.astype(F32), T=T.astype(F32),
                tvec=tvec.astype(F32), hw=None if form[7] is None else own, jidx=jidx,
                ray_z=rng.uniform(0.8, 1.0, (H, W)).astype(F32), depths=depths.astype(F32),
                dzx=dzx.astype(F32), dzy=dzy.astype(F32), filter_width=FW)


def to_torch(args, device="cpu"):
    return {k: torch.from_numpy(v).to(device) if isinstance(v, np.ndarray) else v
            for k, v in args.items()}
