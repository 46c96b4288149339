"""Levenberg-Marquardt loop (reference: bundle_adjustment.cc:26-201;
port of mve_tpu/sfm/ba/lm.py).

The trust-region loop is core.lm_optimize_sharded, run by
parallel.distributed_ba over the BA's mesh (by default one shard on the
caller's device, the operations of the unsharded loop): trust region 1000 at the
start, halved on a failed step; on success TRR *= 1 / max(1/3,
1 - (2g - 1)^3) with g = delta_mse * num_obs / predicted_decrease.

The problem is padded as mve_tpu pads it: power-of-two buckets, or the
run-wide minimum pads an incremental SfM sets, with padded cameras at
f = 1 and the identity rotation and padded points at z = 1. There is no
compile to amortise here, but PCG's iteration cap is 9 C with the padded
C, so an unpadded problem would stop CG at another count than mve_tpu.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from ... import resolve_device
from ...parallel import distributed_ba
from ...parallel.mesh import Mesh
from .problem import BAProblem, BundleMode


@dataclasses.dataclass
class BAOptions:
    """bundle_adjustment.h:61-74 + :139-147 defaults."""

    bundle_mode: BundleMode = BundleMode.CAMERAS_AND_POINTS
    fixed_intrinsics: bool = False
    lm_max_iterations: int = 50
    # Read only with verbose_output, as in mve_tpu (see BundleAdjustment).
    lm_min_iterations: int = 0
    lm_delta_threshold: float = 1e-4
    lm_mse_threshold: float = 1e-8
    cg_max_iterations: int = 1000
    verbose_output: bool = False
    # float32 or float64, on whichever device the caller gives.
    dtype: object = np.float32
    # A mesh (mve_tpu_torch.parallel): shard the observation axis over it
    # and run the LM loop with its sums reduced over the shards
    # (parallel/distributed_ba.py); the mesh's devices take the place of
    # `device`. None = one shard on `device`.
    mesh: object = None
    # Minimum padded sizes for (cameras, points, observations). An
    # incremental SfM run sets these to its tier of the final problem
    # bound; 0 = plain power-of-two bucketing per call.
    pad_cameras: int = 0
    pad_points: int = 0
    pad_observations: int = 0


@dataclasses.dataclass
class BAStatus:
    """bundle_adjustment.h:76-87."""

    initial_mse: float = 0.0
    final_mse: float = 0.0
    num_lm_iterations: int = 0
    num_lm_successful_iterations: int = 0
    num_lm_unsuccessful_iterations: int = 0
    num_cg_iterations: int = 0
    runtime_ms: int = 0


def _pad(arr, n, axis=0):
    pad_n = n - arr.shape[axis]
    if pad_n <= 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad_n)
    return np.pad(arr, widths)


def _bucket(n, minimum=64):
    """Next power of two at or above n, at least `minimum`."""
    size = minimum
    while size < n:
        size *= 2
    return size


def optimize_arrays(intr_np, trans_np, rot_np, points_np,
                    obs_np, cam_idx_np, pt_idx_np,
                    opts: BAOptions, device="cuda", report=None) -> tuple:
    """Array-level LM optimisation.

    Inputs are unpadded numpy arrays: intr (C,3) [f,k0,k1], trans (C,3),
    rot (C,3,3), points (P,3), obs (O,2), cam_idx (O,), pt_idx (O,).
    Returns (intr, trans, rot, points, BAStatus) with the same unpadded
    shapes (float64).

    report: None (mve_tpu's optimize_arrays: the loop paced by the
    device, lm_min_iterations not read), or a callable that takes each
    line of the host-driven verbose loop (core.lm_optimize_sharded).
    """
    t0 = time.perf_counter()
    mesh = opts.mesh or Mesh([resolve_device(device)])
    dtype = np.dtype(opts.dtype)
    mode = int(opts.bundle_mode)

    C, P, O = len(intr_np), len(points_np), len(obs_np)
    Cp = max(_bucket(C, 16), opts.pad_cameras)
    Pp = max(_bucket(P, 256), opts.pad_points)
    Op = max(_bucket(O, 512), opts.pad_observations)
    Op = (Op + mesh.size - 1) // mesh.size * mesh.size  # the shards split O evenly

    intr = np.ascontiguousarray(_pad(intr_np, Cp), dtype)
    # Padded cameras get f=1 so the residual function stays finite.
    if Cp > C:
        intr[C:, 0] = 1.0
    trans = np.ascontiguousarray(_pad(trans_np, Cp), dtype)
    rot = _pad(rot_np, Cp).astype(dtype)
    rot[C:] = np.eye(3)
    points = np.ascontiguousarray(_pad(points_np, Pp), dtype)
    if Pp > P:
        points[P:, 2] = 1.0
    obs = np.ascontiguousarray(_pad(obs_np, Op), dtype)
    cam_idx = np.pad(np.asarray(cam_idx_np, np.int64), (0, Op - O))
    pt_idx = np.pad(np.asarray(pt_idx_np, np.int64), (0, Op - O))

    obs_valid = np.arange(Op) < O
    kwargs = dict(mode=mode, fixed_intrinsics=opts.fixed_intrinsics,
                  max_iters=opts.lm_max_iterations, cg_max_iter=opts.cg_max_iterations,
                  lm_delta_threshold=opts.lm_delta_threshold,
                  lm_mse_threshold=opts.lm_mse_threshold,
                  min_iters=opts.lm_min_iterations, report=report)
    rot = np.ascontiguousarray(rot)
    num_valid = np.asarray(float(O), dtype)
    ii, tt, rr, pp, st = distributed_ba.lm_optimize_distributed(
        mesh, intr, trans, rot, points, obs, cam_idx, pt_idx, obs_valid, num_valid, **kwargs)
    st = st.cpu().numpy().astype(np.float64)
    status = BAStatus(
        initial_mse=float(st[0]), final_mse=float(st[1]),
        num_lm_iterations=int(st[2]), num_lm_successful_iterations=int(st[3]),
        num_lm_unsuccessful_iterations=int(st[4]), num_cg_iterations=int(st[5]))

    def back(x, n):
        return x[:n].cpu().numpy().astype(np.float64)

    out = (back(ii, C), back(tt, C), back(rr, C), back(pp, P))
    status.runtime_ms = int((time.perf_counter() - t0) * 1000)
    return out + (status,)


class BundleAdjustment:
    """Mirrors sfm::ba::BundleAdjustment (bundle_adjustment.h:51-134).

    float64 (BAOptions.dtype) runs on the same device as float32. With
    verbose_output the host drives the loop as in mve_tpu: one printed
    line per LM step and one for the stop, the trust region in host
    float64, and lm_min_iterations honoured. Without it the loop is the
    one optimize_arrays runs, and lm_min_iterations is not read."""

    def __init__(self, options: BAOptions | None = None, device="cuda"):
        self.opts = options or BAOptions()
        self.device = resolve_device(device)
        self.status = BAStatus()

    def optimize(self, problem: BAProblem) -> BAStatus:
        intr, trans, rot, _ = problem.camera_arrays()
        points, _ = problem.point_array()
        obs, cam_idx, pt_idx = problem.observation_arrays()
        ii, tt, rr, pp, self.status = optimize_arrays(
            intr, trans, rot, points, obs, cam_idx, pt_idx, self.opts, self.device,
            report=print if self.opts.verbose_output else None)
        problem.update_from_arrays(ii, tt, rr, pp)
        return self.status

    def print_status(self) -> None:
        s = self.status
        print(f"BA: MSE {s.initial_mse} -> {s.final_mse}, "
              f"{s.num_lm_iterations} LM iters ({s.num_lm_successful_iterations} ok, "
              f"{s.num_lm_unsuccessful_iterations} fail), "
              f"{s.num_cg_iterations} CG iters, {s.runtime_ms} ms")
