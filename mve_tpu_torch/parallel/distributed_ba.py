"""Bundle adjustment with the observations sharded over a mesh (port of
mve_tpu/parallel/distributed_ba.py).

Cameras, points and scalars are replicated; the observation tensors
(obs, cam_idx, pt_idx, obs_valid) are split along their leading axis,
one block of rows per shard, and each shard groups its own rows
(core.ObservationLayout). The LM loop is core's own: the observation
work (residuals and Jacobians, the four Hessian and gradient sums, the
MSE, and E^T y and E z in every CG iteration) runs on each shard, and
each sum over observations is the mesh's reduce_sum of the shards'
partial sums. The PCG, the 9x9 and 3x3 inverses and the trust-region
update run on the replicated values as on one device. Per CG iteration
that is two reductions; per LM step four more (the system, the
right-hand side, the back-substitution, the new MSE).

A one-shard mesh runs the operations of the unsharded BA, bit for bit.
With k shards the sums add in another order: in this process the
partials add in shard order, ((p0 + p1) + p2) + p3; over a process
group, in the all-reduce's order (two terms add to the same bits in
either order).
"""

from __future__ import annotations

import numpy as np
import torch

from ..sfm.ba import core as ba_core
from .mesh import _split_rows


def _host(arr) -> np.ndarray:
    return arr.cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)


def _shards(mesh, obs, cam_idx, pt_idx, obs_valid, n_cams: int, n_points: int):
    """The observations split over mesh, each shard with its layout. The
    index rows are split on the host, where the layouts are built, and
    then moved to their shard's device."""
    shards = []
    host_rows = (_split_rows(_host(a), mesh.size, mesh.local_shards)
                 for a in (cam_idx, pt_idx, obs_valid))
    for d, o, c, p, v in zip(mesh.local_devices(), mesh.shard_batch(obs), *host_rows):
        layout = ba_core.ObservationLayout(c.numpy(), p.numpy(), n_cams, n_points, d, v.numpy())
        shards.append(ba_core.Shard(o, c.long().to(d), p.long().to(d), v.to(d), layout))
    return ba_core.ObservationShards(shards, mesh)


def _params(mesh, intr, trans, rot, points):
    return tuple(mesh.replicate(a) for a in (intr, trans, rot, points))


def lm_optimize_distributed(mesh, intr, trans, rot, points,
                            obs, cam_idx, pt_idx, obs_valid, num_valid, **opts):
    """The full LM trust-region loop (core.lm_optimize's keyword options)
    with observations sharded over `mesh` and parameters replicated. The
    observation axis must divide by mesh.size (lm.optimize_arrays pads it
    so). Inputs are numpy arrays or tensors, each process of a process
    group passing all of them.

    Returns (intr, trans, rot, points, status) on mesh.device."""
    intr, trans, rot, points = _params(mesh, intr, trans, rot, points)
    shards = _shards(mesh, obs, cam_idx, pt_idx, obs_valid, intr.shape[0], points.shape[0])
    return ba_core.lm_optimize_sharded(intr, trans, rot, points, shards,
                                       mesh.replicate(num_valid), **opts)


def distributed_ba_step(mesh, intr, trans, rot, points,
                        obs, cam_idx, pt_idx, obs_valid, trr,
                        cg_max_iter: int = 100):
    """One LM linear step (mode 3) with observations sharded over `mesh`:
    build the system, solve the Schur complement, apply the update.

    Returns (intr, trans, rot, points, mse) with the new parameters and
    their MSE over the valid observations, on mesh.device."""
    params = _params(mesh, intr, trans, rot, points)
    shards = _shards(mesh, obs, cam_idx, pt_idx, obs_valid, params[0].shape[0],
                     params[3].shape[0])
    per, B, Cb, v, w = ba_core.build_system_sharded(params, shards, mode=3)
    delta_cam, delta_pt, _, _ = ba_core.solve_schur_sharded(
        per, shards, B, Cb, v, w, mesh.replicate(trr), cg_max_iter=cg_max_iter)
    new = ba_core.apply_update(*params, delta_cam, delta_pt)
    return (*new, ba_core.mse_sharded(new, shards, mesh.replicate(obs_valid).sum()))
