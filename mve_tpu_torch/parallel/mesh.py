"""Meshes of shards and the few collectives the sharded stages use (port
of mve_tpu/parallel/mesh.py).

A mesh is a 1-D ordered list of shards, each on an explicit device. The
bundle adjustment and the FSSR evaluation never ask which kind of mesh
they have; they use shard_batch, replicate, reduce_sum and gather_rows.

- Mesh (here): every shard in this process. A device may be named more
  than once, so several shards can share one card or the CPU.
  reduce_sum adds the partials in shard order on the mesh's first
  device, ((p0 + p1) + p2) + ..., a fixed order and so a deterministic
  result; gather_rows concatenates the shards' rows there.
- multihost.ProcessGroupMesh: one shard per process of the
  torch.distributed world group; reduce_sum is an all-reduce.

Replicated values (cameras, points, scalars) live on the mesh's device;
a shard on another device gets a copy when it needs one.
"""

from __future__ import annotations

import numpy as np
import torch


def _as_tensor(arr) -> torch.Tensor:
    return arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.asarray(arr, order="C"))


def _split_rows(arr, size: int, shards) -> list:
    """The rows of each listed shard of `size`, as views of arr."""
    t = _as_tensor(arr)
    if t.shape[0] % size:
        raise ValueError(f"the leading axis ({t.shape[0]}) must divide by the mesh size ({size})")
    n = t.shape[0] // size
    return [t[k * n:(k + 1) * n] for k in shards]


def _add(a, b):
    """a + b for tensors or for tuples of tensors, elementwise."""
    if isinstance(a, tuple):
        return tuple(x + y for x, y in zip(a, b))
    return a + b


def _to(x, device):
    if isinstance(x, tuple):
        return tuple(t.to(device) for t in x)
    return x.to(device)


class Mesh:
    """Shards in this process, one per entry of `devices`, in order."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        #: reduce_sum calls since the mesh was made (one per collective).
        self.reductions = 0

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """Where replicated values and the results of collectives live."""
        return self.devices[0]

    @property
    def local_shards(self) -> list:
        """The indices of the shards this process holds."""
        return list(range(self.size))

    def local_devices(self) -> list:
        return [self.devices[k] for k in self.local_shards]

    def shard_batch(self, arr) -> list:
        return [t.to(d) for t, d in zip(_split_rows(arr, self.size, self.local_shards),
                                        self.local_devices())]

    def replicate(self, arr) -> torch.Tensor:
        return _as_tensor(arr).to(self.device)

    def reduce_sum(self, partials):
        """The sum of the local shards' partials (tensors, or tuples of
        tensors summed elementwise), on self.device. One partial is
        returned as it is: a one-shard mesh gives the unsharded bits."""
        self.reductions += 1
        total = _to(partials[0], self.device)
        for p in partials[1:]:
            total = _add(total, _to(p, self.device))
        return total

    def gather_rows(self, parts) -> torch.Tensor:
        """The local shards' rows, in row order, on self.device. One
        shard's rows are returned as they are, with no copy."""
        if len(parts) == 1:
            return parts[0].to(self.device)
        return torch.cat([p.to(self.device) for p in parts])


def get_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A mesh over `devices` (default: every local CUDA device, as
    jax.devices() spans every local device), cut to the first n_devices.
    There is no CPU default: pass devices=["cpu"] * k for k CPU shards."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass devices=['cpu', ...] for CPU shards")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"asked for {n_devices} shards of {len(devices)} devices")
        devices = devices[:n_devices]
    return Mesh(devices)


def shard_batch(mesh, arr) -> list:
    """This process's shards of arr's leading axis, each on its device."""
    return mesh.shard_batch(arr)


def replicate(mesh, arr) -> torch.Tensor:
    return mesh.replicate(arr)


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0, value=0):
    n = arr.shape[axis]
    target = (n + multiple - 1) // multiple * multiple
    if target == n:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, target - n)
    return np.pad(arr, widths, constant_values=value)
