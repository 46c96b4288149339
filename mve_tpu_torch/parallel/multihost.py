"""Several processes: start-up, work-list sharding and the process-group
mesh (port of mve_tpu/parallel/multihost.py).

The reference has no distributed story; scale-out is running apps per
view on shared storage. View-parallel stages (features, matching pairs,
MVS reference views, depth-map fusion) partition their work lists by
process index and exchange results through files, like the reference's
restartable per-view artifacts. Several processes may share one card.
The tightly coupled stage, bundle adjustment, can instead run as one
program over a global mesh with one shard per process, its sums
all-reduced (distributed_ba.py); so can the FSSR evaluation.

Every process calls initialize() first, with explicit arguments or with
JAX_COORDINATOR, JAX_NUM_PROCESSES and JAX_PROCESS_ID, the names mve_tpu
reads, so that one launcher drives both packages. After it, my_shard's
defaults are the group's rank and size.
"""

from __future__ import annotations

import os
from typing import Sequence

import torch
import torch.distributed as dist

from .mesh import Mesh, _to

# The backend that carries collectives on each device type. There is no
# other choice and no switch on failure.
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def process_id_from_env() -> int:
    return int(os.environ.get("JAX_PROCESS_ID", 0))


def num_processes_from_env() -> int:
    return int(os.environ.get("JAX_NUM_PROCESSES", 1))


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, device="cuda",
               backend: str | None = None) -> None:
    """Join the torch.distributed world (no-op for one process or when the
    default group is already up).

    coordinator is host:port (JAX_COORDINATOR's form) or an init-method
    URL such as file:///shared/path. The backend is NCCL for a CUDA
    device and gloo for the CPU, unless `backend` names one (gloo also
    carries CUDA tensors, and lets several processes share one card)."""
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = num_processes_from_env()
    if num_processes is None or num_processes <= 1 or dist.is_initialized():
        return
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR")
    if not coordinator:
        raise ValueError("several processes need a coordinator (JAX_COORDINATOR=host:port)")
    if "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    dist.init_process_group(
        backend or BACKENDS[torch.device(device).type], init_method=coordinator,
        world_size=num_processes,
        rank=process_id if process_id is not None else process_id_from_env())


def my_shard(items: Sequence, process_id: int | None = None,
             num_processes: int | None = None):
    """This process's share of a work list: every num_processes-th item
    from position process_id (the distributed analog of the reference's
    OpenMP dynamic loops). The defaults are the group's rank and size
    after initialize(), JAX_PROCESS_ID and JAX_NUM_PROCESSES before."""
    up = dist.is_initialized()
    pid = process_id if process_id is not None else (
        dist.get_rank() if up else process_id_from_env())
    n = num_processes if num_processes is not None else (
        dist.get_world_size() if up else num_processes_from_env())
    return [item for i, item in enumerate(items) if i % n == pid]


class ProcessGroupMesh(Mesh):
    """One shard per process of the default torch.distributed group, all
    on `device` as this process sees it; this process holds shard `rank`.
    Its sums are collectives."""

    def __init__(self, device):
        super().__init__([device] * dist.get_world_size())
        self.rank = dist.get_rank()

    @property
    def local_shards(self) -> list:
        return [self.rank]

    def reduce_sum(self, partials):
        """All-reduce of this process's partial (a tensor, or a tuple of
        tensors of one dtype sent as one buffer); every process gets the
        same sum."""
        self.reductions += 1
        (part,) = partials
        part = _to(part, self.device)
        if not isinstance(part, tuple):
            out = part.clone()
            dist.all_reduce(out)
            return out
        flat = torch.cat([t.reshape(-1) for t in part])
        dist.all_reduce(flat)
        return tuple(x.view(t.shape) for x, t in zip(flat.split([t.numel() for t in part]), part))

    def gather_rows(self, parts) -> torch.Tensor:
        """Every process's rows in row order: an all-reduce of a zero
        buffer in which this process wrote its own rows. x + 0 is x, so it
        is exact but for -0.0, which becomes +0.0 (a float64 accumulator
        that starts at +0.0 gets the same bits either way). gloo
        all-reduces CUDA tensors; its all-gather does not."""
        (part,) = parts
        n = part.shape[0]
        buf = part.new_zeros((n * self.size,) + tuple(part.shape[1:]))
        buf[self.rank * n:(self.rank + 1) * n] = part
        dist.all_reduce(buf)
        return buf


def global_mesh(device="cuda"):
    """A mesh with one shard per process of the torch.distributed world
    (initialize() first). A CUDA device means this process's card,
    cuda:(rank mod the local device count). Without a process group there
    is one process: a one-shard mesh on `device`."""
    dev = torch.device(device)
    if not dist.is_initialized():
        return Mesh([dev])
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
    return ProcessGroupMesh(dev)
