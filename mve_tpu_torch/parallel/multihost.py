"""Work-list sharding across processes (port of the sharding part of
mve_tpu/parallel/multihost.py).

The reference has no distributed story; scale-out is running apps per
view on shared storage. View-parallel stages (features, matching pairs,
MVS reference views, depth-map fusion) partition their work lists by
process index and exchange results through files, like the reference's
restartable per-view artifacts. Several processes may share one card.

A process's index and the process count come from the caller or, when it
gives none, from JAX_PROCESS_ID and JAX_NUM_PROCESSES: the names mve_tpu
reads, so that one launcher drives both packages. mve_tpu's initialize
and global_mesh (jax.distributed) are not ported here: they belong to
the several-GPU work of ROADMAP.md item 14.
"""

from __future__ import annotations

import os
from typing import Sequence


def process_id_from_env() -> int:
    return int(os.environ.get("JAX_PROCESS_ID", 0))


def num_processes_from_env() -> int:
    return int(os.environ.get("JAX_NUM_PROCESSES", 1))


def my_shard(items: Sequence, process_id: int | None = None,
             num_processes: int | None = None):
    """This process's share of a work list: every num_processes-th item
    from position process_id (the distributed analog of the reference's
    OpenMP dynamic loops)."""
    pid = process_id if process_id is not None else process_id_from_env()
    n = num_processes if num_processes is not None else num_processes_from_env()
    return [item for i, item in enumerate(items) if i % n == pid]
