"""Several devices and several processes (port of mve_tpu/parallel).

- mesh: a 1-D mesh of shards on explicit devices (get_mesh, shard_batch,
  replicate, pad_to_multiple) with the collectives the sharded stages
  use (reduce_sum, gather_rows);
- multihost: torch.distributed start-up (initialize), the work-list
  sharding of the view-parallel stages (my_shard) and the process-group
  mesh (global_mesh);
- distributed_ba: bundle adjustment with its observations sharded over a
  mesh (lm_optimize_distributed, distributed_ba_step). sfmrecon uses it
  over every local card when there are several; fssr/block_eval shards
  its dispatch batches over a mesh with no collective but the gather.
"""

from .mesh import get_mesh, shard_batch, replicate
from .distributed_ba import distributed_ba_step

__all__ = ["get_mesh", "shard_batch", "replicate", "distributed_ba_step"]
