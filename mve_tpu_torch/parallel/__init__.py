"""Multi-process helpers (port of mve_tpu/parallel; only the work-list
sharding so far: multihost.my_shard)."""
