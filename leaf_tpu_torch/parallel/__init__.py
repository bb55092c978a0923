"""Data parallelism (``leaf_tpu.parallel`` in the port): one process per
device, explicit collectives on the port's own train state and no
``DistributedDataParallel`` wrapper, so ``state_dict`` keys stay the
single-device (leaf-pytorch) ones.

- ``distributed``: the process group (``init_distributed``; NCCL on the
  card, gloo on the CPU) and the loop's collectives;
- ``mesh``: the ``DeviceMesh``, batch layouts, ``loader_batch_size``,
  ``shard_params``;
- ``sync_batch_norm``: global-batch BatchNorm, the GSPMD semantic of
  ``make_train_step(process_group=...)``;
- ``shard_step``: the per-replica step (``make_shard_map_train_step``).
"""

from leaf_tpu_torch.parallel.distributed import (  # noqa: F401
    all_gather_rows,
    all_reduce_mean_,
    all_reduce_sum_,
    any_rank,
    barrier,
    data_group,
    host_group,
    init_distributed,
    join_world,
    launch_hint,
    launched,
    rank,
    shutdown_distributed,
    world_size,
)
from leaf_tpu_torch.parallel.mesh import (  # noqa: F401
    batch_sharding,
    loader_batch_size,
    local_batch_slice,
    make_mesh,
    replicated_sharding,
    shard_batch,
    shard_params,
    stacked_batch_sharding,
)
from leaf_tpu_torch.parallel.shard_step import (  # noqa: F401
    make_shard_map_train_step,
)


__all__ = [
    "init_distributed", "join_world", "shutdown_distributed", "launched",
    "launch_hint", "data_group", "host_group", "rank", "world_size",
    "all_reduce_sum_", "all_reduce_mean_", "all_gather_rows", "any_rank",
    "barrier", "make_mesh", "batch_sharding", "stacked_batch_sharding",
    "replicated_sharding", "shard_batch", "shard_params",
    "local_batch_slice", "loader_batch_size", "make_shard_map_train_step",
]
