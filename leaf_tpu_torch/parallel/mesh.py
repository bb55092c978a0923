"""Device mesh and batch layouts for data parallelism.

``leaf_tpu.parallel.mesh`` in the port. The JAX package runs one SPMD
program over a ``jax.sharding.Mesh``; PyTorch runs one process per device,
so the mesh here is a ``torch.distributed`` ``DeviceMesh`` over the ranks
of the default process group, with dims named ``("data",)`` or
``("data", "model")``. The shardings become DTensor placements:
``Shard(0)`` for a batch, ``Shard(1)`` for a K-stacked batch,
``Replicate()`` for parameters. Parameters live as plain replicated
tensors in each process (``shard_params`` makes and checks the copies);
no ``DistributedDataParallel`` wrapper is used, so ``state_dict`` keys stay
the single-device ones.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from leaf_tpu_torch.parallel.distributed import rank, world_size

__all__ = ["make_mesh", "batch_sharding", "stacked_batch_sharding",
           "replicated_sharding", "shard_batch", "shard_params",
           "local_batch_slice", "loader_batch_size", "data_rank"]


def loader_batch_size(cfg_batch_size: int, n_devices: int,
                      process_count: Optional[int] = None,
                      mode: str = "per_device") -> int:
    """Per-PROCESS loader batch size under the chosen batch semantics.

    mode='per_device' (default — reference parity): cfg ``opt.batch_size``
    counts clips PER DEVICE, as in the reference, where each of N
    processes runs its own ``DataLoader(batch_size)`` over a
    DistributedSampler shard (reference train_xla.py:176,192-194).
    mode='global': cfg batch_size is the GLOBAL batch, split over the
    devices. On one device the modes coincide. ``process_count`` defaults
    to the world size: here a process is a device.
    """
    if process_count is None:
        process_count = world_size()
    if mode == "per_device":
        global_batch = cfg_batch_size * n_devices
    elif mode == "global":
        global_batch = cfg_batch_size
    else:
        raise ValueError(f"unknown batch_mode {mode!r} "
                         "(expected 'per_device' or 'global')")
    if global_batch % max(1, process_count):
        raise ValueError(
            f"global batch {global_batch} not divisible by "
            f"{process_count} processes")
    if global_batch % max(1, n_devices):
        raise ValueError(
            f"global batch {global_batch} not divisible by "
            f"{n_devices} devices")
    return global_batch // max(1, process_count)


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              device_type: Optional[str] = None):
    """1-D ('data',) or 2-D ('data', 'model') ``DeviceMesh`` over the
    default process group's ranks (``n_devices`` defaults to, and must
    equal, the world size). ``device_type`` defaults to 'cuda' under
    NCCL and 'cpu' otherwise."""
    from torch.distributed.device_mesh import init_device_mesh
    n = world_size() if n_devices is None else n_devices
    if n % model_parallel != 0:
        raise ValueError(
            f"{n} devices not divisible by model_parallel={model_parallel}")
    if n != world_size():
        raise ValueError(f"a mesh of {n} devices needs {n} processes, "
                         f"the world has {world_size()}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if model_parallel > 1:
        return init_device_mesh(device_type, (n // model_parallel,
                                              model_parallel),
                                mesh_dim_names=("data", "model"))
    return init_device_mesh(device_type, (n,), mesh_dim_names=("data",))


def _placements(mesh, data):
    from torch.distributed.tensor import Replicate
    return tuple(data if name == "data" else Replicate()
                 for name in mesh.mesh_dim_names)


def batch_sharding(mesh) -> tuple:
    """The batch axis (0) split over 'data', replicated over 'model'."""
    from torch.distributed.tensor import Shard
    return _placements(mesh, Shard(0))


def stacked_batch_sharding(mesh) -> tuple:
    """A K-stacked batch (K, B, ...): the batch axis (1) split over
    'data' — the layout ``make_train_multistep`` takes."""
    from torch.distributed.tensor import Shard
    return _placements(mesh, Shard(1))


def replicated_sharding(mesh) -> tuple:
    from torch.distributed.tensor import Replicate
    return _placements(mesh, Replicate())


def data_rank(mesh) -> tuple:
    """(this process's index along 'data', the 'data' size)."""
    return (mesh.get_local_rank("data"),
            mesh.size(mesh.mesh_dim_names.index("data")))


def shard_batch(mesh, batch, stacked: bool = False):
    """This process's rows of a GLOBAL batch: every array (tensor or
    numpy) of a tuple / list / dict, split on its batch axis (0, or 1
    with ``stacked``) over 'data'. The train CLI's loader already yields
    each process its own rows (``ShardedSampler``), so it does not call
    this."""
    axis = 1 if stacked else 0
    index, n = data_rank(mesh)

    def take(x):
        if isinstance(x, (tuple, list)):
            return type(x)(take(v) for v in x)
        if isinstance(x, dict):
            return {k: take(v) for k, v in x.items()}
        b = x.shape[axis]
        if b % n:
            raise ValueError(f"batch of {b} not divisible by {n} devices")
        sl = local_batch_slice(b, index, n)
        return x[sl] if axis == 0 else x[:, sl]

    return take(batch)


@torch.no_grad()
def shard_params(mesh, module: nn.Module) -> float:
    """Replicate ``module``'s parameters and buffers from the first rank
    of 'data' to every rank, in place, one flat broadcast per dtype.

    Returns the largest absolute difference any replica had from that
    rank before the copy, over all ranks (0.0: they agreed): a restore
    that loaded on every rank checks this is 0."""
    group = mesh.get_group("data")
    src = dist.get_global_rank(group, 0)
    tensors = list(module.parameters()) + list(module.buffers())
    worst = torch.zeros((), dtype=torch.float64)
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        theirs = flat.clone()
        dist.broadcast(theirs, src, group=group)
        if flat.numel():
            worst = torch.maximum(worst, (flat.double() - theirs.double())
                                  .abs().max().cpu())
        off = 0
        for t in ts:
            t.copy_(theirs[off:off + t.numel()].view_as(t))
            off += t.numel()
    worst = worst.to(tensors[0].device if tensors else "cpu")
    dist.all_reduce(worst, op=dist.ReduceOp.MAX, group=group)
    return float(worst)


def local_batch_slice(global_batch_size: int,
                      process_index: Optional[int] = None,
                      process_count: Optional[int] = None) -> slice:
    """Rows of a global batch for this process — the analogue of the
    reference's DistributedSampler(rank) (training_utils.py:13-19)."""
    if process_index is None:
        process_index = rank()
    if process_count is None:
        process_count = world_size()
    per = global_batch_size // process_count
    return slice(process_index * per, (process_index + 1) * per)
