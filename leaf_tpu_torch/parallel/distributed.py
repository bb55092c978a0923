"""Process groups and the few collectives the data-parallel loop needs.

The counterpart of the JAX ``train.py``'s ``jax.distributed.initialize``
and of ``jax.experimental.multihost_utils``. PyTorch's idiom is one
process per device: ``torchrun`` (``python -m torch.distributed.run``)
starts them and sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``. The JAX CLI's variables
(``LEAF_COORDINATOR`` = host:port, ``LEAF_NUM_PROCESSES``,
``LEAF_PROCESS_ID``) are read as well.

The data group runs NCCL on the card and gloo on the CPU. Beside it,
``init_distributed`` makes a gloo group for host-side agreement (the
preemption flag, the batch shapes of a K-step group, the val metric's
rows): those collectives never wait on the card's stream.

Every helper is the identity (or a local answer) when no process group
exists, so a single-device run calls them unchanged. gloo reduces CUDA
tensors (through the host) but cannot gather them, so ``all_gather_rows``
gathers with one summed ``all_reduce`` of a zero buffer in which each
rank fills its own rows.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from leaf_tpu_torch import resolve_device

__all__ = ["init_distributed", "join_world", "shutdown_distributed",
           "launched", "launch_hint", "data_group", "host_group", "rank",
           "world_size", "all_reduce_sum_", "all_reduce_mean_",
           "all_gather_rows", "any_rank", "barrier"]

_HOST_GROUPS: dict = {}   # default group → its gloo twin (NCCL only)


def launched() -> bool:
    """Whether a launcher set this process's rank (torchrun, or the JAX
    CLI's LEAF_* variables)."""
    return ("WORLD_SIZE" in os.environ and "RANK" in os.environ) or (
        "LEAF_COORDINATOR" in os.environ)


def launch_hint(module: str, n: int) -> str:
    """The command line that starts ``n`` ranks of ``module``."""
    return (f"start one process per device with torchrun: python -m "
            f"torch.distributed.run --nproc_per_node {n} -m {module} ... "
            f"--n_devices {n}")


def init_distributed(device: str = "cuda", backend: Optional[str] = None,
                     timeout: Optional[timedelta] = None
                     ) -> Tuple[int, int, torch.device]:
    """Join the process group the launcher describes; (rank, world, device).

    ``device`` 'cuda' gives ``cuda:LOCAL_RANK`` (made the current device)
    and NCCL, 'cpu' gives the CPU and gloo; ``backend`` overrides the
    choice (gloo on the card is for correctness runs: it moves every
    tensor through the host). A process group that exists already is
    kept. Raises RuntimeError when no launcher set the rank."""
    if dist.is_initialized():
        r, w = dist.get_rank(), dist.get_world_size()
        return r, w, _rank_device(device, r)
    env = os.environ
    if "WORLD_SIZE" in env and "RANK" in env:
        r, w, init = int(env["RANK"]), int(env["WORLD_SIZE"]), "env://"
    elif "LEAF_COORDINATOR" in env:
        r, w = int(env["LEAF_PROCESS_ID"]), int(env["LEAF_NUM_PROCESSES"])
        init = f"tcp://{env['LEAF_COORDINATOR']}"
    else:
        raise RuntimeError("no launcher set this process's rank; "
                           + launch_hint("leaf_tpu_torch.train", 2))
    dev = _rank_device(device, r)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init, world_size=w, rank=r,
                            timeout=timeout, **kw)
    if backend == "nccl":
        _HOST_GROUPS[dist.group.WORLD] = dist.new_group(backend="gloo")
    return r, w, dev


def join_world(module: str, device: str, n_devices: Optional[int] = None,
               multihost: bool = False) -> Tuple[int, int, torch.device]:
    """(rank, world, device) of a CLI process: a data-parallel rank when a
    launcher started it, ``multihost`` is set or ``n_devices`` > 1 (which
    then needs a launcher: the error names the torchrun command of
    ``module``), else (0, 1, the one device)."""
    device = resolve_device(device)
    n = n_devices or 1
    if not (multihost or launched() or n > 1):
        return 0, 1, device
    if not launched():
        raise RuntimeError(f"--n_devices {n}{' --multihost' * multihost} "
                           f"without a launcher: {launch_hint(module, n)}")
    r, w, device = init_distributed(device.type)
    if n_devices is not None and n_devices != w:
        shutdown_distributed()
        raise ValueError(f"--n_devices {n_devices} but the launcher started "
                         f"{w} processes")
    return r, w, device


def _rank_device(device: str, r: int) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = os.environ.get("LOCAL_RANK")
    n = torch.cuda.device_count()
    return torch.device("cuda", int(local) if local is not None
                        else r % max(1, n))


def shutdown_distributed() -> None:
    """Leave the process group (and its host twin), if there is one."""
    if dist.is_initialized():
        _HOST_GROUPS.clear()
        dist.destroy_process_group()


def data_group():
    """The default process group, or None without one (one device)."""
    return dist.group.WORLD if dist.is_initialized() else None


def host_group(group=None):
    """The gloo group for host-side collectives over ``group``'s ranks:
    the group itself unless it runs NCCL. None without a process group."""
    group = group or data_group()
    if group is None:
        return None
    return _HOST_GROUPS.get(group, group)


def rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def world_size(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def all_reduce_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Σ over the ranks, in place; returns ``t``."""
    if dist.is_initialized():
        dist.all_reduce(t, group=group)
    return t


def all_reduce_mean_(t: torch.Tensor, group=None) -> torch.Tensor:
    """The mean over the ranks, in place (a sum, then ÷ world: gloo has
    no AVG); returns ``t``."""
    all_reduce_sum_(t, group)
    return t.div_(world_size(group))


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's rows of ``t`` (dim 0; the row counts may differ, the
    other dims may not), concatenated in rank order, on every rank."""
    w = world_size(group)
    if w == 1:
        return t
    r = rank(group)
    counts = torch.zeros(w, dtype=torch.int64, device=t.device)
    counts[r].fill_(t.shape[0])
    dist.all_reduce(counts, group=group)
    counts = counts.tolist()
    buf = t.new_zeros((w, max(counts)) + tuple(t.shape[1:]))
    buf[r, :t.shape[0]] = t
    dist.all_reduce(buf, group=group)
    return torch.cat([buf[i, :n] for i, n in enumerate(counts)])


def any_rank(flag: bool, group=None) -> bool:
    """Whether ``flag`` is true on any rank (over the host group)."""
    hg = host_group(group)
    if hg is None:
        return bool(flag)
    t = torch.tensor([1 if flag else 0], dtype=torch.int64)
    dist.all_reduce(t, group=hg)
    return bool(t.item())


def barrier(group=None) -> None:
    """Wait for every rank (over the host group)."""
    hg = host_group(group)
    if hg is not None:
        dist.barrier(group=hg)
