"""The data-parallel train step's collectives (the GSPMD semantic).

``training.steps.make_train_step(process_group=...)`` and
``make_train_multistep(process_group=...)`` run the step body on each
rank's rows of the global batch with global-batch BatchNorm
(``sync_batch_norm``), and:

- before the backward, one ``all_reduce`` of the row counts: each rank's
  loss is scaled by its share n_r / N, so the gradient is the global
  batch's mean even when one rank's batch is short (a packed shard);
- after it, one ``all_reduce`` of one flat bucket holding every gradient,
  the scaled loss and the count of correct clips.

Every rank then holds the same gradients, the global mean loss and the
global sums, and applies the same update: the replicas stay equal with
no broadcast. With one rank every scale is 1.0 and every sum has one
term, so the step is bit for bit the single-device one.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

__all__ = ["local_share", "reduce_gradients_and_metrics_", "flat_all_reduce_"]


def local_share(n_local: int, device, group) -> torch.Tensor:
    """n_r / N, this rank's share of the global batch, as a 0-d f32 device
    tensor (one ``all_reduce`` of the counts)."""
    world, r = dist.get_world_size(group), dist.get_rank(group)
    counts = torch.zeros(world, dtype=torch.float32, device=device)
    counts[r].fill_(n_local)   # a fill kernel: no host copy (graphs)
    dist.all_reduce(counts, group=group)
    return counts[r] / counts.sum()


def flat_all_reduce_(tensors, group) -> None:
    """Sum ``tensors`` over the ranks in place, as one flat bucket (their
    dtypes must agree)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    off = 0
    for t in tensors:
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


def reduce_gradients_and_metrics_(model: torch.nn.Module,
                                  metrics: Dict[str, torch.Tensor],
                                  share: torch.Tensor, group) -> None:
    """Sum every gradient (of the share-scaled loss), and the loss times
    ``share`` and the correct count, over the ranks in one bucket; then
    ``metrics`` holds the global mean loss and the global sums."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    loss = metrics["loss"]
    extra = torch.stack([loss.float() * share,
                         metrics["correct"].float(),
                         metrics["count"].float()])
    flat_all_reduce_(grads + [extra], group)
    metrics["loss"] = extra[0].to(loss.dtype)
    metrics["correct"] = extra[1].round().to(torch.int32)
    metrics["count"] = extra[2].round().to(torch.int32)
