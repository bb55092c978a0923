"""Global-batch BatchNorm: train-mode statistics over every rank's batch.

Under the JAX package's GSPMD train step, BatchNorm's batch reductions run
over the logical (global) batch: the step equals single-device math on the
whole batch (tests/test_parallel.py). This module gives the port's
``models.common.BatchNorm2d`` that semantic inside ``sync_batch_norm``.

Forward, per layer: each rank's count, mean and biased variance (f32) go
into its row of a zero (world, 1 + 2C) float64 buffer, one summed
``all_reduce`` gathers the rows, and Chan's parallel formula gives the
global mean μ and biased variance σ². The layer then runs the same
cuDNN / native batch-norm kernel as a single-device step, on the local
rows with the affine parameters w·a and b + w·c, where a = σ_l/σ_g and
c = (μ_l − μ_g)/σ_g: w·(x − μ_g)/σ_g + b.

Backward: the same kernel's backward gives the local dx and the sums
Σdy and Σdy·x̂_l; one ``all_reduce`` of [Σdy, Σdy·x̂_g] per layer turns
them into the global means, and a per-channel affine term α + β·x moves
dx to the global-statistics gradient. With one rank, a = 1, c = 0 and the
correction is 0 exactly, so the step is bit for bit the single-device one.

``torch.nn.SyncBatchNorm`` is not used: it puts the unbiased variance into
the running stats, where Flax's update (and the port's layer) puts the
biased one.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.distributed as dist
from torch import nn

__all__ = ["sync_batch_norm", "global_batch_norm"]


@contextmanager
def sync_batch_norm(model: nn.Module, group):
    """Inside, every train-mode ``BatchNorm2d`` of ``model`` normalises
    with the statistics of the global batch over ``group`` (None: no
    change). Hold it over the forward AND the backward: ``remat``'s
    recompute runs the forward again there."""
    bns = [m for m in model.modules() if hasattr(m, "process_group")
           and isinstance(m, nn.BatchNorm2d)]
    if group is None:
        yield
        return
    for m in bns:
        m.process_group = group
    try:
        yield
    finally:
        for m in bns:
            m.process_group = None


def _channels(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(1, -1, *([1] * 2))


def global_batch_norm(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, eps: float, group):
    """(out, global mean, global biased variance) of a train-mode batch
    norm of f32 NCHW ``x`` over ``group``'s ranks; the two statistics
    carry no gradient."""
    return _GlobalBatchNorm.apply(x, weight, bias, eps, group)


class _GlobalBatchNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, bias, eps, group):
        c = x.shape[1]
        n = x.numel() // max(1, c)
        world, r = dist.get_world_size(group), dist.get_rank(group)
        var_l, mean_l = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        rows = x.new_zeros((world, 1 + 2 * c), dtype=torch.float64)
        rows[r, 0].fill_(n)    # a fill kernel: no host copy (graphs)
        rows[r, 1:].copy_(torch.cat([mean_l, var_l]))
        dist.all_reduce(rows, group=group)
        share = rows[:, :1] / rows[:, :1].sum()
        means, vars_ = rows[:, 1:1 + c], rows[:, 1 + c:]
        mean_g = (share * means).sum(0)
        var_g = (share * (vars_ + (means - mean_g) ** 2)).sum(0)
        mean_g, var_g = mean_g.float(), var_g.float()
        std_l = torch.sqrt(var_l + eps)
        std_g = torch.sqrt(var_g + eps)
        a = std_l / std_g
        shift = (mean_l - mean_g) / std_g
        w2, b2 = weight * a, bias + weight * shift
        out, save_mean, save_invstd, reserve, impl = (
            torch._batch_norm_impl_index(
                x, w2, b2, None, None, True, 0.0, eps,
                torch.backends.cudnn.enabled))
        ctx.save_for_backward(x, weight, w2, save_mean, save_invstd,
                              reserve, a, shift, mean_l, std_l, std_g,
                              rows[:, 0].sum())
        ctx.impl, ctx.eps, ctx.group, ctx.n = impl, eps, group, n
        ctx.mark_non_differentiable(mean_g, var_g)
        return out, mean_g, var_g

    @staticmethod
    def backward(ctx, dy, _d_mean, _d_var):
        (x, weight, w2, save_mean, save_invstd, reserve, a, shift, mean_l,
         std_l, std_g, total) = ctx.saved_tensors
        if ctx.impl == 1:
            # what autograd hands cuDNN's backward (the native one takes
            # dy as it comes: another layout sums in another order)
            dy = dy.contiguous(memory_format=(
                torch.channels_last
                if x.is_contiguous(memory_format=torch.channels_last)
                and not x.is_contiguous() else torch.contiguous_format))
        dx, dw2, db2 = torch.ops.aten._batch_norm_impl_index_backward(
            ctx.impl, x, dy, w2, None, None, save_mean, save_invstd, True,
            ctx.eps, [True, True, True], reserve)
        # dw2 = Σ dy·x̂_l and db2 = Σ dy; Σ dy·x̂_g = a·dw2 + shift·db2
        sums = torch.stack([db2, a * dw2 + shift * db2]).double()
        dist.all_reduce(sums, group=ctx.group)
        m1_g, m2_g = sums[0] / total, sums[1] / total
        m1_l, m2_l = db2.double() / ctx.n, dw2.double() / ctx.n
        k = weight.double() / std_g.double()
        alpha = k * (m1_l - m1_g - shift.double() * m2_g)
        beta = k * (m2_l - a.double() * m2_g)
        slope = beta / std_l.double()
        dx.addcmul_(x, _channels(slope.float())).add_(
            _channels((alpha - slope * mean_l.double()).float()))
        return dx, dw2 * a + db2 * shift, db2, None, None
