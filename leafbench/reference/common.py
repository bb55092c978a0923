"""Plain building blocks shared by the reference backbones (NCHW, f32)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def batch_norm(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """Train mode: the batch mean and biased variance; eval mode: the
    running statistics. The running statistics are not updated here."""
    if bn.training:
        return F.batch_norm(x, None, None, bn.weight, bn.bias, True, 0.0,
                            bn.eps)
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                        bn.bias, False, 0.0, bn.eps)


def conv_same(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """conv2d with TensorFlow 'SAME' padding: out = ⌈in/stride⌉ and the
    total padding split (total//2, total − total//2) on each axis."""
    pads = []
    for size, k, s in zip(reversed(x.shape[-2:]), reversed(conv.kernel_size),
                          reversed(conv.stride)):
        total = max((math.ceil(size / s) - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.conv2d(F.pad(x, pads), conv.weight, conv.bias, conv.stride, 0,
                    1, conv.groups)


def keep_mask(shape, rate: float, like: torch.Tensor,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """Bernoulli(1 − rate) drawn as uniform < 1 − rate."""
    return torch.rand(shape, generator=generator, device=like.device,
                      dtype=torch.float32) < 1.0 - rate


def drop(x: torch.Tensor, keep: torch.Tensor, rate: float) -> torch.Tensor:
    """Kept values scaled by 1/(1 − rate), the others zero."""
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


@torch.no_grad()
def fill_weights(model: nn.Module, generator: torch.Generator,
                 std_of) -> None:
    """Every parameter of ``model`` that ``std_of(name, shape)`` gives a
    standard deviation is drawn N(0, std²) from ``generator``, all of
    them from one normal draw on the parameters' device; BatchNorm scales
    are 1 and every other parameter of a backbone (biases, BatchNorm
    shifts) 0. Parameters for which ``std_of`` returns None and that are
    not of a BatchNorm or a bias keep what they hold."""
    named = list(model.named_parameters())
    drawn = [(n, p, std_of(n, tuple(p.shape))) for n, p in named]
    total = sum(p.numel() for _, p, s in drawn if s is not None)
    device = named[0][1].device
    noise = torch.randn(total, generator=generator, device=device)
    at = 0
    bns = {n for n, m in model.named_modules()
           if isinstance(m, nn.BatchNorm2d)}
    for name, p, std in drawn:
        owner, _, leaf = name.rpartition(".")
        if std is not None:
            p.copy_(noise[at:at + p.numel()].view_as(p) * std)
            at += p.numel()
        elif owner in bns:
            p.fill_(1.0 if leaf == "weight" else 0.0)
        elif leaf == "bias":
            p.zero_()
    for _, m in model.named_modules():
        if isinstance(m, nn.BatchNorm2d):
            m.reset_running_stats()


@torch.no_grad()
def set_running_stats(model: nn.Module, run, floor: float = 0.1) -> None:
    """Set every BatchNorm's running mean and variance to the statistics
    of its input during ``run()`` (a forward in train mode), each
    variance floored at ``floor`` × its mean over the channels, so that
    eval-mode logits of a random network stay O(1)."""
    def hook(bn, inputs):
        h = inputs[0].float()
        var = h.var(dim=(0, 2, 3), unbiased=False)
        bn.running_mean.copy_(h.mean(dim=(0, 2, 3)))
        bn.running_var.copy_(torch.maximum(var, floor * var.mean()))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, nn.BatchNorm2d)]
    try:
        run()
    finally:
        for h in handles:
            h.remove()
