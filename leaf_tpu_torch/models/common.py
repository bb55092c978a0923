"""Shared building blocks for the classifier zoo (channels-first, NCHW)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["BatchNorm2d", "Conv2dSame", "drop_connect", "dropout",
           "global_avg_pool", "lecun_normal_init_"]

# the standard deviation of a unit normal truncated at ±2 (jax.nn's
# variance_scaling divides by it so that the truncated draw keeps its scale)
_TRUNC_NORMAL_STD = 0.87962566103423978


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with Flax's training semantics, under torch's names.

    In train mode it normalises with the batch mean and the biased batch
    variance (as torch does) and updates the running stats as
    ``flax.linen.BatchNorm`` does: ``var ← (1−m)·var + m·biased_var`` with
    torch's ``momentum`` m (Flax's momentum 0.99 is m = 0.01).
    ``torch.nn.BatchNorm2d`` would put the unbiased variance there. Eval
    mode is torch's. The state_dict keys are torch's, so weights load and
    export unchanged.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps)


class Conv2dSame(nn.Conv2d):
    """Conv2d with TensorFlow/Flax ``padding='SAME'``.

    Per spatial axis: out = ⌈in / stride⌉ and the total padding
    ``max((out−1)·stride + k − in, 0)`` splits as (total//2, total − total//2)
    — asymmetric for stride 2 (the 3×3/2 stem on a 40×100 image pads (0, 1)
    on both axes), which torch's symmetric ``padding=`` cannot express.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = []
        for size, k, s in zip(reversed(x.shape[-2:]), reversed(self.kernel_size),
                              reversed(self.stride)):
            total = max((math.ceil(size / s) - 1) * s + k - size, 0)
            pads += [total // 2, total - total // 2]
        if any(pads):
            x = F.pad(x, pads)
        return F.conv2d(x, self.weight, self.bias, self.stride, 0,
                        self.dilation, self.groups)


def _keep_mask(shape, rate: float, x: torch.Tensor,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """Bernoulli(1 − rate) as ``uniform < 1 − rate``, as jax.random does."""
    return torch.rand(shape, generator=generator, device=x.device,
                      dtype=torch.float32) < 1.0 - rate


def drop_connect(x: torch.Tensor, rate: float,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Stochastic depth: drop the whole residual branch per sample.

    Bernoulli(keep = 1 − rate) per batch element, kept rows scaled by
    1/keep (the JAX package's ``drop_connect``, after reference
    models/efficientnet/utils.py:129-154). ``generator`` lives on x's
    device; None takes that device's default generator.
    """
    keep = _keep_mask((x.shape[0],) + (1,) * (x.ndim - 1), rate, x, generator)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Elementwise dropout as ``flax.linen.Dropout``: keep with
    probability 1 − rate, kept values scaled by 1/(1 − rate)."""
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = _keep_mask(x.shape, rate, x, generator)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool2d((1,1)) + flatten: (B, C, H, W) → (B, C)."""
    return x.mean(dim=(2, 3))


@torch.no_grad()
def set_batch_norm_stats_(model: nn.Module, x: torch.Tensor) -> None:
    """Set every BatchNorm's running stats to its input's statistics on x.

    One forward pass in the model's current mode; each BatchNorm2d sees
    its input normalised by the statistics just taken from it (biased
    variance, as Flax keeps it). With random weights and torch's default
    stats (mean 0, var 1) the EfficientNet activations shrink to ~1e-8 by
    the head; after this they stay O(1), so checks compare real numbers.
    """
    def hook(bn, inputs):
        h = inputs[0]
        bn.running_mean.copy_(h.mean(dim=(0, 2, 3)))
        bn.running_var.copy_(h.var(dim=(0, 2, 3), unbiased=False))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, nn.BatchNorm2d)]
    try:
        model(x)
    finally:
        for h in handles:
            h.remove()


@torch.no_grad()
def lecun_normal_init_(module: nn.Module,
                       generator: Optional[torch.Generator] = None) -> None:
    """Seeded init of every conv and linear layer below ``module``.

    Weights as Flax's default ``lecun_normal()``: a normal truncated at
    ±2σ with σ = √(1/fan_in)/0.87962566, which keeps the variance at
    1/fan_in; biases zero; batch norms keep torch's (scale 1, bias 0).
    Numbers are drawn on the CPU from ``generator`` and copied to the
    module's device, so a seed gives the same weights on every device.
    """
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            sd = math.sqrt(1.0 / fan_in) / _TRUNC_NORMAL_STD
            w = torch.empty(m.weight.shape, dtype=m.weight.dtype)
            nn.init.trunc_normal_(w, 0.0, sd, -2.0 * sd, 2.0 * sd,
                                  generator=generator)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
