"""Shared building blocks for the classifier zoo (channels-first, NCHW)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["BatchNorm2d", "Conv2d", "Conv2dSame", "drop_connect",
           "dropout", "global_avg_pool", "lecun_normal_init_", "sigmoid",
           "silu", "silu_mean"]

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

    ``out_dtype`` is Flax's ``BatchNorm(dtype=...)``: the statistics, the
    running-stat update and the normalisation run in f32 (a bf16 input is
    widened), and the output is rounded to ``out_dtype`` (None: the
    input's dtype).
    """

    def __init__(self, *args, out_dtype: Optional[torch.dtype] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.out_dtype = out_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_dtype = self.out_dtype or x.dtype
        x = x.float()
        if not self.training:
            return super().forward(x).to(out_dtype)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                            self.eps).to(out_dtype)


class Conv2d(nn.Conv2d):
    """nn.Conv2d as Flax's ``nn.Conv(dtype=...)`` computes it: the f32
    parameters are rounded to the input's dtype at use and stay f32.

    A bf16 input gives the f32 sums of the bf16 products, unrounded: in
    EfficientNet every conv feeds a BatchNorm, which normalises in f32,
    and XLA hands it the conv's f32 result rather than rounding it to bf16
    and widening it again; ``BatchNorm2d(out_dtype=...)`` rounds after
    it. The products of bf16 values are exact in f32, so this is an f32
    conv of the rounded operands.
    """

    def _operands(self, x: torch.Tensor):
        """(x, weight, bias) as the conv takes them: the parameters at x's
        dtype, and under bf16 all three widened to f32."""
        weight = self.weight.to(x.dtype)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        if x.dtype != torch.bfloat16:
            return x, weight, bias
        return x.float(), weight.float(), None if bias is None else bias.float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(*self._operands(x))


class Conv2dSame(Conv2d):
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
        return F.conv2d(*self._operands(x), self.stride, 0, self.dilation,
                        self.groups)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` at x's dtype. Under bf16 it is computed as XLA
    expands ``lax.logistic`` for bf16, 1 / (1 + exp(−x)) with each op
    rounded to bf16; f32 takes ``torch.sigmoid``."""
    if x.dtype != torch.bfloat16:
        return torch.sigmoid(x)
    return torch.reciprocal(1.0 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``flax.linen.silu``: x · sigmoid(x), the product rounded to x's
    dtype (``F.silu`` in f32)."""
    if x.dtype != torch.bfloat16:
        return F.silu(x)
    return x * sigmoid(x)


def _keep_mask(shape, rate: float, x: torch.Tensor,
               generator: Optional[torch.Generator]) -> torch.Tensor:
    """Bernoulli(1 − rate) as ``uniform < 1 − rate``, as jax.random does."""
    return torch.rand(shape, generator=generator, device=x.device,
                      dtype=torch.float32) < 1.0 - rate


def _weak(value: float, x: torch.Tensor) -> torch.Tensor:
    """A Python scalar as JAX's weak typing gives it to an op on x: rounded
    to x's dtype (0.8 is 0.80078125 in bf16)."""
    return torch.full((), value, dtype=x.dtype, device=x.device)


def drop_connect(x: torch.Tensor, rate: float,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Stochastic depth: drop the whole residual branch per sample.

    Bernoulli(keep = 1 − rate) per batch element, kept rows scaled by
    1/keep (the JAX package's ``drop_connect``, after reference
    models/efficientnet/utils.py:129-154). ``generator`` lives on x's
    device; None takes that device's default generator.
    """
    keep = _keep_mask((x.shape[0],) + (1,) * (x.ndim - 1), rate, x, generator)
    return torch.where(keep, x / _weak(1.0 - rate, x), torch.zeros_like(x))


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Elementwise dropout as ``flax.linen.Dropout``: keep with
    probability 1 − rate, kept values scaled by 1/(1 − rate)."""
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = _keep_mask(x.shape, rate, x, generator)
    return torch.where(keep, x / _weak(1.0 - rate, x), torch.zeros_like(x))


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool2d((1,1)) + flatten: (B, C, H, W) → (B, C)."""
    return x.mean(dim=(2, 3))


def silu_mean(x: torch.Tensor) -> torch.Tensor:
    """``global_avg_pool(silu(x))`` as XLA computes it under bf16: the
    mean sums the f32 products x · sigmoid(x) (sigmoid at x's dtype, see
    ``sigmoid``) before silu's rounding, and is rounded to x's dtype."""
    if x.dtype != torch.bfloat16:
        return global_avg_pool(silu(x))
    return global_avg_pool(x.float() * sigmoid(x).float()).to(x.dtype)


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
        h = inputs[0].float()
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
