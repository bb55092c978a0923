"""Shared building blocks for the classifier zoo (channels-first, NCHW)."""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from leaf_tpu_torch.parallel.sync_batch_norm import global_batch_norm

__all__ = ["BatchNorm2d", "Conv2d", "Conv2dSame", "apply_keep",
           "bn_scale_normal_", "dense", "dropout", "global_avg_pool",
           "keep_mask", "kaiming_normal_fan_out_", "lecun_normal_",
           "lecun_normal_init_", "max_pool_same", "remat", "sigmoid", "silu",
           "silu_mean"]

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

    ``update_stats`` False normalises with the batch statistics without
    touching the running ones: ``remat``'s recompute, which Flax's
    ``nn.remat`` does not let update them a second time.

    ``process_group`` (set by ``parallel.sync_batch_norm`` for a
    data-parallel step; None otherwise) makes the train-mode statistics
    those of the global batch over the group's ranks
    (``parallel.sync_batch_norm.global_batch_norm``).
    """

    def __init__(self, *args, out_dtype: Optional[torch.dtype] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.out_dtype = out_dtype
        self.update_stats = True
        self.process_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_dtype = self.out_dtype or x.dtype
        x = x.float()
        if not self.training:
            return super().forward(x).to(out_dtype)
        if self.process_group is not None:
            out, mean, var = global_batch_norm(x, self.weight, self.bias,
                                               self.eps, self.process_group)
            if self.update_stats:
                with torch.no_grad():
                    self.running_mean.lerp_(mean, self.momentum)
                    self.running_var.lerp_(var, self.momentum)
                    self.num_batches_tracked.add_(1)
            return out.to(out_dtype)
        if self.update_stats:
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


def keep_mask(shape, rate: float, x: torch.Tensor,
              generator: Optional[torch.Generator]) -> torch.Tensor:
    """Bernoulli(1 − rate) as ``uniform < 1 − rate``, as jax.random does,
    on x's device."""
    return torch.rand(shape, generator=generator, device=x.device,
                      dtype=torch.float32) < 1.0 - rate


def apply_keep(x: torch.Tensor, keep: torch.Tensor, rate: float
               ) -> torch.Tensor:
    """Kept values scaled by 1/(1 − rate), the others zero (``keep``
    broadcasts against x)."""
    return torch.where(keep, x / _weak(1.0 - rate, x), torch.zeros_like(x))


def _weak(value: float, x: torch.Tensor) -> torch.Tensor:
    """A Python scalar as JAX's weak typing gives it to an op on x: rounded
    to x's dtype (0.8 is 0.80078125 in bf16)."""
    return torch.full((), value, dtype=x.dtype, device=x.device)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Elementwise dropout as ``flax.linen.Dropout``: keep with
    probability 1 − rate, kept values scaled by 1/(1 − rate)."""
    if rate >= 1.0:
        return torch.zeros_like(x)
    return apply_keep(x, keep_mask(x.shape, rate, x, generator), rate)


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: torch.Tensor) -> torch.Tensor:
    """x @ weight.T + bias at x's dtype, the product and the sum each
    rounded to it (Flax's ``Dense``; the parameters stay f32)."""
    return F.linear(x, weight.to(x.dtype)) + bias.to(x.dtype)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool2d((1,1)) + flatten: (B, C, H, W) → (B, C)."""
    return x.mean(dim=(2, 3))


def max_pool_same(x: torch.Tensor, window: int = 3, stride: int = 2,
                  pad: int = 1) -> torch.Tensor:
    """3×3/2 max-pool with torch-style symmetric padding (pad=1), padded
    with −inf (the JAX package's ``max_pool_same``)."""
    return F.max_pool2d(x, window, stride, pad)


def remat(module: nn.Module, fn, *args) -> torch.Tensor:
    """``fn(*args)``, a computation of ``module``, with its activations
    recomputed in the backward
    instead of saved (``torch.utils.checkpoint``, non-reentrant), as
    Flax's ``nn.remat`` does it.

    Two things differ from a plain checkpoint. The recompute leaves the
    running statistics of every ``BatchNorm2d`` below ``module`` as the
    forward left them (it normalises with the same batch statistics).
    And nothing random may run inside: the caller draws dropout and
    drop-connect masks before and passes them in, so the recompute uses
    the same masks and the generator advances once (torch's
    ``preserve_rng_state`` covers only the default generators, so it is
    off).
    """
    bns = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    calls = []

    def run(*inputs):
        recompute = bool(calls)
        calls.append(recompute)
        for m in bns:
            m.update_stats = not recompute
        try:
            return fn(*inputs)
        finally:
            for m in bns:
                m.update_stats = True

    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


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


def _drawn(shape, draw, generator, like: torch.Tensor) -> torch.Tensor:
    """``draw(t, generator)`` into a new CPU tensor of ``shape``, then to
    ``like``'s device and dtype: a seed gives the same numbers on every
    device."""
    t = torch.empty(shape, dtype=torch.float32)
    draw(t, generator)
    return t.to(device=like.device, dtype=like.dtype)


@torch.no_grad()
def kaiming_normal_fan_out_(weight: torch.Tensor,
                            generator: Optional[torch.Generator] = None
                            ) -> torch.Tensor:
    """He-normal in fan-out mode (the JAX package's
    ``kaiming_normal_fan_out``; reference models/resnet.py:104-105): an
    untruncated N(0, 2/fan_out) with fan_out = O·kH·kW for a conv weight
    (O, I, kH, kW) and O for a linear weight (O, I)."""
    std = math.sqrt(2.0 / (weight.shape[0] * weight[0][0].numel()))
    return weight.copy_(_drawn(
        weight.shape, lambda t, g: t.normal_(0.0, std, generator=g),
        generator, weight))


@torch.no_grad()
def bn_scale_normal_(weight: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     mean: float = 1.0, std: float = 0.02) -> torch.Tensor:
    """BatchNorm scale ~ N(mean, std) (the JAX package's
    ``bn_scale_normal``; reference models/resnet.py:106-107)."""
    return weight.copy_(_drawn(
        weight.shape, lambda t, g: t.normal_(mean, std, generator=g),
        generator, weight))


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Flax's default ``lecun_normal()`` kernel init: a normal truncated
    at ±2σ with σ = √(1/fan_in)/0.87962566, which keeps the variance at
    1/fan_in (fan_in = I·kH·kW of a conv weight, I of a linear one)."""
    sd = math.sqrt(1.0 / weight[0].numel()) / _TRUNC_NORMAL_STD
    return weight.copy_(_drawn(
        weight.shape, lambda t, g: nn.init.trunc_normal_(
            t, 0.0, sd, -2.0 * sd, 2.0 * sd, generator=g),
        generator, weight))


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
            lecun_normal_(m.weight, generator)
            if m.bias is not None:
                m.bias.zero_()
