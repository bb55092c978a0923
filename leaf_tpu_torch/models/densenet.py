"""DenseNet in PyTorch (NCHW), 1-channel stem.

Parity with the JAX package's ``leaf_tpu.models.densenet`` and the
reference's torchvision-derived models/densenet.py: dense layers
(BN → ReLU → 1×1 conv to bn_size·k → BN → ReLU → 3×3 conv to k,
reference:28-96), dense blocks that concatenate each layer's output to
its input (99-121), transitions that halve the channels and 2×2
average-pool (124-137), a 1-channel 7×7/2 stem with a 3×3/2 max-pool,
a final BN + ReLU + global average pool and a linear ``classifier``;
optional dropout after each dense layer (``drop_rate``), drawn from the
generator passed to ``forward``. Inits are Flax's defaults
(lecun-normal kernels truncated at ±2σ, zero biases, BatchNorm scale 1
and bias 0); BatchNorm keeps Flax's momentum 0.9 (torch 0.1), eps 1e-5.

``memory_efficient=True`` recomputes each dense layer in the backward
(``common.remat``; the JAX package's ``nn.remat`` over the layer, the
reference's ``torch.utils.checkpoint`` path, densenet.py:64-68): the
dropout mask is drawn before the layer and passed in.

Names are torchvision's: ``features.conv0``, ``features.norm0``,
``features.denseblockN.denselayerM.{norm1,conv1,norm2,conv2}``,
``features.transitionN.{norm,conv}``, ``features.norm5``, ``classifier``.

Under bf16 the convs whose output feeds a BatchNorm hand it their
unrounded f32 sums (``common.Conv2d``); a dense layer's new features and
a transition's conv are rounded to bf16 before the concatenation and the
average pool, whose window sums are rounded after each add, as XLA
computes the JAX package's bf16 DenseNet on the CPU.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from leaf_tpu_torch.models.common import (BatchNorm2d, Conv2d, apply_keep,
                                          dense, global_avg_pool, keep_mask,
                                          lecun_normal_init_, max_pool_same,
                                          remat)

__all__ = [
    "DenseLayer",
    "DenseBlock",
    "Transition",
    "DenseNet",
    "densenet121",
    "densenet161",
    "densenet169",
    "densenet201",
]


def _bn(channels: int, device, dtype: torch.dtype) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1, device=device,
                       out_dtype=dtype)


class DenseLayer(nn.Module):
    def __init__(self, num_input_features: int, growth_rate: int,
                 bn_size: int, drop_rate: float, device=None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.drop_rate = drop_rate
        self.compute_dtype = compute_dtype
        self.norm1 = _bn(num_input_features, device, compute_dtype)
        self.conv1 = Conv2d(num_input_features, bn_size * growth_rate, 1,
                            bias=False, device=device)
        self.norm2 = _bn(bn_size * growth_rate, device, compute_dtype)
        self.conv2 = Conv2d(bn_size * growth_rate, growth_rate, 3,
                            padding=1, bias=False, device=device)

    def dropout_mask(self, x: torch.Tensor,
                     generator: Optional[torch.Generator]
                     ) -> Optional[torch.Tensor]:
        """The keep mask of this layer's dropout for input x (B, C, H, W):
        one Bernoulli(1 − drop_rate) per output entry (B, k, H, W), from
        ``generator``; None in eval mode or at rate 0."""
        if not (self.training and self.drop_rate > 0):
            return None
        shape = (x.shape[0], self.conv2.out_channels) + tuple(x.shape[2:])
        return keep_mask(shape, self.drop_rate, x, generator)

    def forward(self, x: torch.Tensor,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The k new feature maps; ``keep`` is the dropout mask
        (``dropout_mask``; None: no dropout)."""
        out = self.conv1(F.relu(self.norm1(x)))
        out = self.conv2(F.relu(self.norm2(out))).to(self.compute_dtype)
        if keep is not None:
            out = apply_keep(out, keep, self.drop_rate)
        return out


class DenseBlock(nn.ModuleDict):
    def __init__(self, num_layers: int, num_input_features: int,
                 growth_rate: int, bn_size: int, drop_rate: float,
                 memory_efficient: bool = False, device=None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__({
            f"denselayer{i + 1}": DenseLayer(
                num_input_features + i * growth_rate, growth_rate, bn_size,
                drop_rate, device, compute_dtype)
            for i in range(num_layers)})
        self.memory_efficient = memory_efficient

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        checkpointed = (self.memory_efficient and self.training
                        and torch.is_grad_enabled())
        for layer in self.values():
            keep = layer.dropout_mask(x, generator)
            new = (remat(layer, layer, x, keep) if checkpointed
                   else layer(x, keep))
            x = torch.cat([x, new], dim=1)
        return x


def _avg_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2×2/2 average pool (VALID: an odd last row or column is dropped)
    as XLA reduces a window: the four values added in turn, row-major,
    each sum rounded to x's dtype, then divided by 4 (exact)."""
    x = x[:, :, :x.shape[2] // 2 * 2, :x.shape[3] // 2 * 2]
    s = x[:, :, 0::2, 0::2] + x[:, :, 0::2, 1::2]
    s = s + x[:, :, 1::2, 0::2]
    return (s + x[:, :, 1::2, 1::2]) / 4


class Transition(nn.Module):
    def __init__(self, num_input_features: int, num_output_features: int,
                 device=None, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.norm = _bn(num_input_features, device, compute_dtype)
        self.conv = Conv2d(num_input_features, num_output_features, 1,
                           bias=False, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(F.relu(self.norm(x))).to(self.compute_dtype)
        return _avg_pool_2x2(x)


class DenseNet(nn.Module):
    """DenseNet backbone + classifier on the 1-channel LEAF image; input
    (B, H, W, 1) NHWC. Weights are drawn on the CPU from ``generator``."""

    def __init__(self, growth_rate: int = 32,
                 block_config: Sequence[int] = (6, 12, 24, 16),
                 num_init_features: int = 64, bn_size: int = 4,
                 drop_rate: float = 0.0, num_classes: int = 1000,
                 memory_efficient: bool = False,
                 compute_dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        features = {
            "conv0": Conv2d(1, num_init_features, 7, stride=2, padding=3,
                            bias=False, device=device),
            "norm0": _bn(num_init_features, device, compute_dtype),
        }
        num_features = num_init_features
        for i, num_layers in enumerate(block_config):
            features[f"denseblock{i + 1}"] = DenseBlock(
                num_layers, num_features, growth_rate, bn_size, drop_rate,
                memory_efficient, device, compute_dtype)
            num_features += num_layers * growth_rate
            if i != len(block_config) - 1:
                features[f"transition{i + 1}"] = Transition(
                    num_features, num_features // 2, device, compute_dtype)
                num_features //= 2
        features["norm5"] = _bn(num_features, device, compute_dtype)
        self.features = nn.ModuleDict(features)
        self.classifier = nn.Linear(num_features, num_classes, device=device)
        lecun_normal_init_(self, generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits; in train mode dropout draws from ``generator``."""
        f = self.features
        x = x.permute(0, 3, 1, 2).contiguous().to(self.compute_dtype)
        x = max_pool_same(F.relu(f["norm0"](f["conv0"](x))))
        for name, module in f.items():
            if name.startswith("denseblock"):
                x = module(x, generator)
            elif name.startswith("transition"):
                x = module(x)
        x = global_avg_pool(F.relu(f["norm5"](x)))
        return dense(x, self.classifier.weight, self.classifier.bias)


def densenet121(num_classes: int = 1000, **kw) -> DenseNet:
    return DenseNet(32, (6, 12, 24, 16), 64, num_classes=num_classes, **kw)


def densenet161(num_classes: int = 1000, **kw) -> DenseNet:
    return DenseNet(48, (6, 12, 36, 24), 96, num_classes=num_classes, **kw)


def densenet169(num_classes: int = 1000, **kw) -> DenseNet:
    return DenseNet(32, (6, 12, 32, 32), 64, num_classes=num_classes, **kw)


def densenet201(num_classes: int = 1000, **kw) -> DenseNet:
    return DenseNet(32, (6, 12, 48, 32), 64, num_classes=num_classes, **kw)
