"""EfficientNet (b0–b8, l2) in PyTorch, train and eval.

Capability parity with the JAX package's ``leaf_tpu.models.efficientnet``
and the reference's vendored lukemelas EfficientNet (reference:
models/efficientnet/model.py + utils.py): the block-string DSL, compound
scaling ``round_filters``/``round_repeats``, MBConv with squeeze-excite,
BN momentum 0.99 (torch momentum 0.01) / eps 1e-3 with Flax's running
variance (``common.BatchNorm2d``), stochastic depth scaled by block
index on identity-skip blocks, dropout before the final linear.

Layout: the model's input is the NHWC (B, H, W, C) image the JAX
``Classifier`` builds; it is permuted once to NCHW, which the rest runs
in. Stride-2 convolutions use TF-SAME padding (``Conv2dSame``). Module
and parameter names are the reference's (``_conv_stem``, ``_bn0``,
``_blocks.N._expand_conv`` …), so ``leaf_tpu.models.torch_import``
carries a port ``state_dict`` into the JAX model unchanged.

Train mode (``model.train()``) draws dropout and drop-connect masks from
the ``generator`` passed to ``forward`` (None: the device's default
generator); its numbers differ from the JAX package's PRNG streams, so
the tests hold them by their distributions.

``remat=True`` recomputes each MBConv block's activations in the
backward instead of saving them (the JAX package's ``nn.remat`` per
block, ``common.remat``): the same masks, the same running statistics
and the same gradients as without it, for less memory.

``compute_dtype=torch.bfloat16`` is the JAX package's ``dtype=bfloat16``
as XLA computes it: the image is cast once; each conv sums its bf16
products in f32 and hands the f32 result to its BatchNorm, which
normalises in f32 and returns bf16 (``common.Conv2d``); silu, the
squeeze-excite dense layers and gate, drop-connect, dropout and the fc
run in bf16, each op rounded (``common.sigmoid``), the squeeze and the
head's pooling average the unrounded silu products (``common.silu_mean``);
the logits are bf16 and the parameters f32.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from leaf_tpu_torch.models.common import (BatchNorm2d, Conv2d, Conv2dSame,
                                          apply_keep, dense, dropout,
                                          keep_mask, lecun_normal_init_, remat,
                                          sigmoid, silu, silu_mean)

__all__ = [
    "BlockArgs",
    "GlobalParams",
    "decode_block_string",
    "round_filters",
    "round_repeats",
    "efficientnet_params",
    "get_model_params",
    "MBConvBlock",
    "EfficientNet",
    "VALID_MODELS",
]


@dataclass(frozen=True)
class BlockArgs:
    num_repeat: int
    kernel_size: int
    stride: int
    expand_ratio: int
    input_filters: int
    output_filters: int
    se_ratio: Optional[float]
    id_skip: bool = True

    def replace(self, **kw) -> "BlockArgs":
        d = self.__dict__.copy()
        d.update(kw)
        return BlockArgs(**d)


@dataclass(frozen=True)
class GlobalParams:
    width_coefficient: Optional[float]
    depth_coefficient: Optional[float]
    dropout_rate: float = 0.2
    drop_connect_rate: float = 0.2
    num_classes: int = 1000
    batch_norm_momentum: float = 0.99
    batch_norm_epsilon: float = 1e-3
    depth_divisor: int = 8
    min_depth: Optional[int] = None
    include_top: bool = True


# The b0 architecture in the reference's block-string DSL
# (reference: models/efficientnet/utils.py:502-510).
B0_BLOCK_STRINGS = (
    "r1_k3_s11_e1_i32_o16_se0.25",
    "r2_k3_s22_e6_i16_o24_se0.25",
    "r2_k5_s22_e6_i24_o40_se0.25",
    "r3_k3_s22_e6_i40_o80_se0.25",
    "r3_k5_s11_e6_i80_o112_se0.25",
    "r4_k5_s22_e6_i112_o192_se0.25",
    "r1_k3_s11_e6_i192_o320_se0.25",
)

# width, depth, resolution, dropout (reference: utils.py:466-479).
_SCALING_COEFFICIENTS = {
    "efficientnet-b0": (1.0, 1.0, 224, 0.2),
    "efficientnet-b1": (1.0, 1.1, 240, 0.2),
    "efficientnet-b2": (1.1, 1.2, 260, 0.3),
    "efficientnet-b3": (1.2, 1.4, 300, 0.3),
    "efficientnet-b4": (1.4, 1.8, 380, 0.4),
    "efficientnet-b5": (1.6, 2.2, 456, 0.4),
    "efficientnet-b6": (1.8, 2.6, 528, 0.5),
    "efficientnet-b7": (2.0, 3.1, 600, 0.5),
    "efficientnet-b8": (2.2, 3.6, 672, 0.5),
    "efficientnet-l2": (4.3, 5.3, 800, 0.5),
}

VALID_MODELS = tuple(_SCALING_COEFFICIENTS)


def efficientnet_params(model_name: str) -> Tuple[float, float, int, float]:
    """(width, depth, resolution, dropout) of ``model_name``, e.g.
    ``"efficientnet-b0"``; an unknown name raises ``KeyError``."""
    return _SCALING_COEFFICIENTS[model_name]


def decode_block_string(block_string: str) -> BlockArgs:
    """Parse e.g. 'r1_k3_s11_e1_i32_o16_se0.25' (reference: utils.py:370-402)."""
    options = {}
    for op in block_string.split("_"):
        splits = re.split(r"(\d.*)", op)
        if len(splits) >= 2:
            key, value = splits[:2]
            options[key] = value
    stride = options["s"]
    if not (len(stride) == 1 or (len(stride) == 2 and stride[0] == stride[1])):
        raise ValueError(f"invalid stride in block string: {block_string}")
    return BlockArgs(
        num_repeat=int(options["r"]),
        kernel_size=int(options["k"]),
        stride=int(stride[0]),
        expand_ratio=int(options["e"]),
        input_filters=int(options["i"]),
        output_filters=int(options["o"]),
        se_ratio=float(options["se"]) if "se" in options else None,
        id_skip="noskip" not in block_string,
    )


def round_filters(filters: int, gp: GlobalParams) -> int:
    """Width scaling with divisor snapping (reference: utils.py:83-108)."""
    multiplier = gp.width_coefficient
    if not multiplier:
        return filters
    divisor = gp.depth_divisor
    min_depth = gp.min_depth or divisor
    filters *= multiplier
    new_filters = max(min_depth, int(filters + divisor / 2) // divisor * divisor)
    if new_filters < 0.9 * filters:  # never round down by >10%
        new_filters += divisor
    return int(new_filters)


def round_repeats(repeats: int, gp: GlobalParams) -> int:
    """Depth scaling (reference: utils.py:111-126)."""
    if not gp.depth_coefficient:
        return repeats
    return int(math.ceil(gp.depth_coefficient * repeats))


def get_model_params(model_name: str, num_classes: int = 1000,
                     **overrides) -> Tuple[Sequence[BlockArgs], GlobalParams]:
    width, depth, _res, dropout = efficientnet_params(model_name)
    blocks = [decode_block_string(s) for s in B0_BLOCK_STRINGS]
    gp = GlobalParams(width_coefficient=width, depth_coefficient=depth,
                      dropout_rate=dropout, num_classes=num_classes)
    if overrides:
        d = gp.__dict__.copy()
        d.update(overrides)
        gp = GlobalParams(**d)
    return blocks, gp


def _bn(channels: int, momentum: float, eps: float, device,
        dtype: torch.dtype) -> BatchNorm2d:
    # Flax's momentum m keeps m of the old running value; torch's keeps 1 − m.
    return BatchNorm2d(channels, eps=eps, momentum=1.0 - momentum,
                       device=device, out_dtype=dtype)


class MBConvBlock(nn.Module):
    """Mobile inverted bottleneck with SE (reference: model.py:36-140), NCHW."""

    def __init__(self, block_args: BlockArgs, bn_momentum: float,
                 bn_epsilon: float, device=None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        ba = self.block_args = block_args
        inp = ba.input_filters
        oup = ba.input_filters * ba.expand_ratio
        bn = lambda c: _bn(c, bn_momentum, bn_epsilon,  # noqa: E731
                           device, compute_dtype)
        if ba.expand_ratio != 1:
            self._expand_conv = Conv2d(inp, oup, 1, bias=False,
                                       device=device)
            self._bn0 = bn(oup)
        self._depthwise_conv = Conv2dSame(
            oup, oup, ba.kernel_size, stride=ba.stride, groups=oup,
            bias=False, device=device)
        self._bn1 = bn(oup)
        self.has_se = ba.se_ratio is not None and 0 < ba.se_ratio <= 1
        if self.has_se:
            # squeezed from the block's INPUT filters, as the reference does
            squeezed = max(1, int(inp * ba.se_ratio))
            self._se_reduce = Conv2d(oup, squeezed, 1, device=device)
            self._se_expand = Conv2d(squeezed, oup, 1, device=device)
        self._project_conv = Conv2d(oup, ba.output_filters, 1, bias=False,
                                    device=device)
        self._bn2 = bn(ba.output_filters)

    @property
    def has_skip(self) -> bool:
        ba = self.block_args
        return (ba.id_skip and ba.stride == 1
                and ba.input_filters == ba.output_filters)

    def drop_connect_mask(self, x: torch.Tensor, drop_connect_rate: float,
                          generator: Optional[torch.Generator]
                          ) -> Optional[torch.Tensor]:
        """The (B, 1, 1, 1) keep mask of stochastic depth for input x,
        drawn from ``generator`` (Bernoulli(1 − rate) per batch element,
        after reference models/efficientnet/utils.py:129-154); None where
        the block drops nothing (eval mode, rate 0, no identity skip)."""
        if not (self.training and drop_connect_rate and self.has_skip):
            return None
        return keep_mask((x.shape[0], 1, 1, 1), drop_connect_rate, x,
                         generator)

    def forward(self, x: torch.Tensor, drop_connect_rate: float = 0.0,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The block; ``keep`` is its drop-connect mask, drawn before
        (``drop_connect_mask``; None: no drop), so that a recompute under
        ``remat`` uses the same one."""
        ba = self.block_args
        inputs = x
        if ba.expand_ratio != 1:
            x = silu(self._bn0(self._expand_conv(x)))
        x = self._bn1(self._depthwise_conv(x))
        if self.has_se:
            # spatial mean of silu(x) → 1×1 convs applied to the (B, C)
            # vector as dense layers → gate on silu(x)
            se = silu(dense(silu_mean(x), self._se_reduce.weight.flatten(1),
                            self._se_reduce.bias))
            se = dense(se, self._se_expand.weight.flatten(1),
                       self._se_expand.bias)
            x = sigmoid(se)[:, :, None, None] * silu(x)
        else:
            x = silu(x)
        x = self._bn2(self._project_conv(x))
        if self.has_skip:
            if keep is not None:
                x = apply_keep(x, keep, drop_connect_rate)
            x = x + inputs
        return x


class EfficientNet(nn.Module):
    """EfficientNet backbone + classification head on the 1-channel LEAF
    image; input (B, H, W, 1) NHWC."""

    def __init__(self, model_name: str = "efficientnet-b0",
                 num_classes: int = 1000, dropout_rate: Optional[float] = None,
                 drop_connect_rate: Optional[float] = None,
                 compute_dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None,
                 remat: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.remat = remat
        overrides = {}
        if dropout_rate is not None:
            overrides["dropout_rate"] = dropout_rate
        if drop_connect_rate is not None:
            overrides["drop_connect_rate"] = drop_connect_rate
        blocks_args, gp = get_model_params(model_name,
                                           num_classes=num_classes,
                                           **overrides)
        self.drop_connect_rate = gp.drop_connect_rate
        self.dropout_rate = gp.dropout_rate
        bn = lambda c: _bn(c, gp.batch_norm_momentum,  # noqa: E731
                           gp.batch_norm_epsilon, device, compute_dtype)

        stem = round_filters(32, gp)
        self._conv_stem = Conv2dSame(1, stem, 3, stride=2,
                                     bias=False, device=device)
        self._bn0 = bn(stem)

        # Expand per-stage args into the flat per-block list (reference
        # model.py:188-203: the first block carries the stride/filter jump).
        blocks = []
        for ba in blocks_args:
            repeats = round_repeats(ba.num_repeat, gp)
            ba = ba.replace(
                input_filters=round_filters(ba.input_filters, gp),
                output_filters=round_filters(ba.output_filters, gp),
                num_repeat=1,
            )
            for _ in range(repeats):
                blocks.append(MBConvBlock(ba, gp.batch_norm_momentum,
                                          gp.batch_norm_epsilon,
                                          device=device,
                                          compute_dtype=compute_dtype))
                ba = ba.replace(input_filters=ba.output_filters, stride=1)
        self._blocks = nn.ModuleList(blocks)

        head = round_filters(1280, gp)
        self._conv_head = Conv2d(blocks[-1].block_args.output_filters,
                                 head, 1, bias=False, device=device)
        self._bn1 = bn(head)
        self._fc = nn.Linear(head, num_classes, device=device)
        lecun_normal_init_(self, generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        # NHWC → NCHW and to the compute dtype, once
        x = x.permute(0, 3, 1, 2).contiguous().to(self.compute_dtype)
        x = silu(self._bn0(self._conv_stem(x)))
        n = len(self._blocks)
        # remat: each block's activations recomputed in the backward
        # instead of saved (the JAX package's nn.remat per MBConv block)
        checkpointed = (self.remat and self.training
                        and torch.is_grad_enabled())
        for idx, block in enumerate(self._blocks):
            # linearly scaled stochastic depth (reference model.py:262-264)
            rate = self.drop_connect_rate * idx / n
            keep = block.drop_connect_mask(x, rate, generator)
            x = (remat(block, block, x, rate, keep) if checkpointed
                 else block(x, rate, keep))
        x = silu_mean(self._bn1(self._conv_head(x)))
        if self.training and self.dropout_rate:
            x = dropout(x, self.dropout_rate, generator)
        return dense(x, self._fc.weight, self._fc.bias)
