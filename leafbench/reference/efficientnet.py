"""EfficientNet (Tan & Le, 2019) in plain PyTorch, float32, NCHW, on the
1-channel LEAF image: MBConv blocks with squeeze-excite, BatchNorm
(eps 1e-3), SiLU, TF-SAME padded depthwise and stem convolutions,
stochastic depth on identity-skip blocks at rate 0.2·idx/n and dropout
0.2 before the classifier, as the reference leaf-pytorch vendors it
(lukemelas' EfficientNet). Only b0's scaling (width 1.0, depth 1.0) is
written out; the block list is b0's.

In train mode the random masks are drawn from the generator passed to
``forward`` in this order: each identity-skip block's (B, 1, 1, 1)
drop-connect mask (the first block's rate is 0: no draw), then the
(B, 1280) dropout mask.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from leafbench.reference.common import (batch_norm, conv_same, drop,
                                        keep_mask)

# (repeats, kernel, stride, expand, in, out) of b0's seven stages; SE 0.25
B0_STAGES = ((1, 3, 1, 1, 32, 16), (2, 3, 2, 6, 16, 24),
             (2, 5, 2, 6, 24, 40), (3, 3, 2, 6, 40, 80),
             (3, 5, 1, 6, 80, 112), (4, 5, 2, 6, 112, 192),
             (1, 3, 1, 6, 192, 320))
SE_RATIO, BN_EPS = 0.25, 1e-3
DROPOUT, DROP_CONNECT = 0.2, 0.2


def _bn(c, device):
    return nn.BatchNorm2d(c, eps=BN_EPS, device=device)


class MBConv(nn.Module):
    def __init__(self, k: int, stride: int, expand: int, cin: int, cout: int,
                 device=None):
        super().__init__()
        mid = cin * expand
        self.expand, self.stride = expand, stride
        self.has_skip = stride == 1 and cin == cout
        if expand != 1:
            self._expand_conv = nn.Conv2d(cin, mid, 1, bias=False,
                                          device=device)
            self._bn0 = _bn(mid, device)
        self._depthwise_conv = nn.Conv2d(mid, mid, k, stride=stride,
                                         groups=mid, bias=False,
                                         device=device)
        self._bn1 = _bn(mid, device)
        squeezed = max(1, int(cin * SE_RATIO))
        self._se_reduce = nn.Conv2d(mid, squeezed, 1, device=device)
        self._se_expand = nn.Conv2d(squeezed, mid, 1, device=device)
        self._project_conv = nn.Conv2d(mid, cout, 1, bias=False,
                                       device=device)
        self._bn2 = _bn(cout, device)

    def forward(self, x, rate: float, keep: Optional[torch.Tensor]):
        inputs = x
        if self.expand != 1:
            x = F.silu(batch_norm(self._bn0, F.conv2d(
                x, self._expand_conv.weight)))
        x = batch_norm(self._bn1, conv_same(self._depthwise_conv, x))
        x = F.silu(x)
        se = F.linear(x.mean(dim=(2, 3)), self._se_reduce.weight.flatten(1),
                      self._se_reduce.bias)
        se = F.linear(F.silu(se), self._se_expand.weight.flatten(1),
                      self._se_expand.bias)
        x = torch.sigmoid(se)[:, :, None, None] * x
        x = batch_norm(self._bn2, F.conv2d(x, self._project_conv.weight))
        if self.has_skip:
            if keep is not None:
                x = drop(x, keep, rate)
            x = x + inputs
        return x


class Backbone(nn.Module):
    """EfficientNet-b0 on the (B, 1, H, W) image → logits."""

    def __init__(self, cfg_model: dict, device=None):
        super().__init__()
        if str(cfg_model.get("model_depth")) != "b0":
            raise ValueError("the reference writes out efficientnet-b0 only")
        num_classes = int(cfg_model["num_classes"])
        self._conv_stem = nn.Conv2d(1, 32, 3, stride=2, bias=False,
                                    device=device)
        self._bn0 = _bn(32, device)
        blocks = []
        for repeats, k, s, e, cin, cout in B0_STAGES:
            for r in range(repeats):
                blocks.append(MBConv(k, s if r == 0 else 1, e,
                                     cin if r == 0 else cout, cout, device))
        self._blocks = nn.ModuleList(blocks)
        self._conv_head = nn.Conv2d(320, 1280, 1, bias=False, device=device)
        self._bn1 = _bn(1280, device)
        self._fc = nn.Linear(1280, num_classes, device=device)

    def forward(self, x, generator=None):
        x = F.silu(batch_norm(self._bn0, conv_same(self._conv_stem, x)))
        n = len(self._blocks)
        for idx, block in enumerate(self._blocks):
            rate = DROP_CONNECT * idx / n
            keep = None
            if self.training and rate and block.has_skip:
                keep = keep_mask((x.shape[0], 1, 1, 1), rate, x, generator)
            x = block(x, rate, keep)
        x = F.silu(batch_norm(self._bn1, F.conv2d(x, self._conv_head.weight)))
        x = x.mean(dim=(2, 3))
        if self.training:
            x = drop(x, keep_mask(x.shape, DROPOUT, x, generator), DROPOUT)
        return F.linear(x, self._fc.weight, self._fc.bias)


def weight_std(name: str, shape: tuple) -> Optional[float]:
    """LeCun-normal scale √(1/fan_in) for every conv and linear weight."""
    if not name.endswith("weight") or len(shape) < 2:
        return None
    return math.sqrt(1.0 / math.prod(shape[1:]))
