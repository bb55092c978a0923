"""ResNet-18 (He et al., 2016) in plain PyTorch, float32, NCHW, on the
1-channel LEAF image, as the reference leaf-pytorch builds it: a 7×7/2
stem, a 3×3/2 max-pool (padding 1), four stages of two BasicBlocks
([64, 128, 256, 512] planes, 1×1 strided projections where the shape
changes), BatchNorm (eps 1e-5), ReLU, global average pooling and a
linear classifier. Nothing in it is random at train time.
"""

from __future__ import annotations

import math
from typing import Optional

import torch.nn.functional as F
from torch import nn

from leafbench.reference.common import batch_norm


def _conv(cin, cout, k, stride, device):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2,
                     bias=False, device=device)


def _bn(c, device):
    return nn.BatchNorm2d(c, eps=1e-5, device=device)


class BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride, device):
        super().__init__()
        self.conv1 = _conv(cin, cout, 3, stride, device)
        self.bn1 = _bn(cout, device)
        self.conv2 = _conv(cout, cout, 3, 1, device)
        self.bn2 = _bn(cout, device)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(_conv(cin, cout, 1, stride,
                                                  device), _bn(cout, device))

    def forward(self, x):
        identity = x
        if self.downsample is not None:
            conv, bn = self.downsample
            identity = batch_norm(bn, conv(x))
        out = F.relu(batch_norm(self.bn1, self.conv1(x)))
        out = batch_norm(self.bn2, self.conv2(out))
        return F.relu(out + identity)


class Backbone(nn.Module):
    """ResNet-18 with average pooling on the (B, 1, H, W) image → logits."""

    def __init__(self, cfg_model: dict, device=None):
        super().__init__()
        if int(cfg_model.get("model_depth")) != 18 or \
                cfg_model.get("pool", "avgpool") != "avgpool":
            raise ValueError("the reference writes out resnet-18 with "
                             "average pooling only")
        self.conv1 = _conv(1, 64, 7, 2, device)
        self.bn1 = _bn(64, device)
        cin = 64
        for stage, planes in enumerate((64, 128, 256, 512)):
            stride = 1 if stage == 0 else 2
            setattr(self, f"layer{stage + 1}", nn.Sequential(
                BasicBlock(cin, planes, stride, device),
                BasicBlock(planes, planes, 1, device)))
            cin = planes
        self.fc = nn.Linear(512, int(cfg_model["num_classes"]), device=device)

    def forward(self, x, generator=None):
        x = F.relu(batch_norm(self.bn1, self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
        return F.linear(x.mean(dim=(2, 3)), self.fc.weight, self.fc.bias)


def weight_std(name: str, shape: tuple) -> Optional[float]:
    """He-normal in fan-out mode √(2/(O·kH·kW)) for the convolutions and
    LeCun-normal √(1/fan_in) for the classifier."""
    if not name.endswith("weight") or len(shape) < 2:
        return None
    if len(shape) == 2:
        return math.sqrt(1.0 / shape[1])
    return math.sqrt(2.0 / (shape[0] * math.prod(shape[2:])))
