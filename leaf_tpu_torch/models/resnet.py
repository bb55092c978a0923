"""ResNet family in PyTorch (NCHW), 1-channel audio stem.

Parity with the JAX package's ``leaf_tpu.models.resnet`` and the
reference's torchvision-style audio ResNet (reference: models/resnet.py):
BasicBlock / Bottleneck, a 1-channel 7×7/2 stem and a 3×3/2 max-pool,
four stages of [64, 128, 256, 512] planes, an average-pool or NetVLAD
head ('vlad': fc on 8192·expansion features), kaiming fan-out conv init,
BatchNorm scale N(1, 0.02) (zero on each block's last BatchNorm under
``zero_init_residual``), ``groups`` / ``width_per_group`` for the wide
and resnext variants. Convs pad k//2 on every side (torch's symmetric
padding, not TF-SAME) and have no bias; BatchNorm keeps Flax's momentum
0.9 (torch momentum 0.1) and eps 1e-5. The fc is Flax's default Dense
(lecun-normal kernel, zero bias).

Module and parameter names are the reference's (``conv1``, ``bn1``,
``layer1.0.conv1``, ``layer2.0.downsample.0`` / ``.1``, ``fc``, and the
NetVLAD head as ``avgpool``), so ``leaf_tpu.models.torch_import`` reads a
port ``state_dict`` unchanged.

Input: the NHWC (B, H, W, 1) image the classifier builds, permuted once
to NCHW and cast once to ``compute_dtype``. Under bf16 each conv hands
its unrounded f32 sums to its BatchNorm, which returns bf16
(``common.Conv2d``, ``common.BatchNorm2d``); relu, the residual add, the
max-pool, the average pool and the fc run in bf16.
"""

from __future__ import annotations

from typing import Optional, Sequence, Type

import torch
import torch.nn.functional as F
from torch import nn

from leaf_tpu_torch.models.common import (BatchNorm2d, Conv2d,
                                          bn_scale_normal_, dense,
                                          global_avg_pool,
                                          kaiming_normal_fan_out_,
                                          lecun_normal_, max_pool_same)
from leaf_tpu_torch.models.netvlad import NetVLAD

__all__ = [
    "BasicBlock",
    "Bottleneck",
    "ResNet",
    "resnet18",
    "resnet34",
    "resnet50",
    "resnet101",
    "resnet152",
    "wide_resnet50_2",
    "wide_resnet101_2",
    "resnext50_32x4d",
    "resnext101_32x8d",
]


def _conv(cin: int, cout: int, kernel: int, stride: int = 1,
          groups: int = 1, device=None) -> Conv2d:
    return Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2,
                  groups=groups, bias=False, device=device)


def _bn(channels: int, device, dtype: torch.dtype) -> BatchNorm2d:
    # Flax momentum 0.9 keeps 0.9 of the old running value: torch's 0.1
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1, device=device,
                       out_dtype=dtype)


class BasicBlock(nn.Module):
    """Two 3×3 convs, the stride on the first (reference:
    models/resnet.py:20-58). ``groups`` and ``base_width`` are ignored,
    as in the JAX package."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None, groups: int = 1,
                 base_width: int = 64, device=None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride, device=device)
        self.bn1 = _bn(planes, device, compute_dtype)
        self.conv2 = _conv(planes, planes, 3, device=device)
        self.bn2 = _bn(planes, device, compute_dtype)
        self.downsample = downsample

    def last_bn(self) -> BatchNorm2d:
        return self.bn2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    """1×1 → 3×3 (stride, groups) → 1×1 (reference: models/resnet.py:
    174-214); width = ⌊planes·base_width/64⌋·groups."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: Optional[nn.Module] = None, groups: int = 1,
                 base_width: int = 64, device=None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = _conv(inplanes, width, 1, device=device)
        self.bn1 = _bn(width, device, compute_dtype)
        self.conv2 = _conv(width, width, 3, stride, groups, device=device)
        self.bn2 = _bn(width, device, compute_dtype)
        self.conv3 = _conv(width, planes * self.expansion, 1, device=device)
        self.bn3 = _bn(planes * self.expansion, device, compute_dtype)
        self.downsample = downsample

    def last_bn(self) -> BatchNorm2d:
        return self.bn3

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + identity)


class ResNet(nn.Module):
    """ResNet backbone + head on the 1-channel LEAF image; input
    (B, H, W, 1) NHWC. Weights are drawn on the CPU from ``generator``."""

    def __init__(self, block: Type[nn.Module] = BasicBlock,
                 layers: Sequence[int] = (2, 2, 2, 2),
                 num_classes: int = 1000, pool: str = "avgpool",
                 zero_init_residual: bool = False, groups: int = 1,
                 width_per_group: int = 64,
                 compute_dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv1 = _conv(1, 64, 7, 2, device=device)
        self.bn1 = _bn(64, device, compute_dtype)
        inplanes = 64
        for stage, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                     layers)):
            stride = 1 if stage == 0 else 2
            seq = []
            for i in range(blocks):
                s = stride if i == 0 else 1
                downsample = None
                if i == 0 and (s != 1 or inplanes != planes * block.expansion):
                    downsample = nn.Sequential(
                        _conv(inplanes, planes * block.expansion, 1, s,
                              device=device),
                        _bn(planes * block.expansion, device, compute_dtype))
                seq.append(block(inplanes, planes, s, downsample, groups,
                                 width_per_group, device=device,
                                 compute_dtype=compute_dtype))
                inplanes = planes * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*seq))
        if pool == "vlad":
            # the reference holds its NetVLAD head under the avgpool name
            self.avgpool = NetVLAD(dim=inplanes, device=device,
                                   generator=generator)
            features = self.avgpool.centroids.shape[0] * inplanes
        else:
            self.avgpool = None
            features = inplanes
        self.fc = nn.Linear(features, num_classes, device=device)

        # the backbone's convs (common.Conv2d; not NetVLAD's assignment
        # conv, which its centroids set) and BatchNorms
        for m in self.modules():
            if isinstance(m, Conv2d):
                kaiming_normal_fan_out_(m.weight, generator)
            elif isinstance(m, BatchNorm2d):
                bn_scale_normal_(m.weight, generator)
        if zero_init_residual:
            for m in self.modules():
                if isinstance(m, (BasicBlock, Bottleneck)):
                    nn.init.zeros_(m.last_bn().weight)
        lecun_normal_(self.fc.weight, generator)
        nn.init.zeros_(self.fc.bias)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits; ``generator`` is unused (nothing here is random)."""
        x = x.permute(0, 3, 1, 2).contiguous().to(self.compute_dtype)
        x = max_pool_same(F.relu(self.bn1(self.conv1(x))))
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
        x = global_avg_pool(x) if self.avgpool is None else self.avgpool(x)
        return dense(x, self.fc.weight, self.fc.bias)


def _factory(block, layers):
    def make(num_classes: int = 1000, pool: str = "avgpool", **kw) -> ResNet:
        return ResNet(block, layers, num_classes=num_classes, pool=pool,
                      **kw)
    return make


resnet18 = _factory(BasicBlock, (2, 2, 2, 2))
resnet34 = _factory(BasicBlock, (3, 4, 6, 3))
resnet50 = _factory(Bottleneck, (3, 4, 6, 3))
resnet101 = _factory(Bottleneck, (3, 4, 23, 3))
resnet152 = _factory(Bottleneck, (3, 8, 36, 3))


def wide_resnet50_2(num_classes: int = 1000, **kw) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 6, 3), num_classes=num_classes,
                  width_per_group=128, **kw)


def wide_resnet101_2(num_classes: int = 1000, **kw) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 23, 3), num_classes=num_classes,
                  width_per_group=128, **kw)


def resnext50_32x4d(num_classes: int = 1000, **kw) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 6, 3), num_classes=num_classes,
                  groups=32, width_per_group=4, **kw)


def resnext101_32x8d(num_classes: int = 1000, **kw) -> ResNet:
    return ResNet(Bottleneck, (3, 4, 23, 3), num_classes=num_classes,
                  groups=32, width_per_group=8, **kw)
