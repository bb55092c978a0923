"""CIFAR-style ResNet (Idelbayev variant) in PyTorch (NCHW), 1-channel
stem.

Parity with the JAX package's ``leaf_tpu.models.cifar_resnet`` and the
reference's models/vanilla_cifar_resnet.py:56-190: three stages of
[32, 64, 128] planes, a 32-channel 7×7/2 stem and a 3×3/2 max-pool,
option-A parameter-free shortcuts (``x[:, :, ::2, ::2]`` zero-padded by
planes//4 channels on each side; option B is a 1×1 conv + BatchNorm
projection), global average pool and a ``linear`` head. Convs and the
head take the kaiming fan-out init (reference ``_weights_init``), the
head's bias zero; BatchNorm keeps Flax's init (scale 1, bias 0), momentum
0.9 (torch 0.1) and eps 1e-5.

Names are the reference's (``conv1``, ``bn1``, ``layer1.0.conv1``,
``layer2.0.shortcut.0`` / ``.1`` under option B, ``linear``). The bf16
policy is ``resnet``'s.

Factories resnet20/32/44/56/110/1202 and the custom resnet34
(reference:148-175).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from leaf_tpu_torch.models.common import (BatchNorm2d, Conv2d, dense,
                                          global_avg_pool,
                                          kaiming_normal_fan_out_,
                                          max_pool_same)

__all__ = [
    "BasicBlock",
    "CifarResNet",
    "resnet20",
    "resnet32",
    "resnet44",
    "resnet56",
    "resnet110",
    "resnet1202",
    "resnet34_custom",
]


def _bn(channels: int, device, dtype: torch.dtype) -> BatchNorm2d:
    return BatchNorm2d(channels, eps=1e-5, momentum=0.1, device=device,
                       out_dtype=dtype)


class BasicBlock(nn.Module):
    """3×3 + 3×3 residual block with an option-A (or B) shortcut
    (reference:56-88)."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 option: str = "A", device=None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(in_planes, planes, 3, stride=stride, padding=1,
                            bias=False, device=device)
        self.bn1 = _bn(planes, device, compute_dtype)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False,
                            device=device)
        self.bn2 = _bn(planes, device, compute_dtype)
        self.pad = None   # option A: channels zero-padded on each side
        self.shortcut = None
        if stride != 1 or in_planes != planes:
            if option == "A":
                self.pad = planes // 4
            else:
                self.shortcut = nn.Sequential(
                    Conv2d(in_planes, planes, 1, stride=stride, bias=False,
                           device=device),
                    _bn(planes, device, compute_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.pad is not None:
            shortcut = F.pad(x[:, :, ::2, ::2],
                             (0, 0, 0, 0, self.pad, self.pad))
        elif self.shortcut is not None:
            shortcut = self.shortcut(x)
        else:
            shortcut = x
        return F.relu(out + shortcut)


class CifarResNet(nn.Module):
    """CIFAR ResNet + linear head on the 1-channel LEAF image; input
    (B, H, W, 1) NHWC. Weights are drawn on the CPU from ``generator``."""

    def __init__(self, num_blocks: Sequence[int] = (3, 3, 3),
                 num_classes: int = 10, option: str = "A",
                 compute_dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv1 = Conv2d(1, 32, 7, stride=2, padding=3, bias=False,
                            device=device)
        self.bn1 = _bn(32, device, compute_dtype)
        in_planes = 32
        for stage, (planes, blocks) in enumerate(zip((32, 64, 128),
                                                     num_blocks)):
            stride = 1 if stage == 0 else 2
            seq = []
            for i in range(blocks):
                seq.append(BasicBlock(in_planes, planes,
                                      stride if i == 0 else 1, option,
                                      device, compute_dtype))
                in_planes = planes
            setattr(self, f"layer{stage + 1}", nn.Sequential(*seq))
        self.linear = nn.Linear(in_planes, num_classes, device=device)
        for m in self.modules():
            if isinstance(m, (Conv2d, nn.Linear)):
                kaiming_normal_fan_out_(m.weight, generator)
        nn.init.zeros_(self.linear.bias)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits; ``generator`` is unused (nothing here is random)."""
        x = x.permute(0, 3, 1, 2).contiguous().to(self.compute_dtype)
        x = max_pool_same(F.relu(self.bn1(self.conv1(x))))
        for stage in (self.layer1, self.layer2, self.layer3):
            x = stage(x)
        return dense(global_avg_pool(x), self.linear.weight,
                     self.linear.bias)


def _factory(blocks):
    def make(num_classes: int = 10, **kw) -> CifarResNet:
        return CifarResNet(blocks, num_classes=num_classes, **kw)
    return make


resnet20 = _factory((3, 3, 3))
resnet32 = _factory((5, 5, 5))
resnet44 = _factory((7, 7, 7))
resnet56 = _factory((9, 9, 9))
resnet110 = _factory((18, 18, 18))
resnet1202 = _factory((200, 200, 200))
resnet34_custom = _factory((4, 6, 6))  # reference:172-173
