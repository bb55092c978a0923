"""End-to-end audio classifier: LEAF frontend → 1-channel CNN backbone.

Parity with the JAX package's ``leaf_tpu.models.classifier`` (and the
reference's models/classifier.py:7-18): the frontend emits (B, frames,
n_filters); the backbone takes the (B, n_filters, frames, 1) NHWC image.
Submodules are named ``features`` and ``model`` as in the reference, so
``state_dict`` keys read ``features._complex_conv._kernel``,
``model._blocks.0._depthwise_conv.weight`` and so on.

This slice ports the efficientnet backbone only; the other arches raise
``NotImplementedError`` until their slice (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from leaf_tpu_torch import resolve_device
from leaf_tpu_torch.frontend.helper import compute_dtype_of, get_frontend
from leaf_tpu_torch.models.efficientnet import VALID_MODELS, EfficientNet

__all__ = ["Classifier", "get_classifier"]

# Depths the JAX package accepts per arch (leaf_tpu/models/classifier.py).
_PENDING_ARCH_DEPTHS = {
    "densenet": (121, 161, 169, 201),
    "resnet": (18, 34, 50, 101, 152),
    "cifar_resnet": (20, 32, 34, 44, 56, 110),
}


def get_classifier(opt: dict, device=None,
                   generator: Optional[torch.Generator] = None) -> nn.Module:
    """Backbone factory (reference: models/model_helper.py:8-95).

    ``opt`` is the config's ``model`` section: arch, model_depth,
    num_classes. Builds on ``device`` (CUDA unless one is named).
    """
    arch = opt["arch"]
    pending = ("densenet" if "densenet" in arch else arch)
    if pending in _PENDING_ARCH_DEPTHS:
        depth = opt["model_depth"]
        if depth not in _PENDING_ARCH_DEPTHS[pending]:
            raise ValueError(
                f"Invalid value {depth} of depth for {pending} arch")
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet: the rest of the model zoo is a "
            "later slice of the port (ROADMAP Queue 1 item 10)")
    if arch != "efficientnet":
        raise ValueError(f"Unsupported value {arch} for opt['arch']")
    variant = opt["model_depth"]  # e.g. 'b0'
    if f"efficientnet-{variant}" not in VALID_MODELS:
        raise ValueError(
            f"Invalid value {variant} of depth for efficientnet arch")
    kw = {k: float(opt[k]) for k in ("dropout_rate", "drop_connect_rate")
          if k in opt}
    return EfficientNet(model_name=f"efficientnet-{variant}",
                        num_classes=opt["num_classes"],
                        compute_dtype=compute_dtype_of(opt),
                        device=resolve_device(device), generator=generator,
                        **kw)


class Classifier(nn.Module):
    """LEAF features → (B, n_filters, frames, 1) image → backbone logits."""

    def __init__(self, cfg: dict, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.features = get_frontend(cfg, device, generator)
        self.model = get_classifier(cfg["model"], device, generator)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Waveforms → logits. In train mode (``.train()``) BatchNorm uses
        batch statistics and updates its running stats, and dropout and
        drop-connect draw from ``generator`` (on x's device)."""
        out = self.features(x)                      # (B, frames, n_filters)
        return self.model(out.transpose(1, 2)[..., None], generator)

    def features_only(self, x: torch.Tensor) -> torch.Tensor:
        """LEAF features without the backbone — the reference's
        ``model.features`` extraction flow (reference README.md:112-113)."""
        return self.features(x)
