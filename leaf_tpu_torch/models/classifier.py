"""End-to-end audio classifier: LEAF frontend → 1-channel CNN backbone.

Parity with the JAX package's ``leaf_tpu.models.classifier`` (and the
reference's models/classifier.py:7-18): the frontend emits (B, frames,
n_filters); the backbone takes the (B, n_filters, frames, 1) NHWC image.
Submodules are named ``features`` and ``model`` as in the reference, so
``state_dict`` keys read ``features._complex_conv._kernel``,
``model._blocks.0._depthwise_conv.weight``, ``model.layer1.0.conv1.weight``
and so on.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from leaf_tpu_torch import resolve_device, tracing
from leaf_tpu_torch.frontend.helper import compute_dtype_of, get_frontend
from leaf_tpu_torch.models import cifar_resnet, densenet, resnet
from leaf_tpu_torch.models.efficientnet import VALID_MODELS, EfficientNet

__all__ = ["Classifier", "get_classifier"]

_DENSENETS = {121: densenet.densenet121, 161: densenet.densenet161,
              169: densenet.densenet169, 201: densenet.densenet201}
_RESNETS = {18: resnet.resnet18, 34: resnet.resnet34, 50: resnet.resnet50,
            101: resnet.resnet101, 152: resnet.resnet152}
_CIFAR_RESNETS = {20: cifar_resnet.resnet20, 32: cifar_resnet.resnet32,
                  34: cifar_resnet.resnet34_custom, 44: cifar_resnet.resnet44,
                  56: cifar_resnet.resnet56, 110: cifar_resnet.resnet110}


def _factory(table: dict, depth, arch: str):
    if depth not in table:
        raise ValueError(f"Invalid value {depth} of depth for {arch} arch")
    return table[depth]


def get_classifier(opt: dict, device=None,
                   generator: Optional[torch.Generator] = None) -> nn.Module:
    """Backbone factory (reference: models/model_helper.py:8-95), as the
    JAX package's ``get_classifier`` dispatches.

    ``opt`` is the config's ``model`` section: arch ∈ {densenet, resnet,
    cifar_resnet, efficientnet}, model_depth, num_classes, pool (resnet
    18/34/50 only), compute_dtype (every arch), dropout_rate,
    drop_connect_rate and remat (efficientnet only). Builds on ``device``
    (CUDA unless one is named), drawing the weights from ``generator``.
    """
    num_classes = opt["num_classes"]
    arch = opt["arch"]
    kw = {"compute_dtype": compute_dtype_of(opt),
          "device": resolve_device(device), "generator": generator}
    if "densenet" in arch:
        make = _factory(_DENSENETS, opt["model_depth"], "densenet")
        return make(num_classes=num_classes, **kw)
    if arch == "resnet":
        depth = opt["model_depth"]
        make = _factory(_RESNETS, depth, "resnet")
        if depth in (18, 34, 50):
            kw["pool"] = opt.get("pool", "avgpool")
        return make(num_classes=num_classes, **kw)
    if arch == "cifar_resnet":
        make = _factory(_CIFAR_RESNETS, opt["model_depth"], "cifar_resnet")
        return make(num_classes=num_classes, **kw)
    if arch != "efficientnet":
        raise ValueError(f"Unsupported value {arch} for opt['arch']")
    variant = opt["model_depth"]  # e.g. 'b0'
    if f"efficientnet-{variant}" not in VALID_MODELS:
        raise ValueError(
            f"Invalid value {variant} of depth for efficientnet arch")
    # optional rate overrides, mirroring the reference's from_name
    # override_params (model.py:324-334)
    for k in ("dropout_rate", "drop_connect_rate"):
        if k in opt:
            kw[k] = float(opt[k])
    if "remat" in opt:
        kw["remat"] = bool(opt["remat"])
    return EfficientNet(model_name=f"efficientnet-{variant}",
                        num_classes=num_classes, **kw)


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
        drop-connect draw from ``generator`` (on x's device). Marks the
        frontend and backbone phases on the device (``tracing``)."""
        tracing.mark("mark_forward", x)
        out = tracing.boundary(self.features(x))    # (B, frames, n_filters)
        logits = self.model(out.transpose(1, 2)[..., None], generator)
        tracing.mark("mark_backbone", logits)
        return logits

    def features_only(self, x: torch.Tensor) -> torch.Tensor:
        """LEAF features without the backbone — the reference's
        ``model.features`` extraction flow (reference README.md:112-113)."""
        return self.features(x)
