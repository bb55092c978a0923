"""The classifier: LEAF features (B, frames, F) as the (B, 1, F, frames)
image of a 1-channel backbone (``reference/<model.arch>.py``)."""

from __future__ import annotations

import importlib

import torch
from torch import nn

from leafbench.reference.leaf import Leaf


def backbone_module(cfg: dict):
    """The reference module of the cfg's backbone: ``leafbench.reference.
    <model.arch>``."""
    return importlib.import_module(f"leafbench.reference."
                                   f"{cfg['model']['arch']}")


class Classifier(nn.Module):
    def __init__(self, cfg: dict, device=None):
        super().__init__()
        fe, ac = cfg["frontend"], cfg.get("audio_config", {})
        if not fe["name"].lower().startswith("leaf"):
            raise ValueError(f"the reference has the LEAF frontend only: "
                             f"{fe['name']!r}")
        sr = int(ac.get("sample_rate", 16000))
        if fe.get("default_args", False):
            self.features = Leaf(device=device)
        else:
            if (sr != 16000 or float(ac.get("window_len", 25.0)) != 25.0
                    or float(ac.get("window_stride", 10.0)) != 10.0
                    or fe.get("preemp") or fe.get("mean_var_norm")
                    or not fe.get("pcen_compress", True)):
                raise ValueError("the reference has LEAF's default geometry "
                                 "only: 16 kHz, 401 taps, stride 160, sPCEN")
            self.features = Leaf(
                n_filters=int(fe.get("n_filters", 40)), sample_rate=sr,
                min_freq=float(fe.get("min_freq", 60.0)),
                max_freq=float(fe.get("max_freq", 7800.0)), device=device)
        self.model = backbone_module(cfg).Backbone(cfg["model"], device)

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        feats = self.features(x)
        return self.model(feats.transpose(1, 2)[:, None], generator)
