"""Import reference (leaf-pytorch) classifier checkpoints into the port.

- ``load_reference_checkpoint``: a reference ``.pth`` → its ``state_dict``;
- ``import_torch_classifier``: that ``state_dict`` → a port ``Classifier``;
- ``convert_frontend_state_dict``: its LEAF frontend → the JAX package's
  ``frontend_params.npz`` layout (``KEY_MAP``), the file
  ``frontend.pretrained`` names in a cfg.

The CLIs ``python -m leaf_tpu_torch.import_torch_classifier`` and
``.convert_torch_checkpoint`` are these functions behind an argument
parser. The port's ``Classifier`` keeps the reference's tensor names (frontend
``features.*``, backbone ``model.*``, parameters and BatchNorm running
statistics), so a reference ``state_dict`` loads with no key map — the
counterpart of ``leaf_tpu.models.torch_import.import_torch_classifier``,
which maps the same dict onto Flax variables. What is checked is what
the JAX function checks: every tensor of the model is covered, no key
is left over, and every shape fits; a ``DataParallel`` wrapper's
``module.`` prefix is stripped. DenseNet is not importable, as in the
JAX package: the reference's own densenet factories are dead code
(models/densenet.py NameError — see PARITY.md).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

__all__ = ["import_torch_classifier", "load_reference_checkpoint",
           "convert_frontend_state_dict"]

IMPORTABLE_ARCHS = ("efficientnet", "resnet", "cifar_resnet")

# reference frontend key (after ``features.``) → npz path and transform
KEY_MAP = {
    "_complex_conv._kernel": ("complex_conv", "kernel", None),
    "_pooling.weights": ("pooling", "weights", lambda a: a.reshape(-1)),
    "_pooling._bias": ("pooling", "bias", None),
    "_compression.alpha": ("compression", "alpha", None),
    "_compression.delta": ("compression", "delta", None),
    "_compression.root": ("compression", "root", None),
    "_compression.ema._weights": ("compression", "ema", "weights", None),
}


def convert_frontend_state_dict(state_dict: dict) -> dict:
    """A reference ``state_dict`` (torch tensors or arrays) → the LEAF
    frontend's tensors as a flat {npz path: float32 ndarray}; every other
    key is passed over."""
    out = {}
    for key, value in state_dict.items():
        # strip common prefixes: 'features.' (Classifier) or 'module.'
        k = key
        for prefix in ("module.", "features.", "model.features."):
            if k.startswith(prefix):
                k = k[len(prefix):]
        if k not in KEY_MAP:
            continue
        *path, transform = KEY_MAP[k]
        arr = np.asarray(value.detach().cpu().numpy()
                         if hasattr(value, "detach") else value,
                         dtype=np.float32)
        if transform is not None:
            arr = transform(arr)
        out["/".join(path)] = arr
    return out


def load_reference_checkpoint(path: str, device) -> tuple:
    """(state_dict, the raw object) of a reference ``.pth``: training
    checkpoints hold the weights under ``model_state_dict`` (reference
    train_xla.py:38-41); exports may use ``state_dict`` or ``model``, or
    be a bare ``state_dict`` or ``nn.Module``. The file is unpickled whole
    (it may hold more than tensors): open only checkpoints you trust."""
    raw = torch.load(path, map_location=device, weights_only=False)
    state_dict = raw
    if isinstance(raw, dict):
        state_dict = (raw.get("model_state_dict") or raw.get("state_dict")
                      or raw.get("model") or raw)
    if hasattr(state_dict, "state_dict"):
        state_dict = state_dict.state_dict()
    return state_dict, raw


def import_torch_classifier(state_dict: Dict[str, torch.Tensor],
                            model: nn.Module, arch: str) -> nn.Module:
    """Load a reference classifier ``state_dict`` into ``model`` (a port
    ``Classifier`` of the same arch, depth and class count), strictly;
    returns ``model``.

    Raises ``NotImplementedError`` for an arch the reference cannot
    export (``densenet``), and ``RuntimeError`` naming each missing,
    unexpected or misshaped key before any tensor is copied, so a
    refused import leaves ``model`` as it was.
    """
    if arch not in IMPORTABLE_ARCHS:
        raise NotImplementedError(
            f"arch '{arch}' is not importable (reference densenet "
            f"factories are dead code — models/densenet.py NameError)")
    # the prefix a (Distributed)DataParallel wrapper adds to every key
    state_dict = {k[len("module."):] if k.startswith("module.") else k: v
                  for k, v in state_dict.items()}
    own = model.state_dict()
    errors = []
    missing = [k for k in own if k not in state_dict]
    if missing:
        errors.append("Missing key(s) in state_dict: "
                      + ", ".join(f'"{k}"' for k in missing) + ".")
    unexpected = [k for k in state_dict if k not in own]
    if unexpected:
        errors.append("Unexpected key(s) in state_dict: "
                      + ", ".join(f'"{k}"' for k in unexpected) + ".")
    errors += [f"size mismatch for {k}: copying a param with shape "
               f"{tuple(v.shape)} from checkpoint, the shape in current "
               f"model is {tuple(own[k].shape)}."
               for k, v in state_dict.items()
               if k in own and tuple(v.shape) != tuple(own[k].shape)]
    if errors:
        raise RuntimeError(
            f"Error(s) in importing a reference {arch} state_dict into "
            f"{type(model).__name__}:\n\t" + "\n\t".join(errors))
    model.load_state_dict(state_dict, strict=True)
    return model
