"""One-call pretrained-backbone loading.

``leaf_tpu.models.pretrained`` in the port: resolve a local weights file
OR a published model name (the lukemelas ImageNet EfficientNet weights,
reference models/efficientnet/utils.py:556-617) through the local caches
by the published filename convention, then a download attempt, and load
the backbone ``state_dict`` into a port model with the semantics of the
JAX package's ``import_torch_backbone``.

The port's weight names are leaf-pytorch's, which for EfficientNet are
lukemelas's and for ResNet torchvision's, so the load is a filtered
``load_state_dict``, not a name map.

Example::

    model = Classifier(cfg, device="cuda")
    load_pretrained_backbone("efficientnet-b0", model, arch="efficientnet")
    # or an explicit file:
    load_pretrained_backbone("/weights/efficientnet-b0-355c32eb.pth",
                             model, arch="efficientnet")
"""

from __future__ import annotations

import glob
import os
from typing import Dict, Optional

import torch
from torch import nn

__all__ = ["load_pretrained_backbone", "EFFICIENTNET_URLS"]

# Published ImageNet weights, reference models/efficientnet/utils.py:556-566
# (the AutoAugment set; the reference also carries an AdvProp map at
# utils.py:570-580 — pass an explicit file path to use those).
EFFICIENTNET_URLS = {
    "efficientnet-b0": "https://github.com/lukemelas/EfficientNet-PyTorch/releases/download/1.0/efficientnet-b0-355c32eb.pth",  # noqa: E501
    "efficientnet-b1": "https://github.com/lukemelas/EfficientNet-PyTorch/releases/download/1.0/efficientnet-b1-f1951068.pth",  # noqa: E501
    "efficientnet-b2": "https://github.com/lukemelas/EfficientNet-PyTorch/releases/download/1.0/efficientnet-b2-8bb594d6.pth",  # noqa: E501
    "efficientnet-b3": "https://github.com/lukemelas/EfficientNet-PyTorch/releases/download/1.0/efficientnet-b3-5fb5a3c3.pth",  # noqa: E501
    "efficientnet-b4": "https://github.com/lukemelas/EfficientNet-PyTorch/releases/download/1.0/efficientnet-b4-6ed6700e.pth",  # noqa: E501
    "efficientnet-b5": "https://github.com/lukemelas/EfficientNet-PyTorch/releases/download/1.0/efficientnet-b5-b6417697.pth",  # noqa: E501
    "efficientnet-b6": "https://github.com/lukemelas/EfficientNet-PyTorch/releases/download/1.0/efficientnet-b6-c76e70fd.pth",  # noqa: E501
    "efficientnet-b7": "https://github.com/lukemelas/EfficientNet-PyTorch/releases/download/1.0/efficientnet-b7-dcc49843.pth",  # noqa: E501
}

# the head module and the stem conv of each importable backbone
_FINAL_LAYER = {"resnet": "fc", "cifar_resnet": "linear",
                "efficientnet": "_fc"}
_STEM_CONV = {"resnet": "conv1.weight", "cifar_resnet": "conv1.weight",
              "efficientnet": "_conv_stem.weight"}


def _cache_dirs():
    """Where to look for already-downloaded weight files: the JAX
    package's cache (one file serves both), then torch hub's (the
    reference's model_zoo.load_url target)."""
    dirs = [os.path.expanduser("~/.cache/leaf_tpu/pretrained")]
    hub = os.environ.get("TORCH_HOME")
    if hub:
        dirs.append(os.path.join(hub, "hub", "checkpoints"))
    dirs.append(os.path.expanduser("~/.cache/torch/hub/checkpoints"))
    return dirs


def _resolve_weights(name_or_path: str) -> str:
    """A filesystem path is used as-is; a model name resolves through the
    local caches by the published filename convention, then (last resort)
    a download attempt — hosts without egress get an error naming the
    URL instead of a hang."""
    if os.path.exists(name_or_path):
        return name_or_path
    url = EFFICIENTNET_URLS.get(name_or_path)
    if url is None:
        raise FileNotFoundError(
            f"'{name_or_path}' is neither a weights file nor a known "
            f"pretrained model name (known: {sorted(EFFICIENTNET_URLS)})")
    fname = os.path.basename(url)
    stem = fname.split("-")[:-1]  # drop the hash suffix for glob matching
    for d in _cache_dirs():
        exact = os.path.join(d, fname)
        if os.path.exists(exact):
            return exact
        loose = glob.glob(os.path.join(d, "-".join(stem) + "-*.pth"))
        if loose:
            return loose[0]
    try:
        dst = _cache_dirs()[0]
        os.makedirs(dst, exist_ok=True)
        path = os.path.join(dst, fname)
        torch.hub.download_url_to_file(url, path, progress=False)
        return path
    except Exception as e:
        raise FileNotFoundError(
            f"pretrained weights for '{name_or_path}' not found locally "
            f"and the download failed ({type(e).__name__}: {e}). Download "
            f"{url} on a host with network access and place it in "
            f"{_cache_dirs()[0]}/ (or pass its path directly).") from e


def load_pretrained_backbone(name_or_path: str, model: nn.Module, arch: str,
                             load_fc: bool = False,
                             state_dict: Optional[Dict] = None) -> nn.Module:
    """Load torch backbone weights into a port ``Classifier`` (or a bare
    backbone), in place; returns ``model``.

    Args:
      name_or_path: weights file path, or a published model name
        (``efficientnet-b0`` … ``b7``) resolved via the local caches /
        a download attempt.
      model: the target; a ``Classifier``'s frontend is left untouched.
      arch: ``efficientnet`` / ``resnet`` / ``cifar_resnet``.
      load_fc: False (default) keeps the model's fresh head (the
        reference's fc-swap, models/model_helper.py:78-94); True requires
        a matching class count.
      state_dict: an already-loaded ``state_dict`` (skips the file).

    As the JAX ``import_torch_backbone``: ``module.`` and ``model.``
    prefixes are stripped and ``num_batches_tracked`` ignored; a stem
    conv whose in-channels differ (ImageNet's 3 against the audio
    stem's 1) is skipped and the fresh stem kept (reference
    ``_change_in_channels``); an unknown key, any other shape mismatch,
    and any backbone tensor the weights leave uncovered raise.
    """
    if arch not in _FINAL_LAYER:
        raise NotImplementedError(
            f"arch '{arch}' is not importable (reference densenet "
            f"factories are dead code — models/densenet.py NameError)")
    if state_dict is None:
        state_dict = torch.load(_resolve_weights(name_or_path),
                                map_location="cpu", weights_only=True)
    if hasattr(state_dict, "state_dict"):  # a full nn.Module was saved
        state_dict = state_dict.state_dict()
    if "state_dict" in state_dict and isinstance(
            state_dict["state_dict"], dict):
        state_dict = state_dict["state_dict"]

    backbone = getattr(model, "model", model)
    target = {k: v for k, v in backbone.state_dict().items()
              if not k.endswith("num_batches_tracked")}
    final, stem = _FINAL_LAYER[arch], _STEM_CONV[arch]
    head = {f"{final}.weight", f"{final}.bias"}
    values, fresh = {}, set(head)
    for key, value in state_dict.items():
        k = key
        for prefix in ("module.", "model."):
            if k.startswith(prefix):
                k = k[len(prefix):]
        if k.endswith("num_batches_tracked"):
            continue
        if not load_fc and k in head:
            continue   # the fresh head, reference fc-swap semantics
        if k not in target:
            raise KeyError(f"unrecognized torch backbone key: '{key}'")
        value = torch.as_tensor(value)
        if value.shape != target[k].shape:
            if k == stem:
                fresh.add(k)   # in-channel mismatch: keep the fresh stem
                continue
            raise ValueError(f"shape mismatch importing '{key}': torch "
                             f"{tuple(value.shape)} vs ours "
                             f"{tuple(target[k].shape)}")
        values[k] = value
    missing = sorted(k for k in target if k not in values and k not in fresh)
    if missing:
        raise ValueError(f"backbone checkpoint left {len(missing)} of our "
                         f"tensors unfilled (first: {missing[:8]})")
    with torch.no_grad():
        for k, value in values.items():
            target[k].copy_(value)
    return model
