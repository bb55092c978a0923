"""Carry weights from the JAX package into the port's modules.

``load_jax_variables(module, variables)`` takes the JAX
``{"params": …, "batch_stats": …}`` tree, as nested mappings of arrays
(numpy arrays, or anything ``np.asarray`` reads), and copies it into a
port ``Classifier``, ``Leaf``, ``EfficientNet`` or ``MBConvBlock``. It is
the inverse of ``leaf_tpu.models.torch_import`` and refuses partial
loads: a port tensor with no JAX leaf, a JAX leaf no port tensor takes,
or a leaf of the wrong shape raises.

Layout maps (JAX/Flax NHWC → PyTorch):
  conv ``kernel`` HWIO                → ``weight`` OIHW
  depthwise ``kernel`` (k, k, 1, C)   → (C, 1, k, k)  (the same transpose)
  ``_PointwiseDense`` (1, 1, Cin, Cout) → 1×1 conv weight (Cout, Cin, 1, 1)
  Dense ``kernel`` (I, O)             → Linear ``weight`` (O, I)
  BatchNorm ``scale``/``bias``        → ``weight``/``bias``
            ``mean``/``var`` (batch_stats) → ``running_mean``/``running_var``
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from leaf_tpu_torch.frontend.frontend import Leaf
from leaf_tpu_torch.models.classifier import Classifier
from leaf_tpu_torch.models.efficientnet import EfficientNet, MBConvBlock

__all__ = ["load_jax_variables"]

Route = Optional[Tuple[str, Tuple[str, ...], Optional[Callable]]]


def _conv(a: np.ndarray) -> np.ndarray:
    return np.transpose(a, (3, 2, 0, 1))  # HWIO → OIHW (also depthwise)


_FRONTEND = {
    "_complex_conv._kernel": ("params", ("complex_conv", "kernel"), None),
    "_pooling.weights": ("params", ("pooling", "weights"),
                         lambda a: a.reshape(1, 1, -1, 1)),
    "_pooling._bias": ("params", ("pooling", "bias"), None),
    "_compression.alpha": ("params", ("compression", "alpha"), None),
    "_compression.delta": ("params", ("compression", "delta"), None),
    "_compression.root": ("params", ("compression", "root"), None),
    "_compression.ema._weights": ("params", ("compression", "ema", "weights"),
                                  None),
    # JAX WIO (2, 1, 1) → torch conv1d OIW (1, 1, 2)
    "_preemp.weight": ("params", ("preemp", "kernel"),
                       lambda a: np.transpose(a, (2, 1, 0))),
}


def _bn(prefix: Tuple[str, ...], leaf: str) -> Route:
    return {
        "weight": ("params", prefix + ("scale",), None),
        "bias": ("params", prefix + ("bias",), None),
        "running_mean": ("batch_stats", prefix + ("mean",), None),
        "running_var": ("batch_stats", prefix + ("var",), None),
    }.get(leaf)


def _frontend_route(k: str) -> Route:
    return _FRONTEND.get(k)


def _block_route(k: str) -> Route:
    m = re.match(r"^_(expand_conv|depthwise_conv|project_conv|se_reduce|"
                 r"se_expand)\.(weight|bias)$", k)
    if m:
        mod, leaf = m.groups()
        if leaf == "weight":
            return "params", (mod, "kernel"), _conv
        return "params", (mod, "bias"), None
    m = re.match(r"^_(bn[012])\.(\w+)$", k)
    return _bn((m.group(1),), m.group(2)) if m else None


def _backbone_route(k: str) -> Route:
    flat = {
        "_conv_stem.weight": ("params", ("conv_stem", "kernel"), _conv),
        "_conv_head.weight": ("params", ("conv_head", "kernel"), _conv),
        "_fc.weight": ("params", ("fc", "kernel"), lambda a: a.T),
        "_fc.bias": ("params", ("fc", "bias"), None),
    }
    if k in flat:
        return flat[k]
    m = re.match(r"^_(bn[01])\.(\w+)$", k)
    if m:
        return _bn((m.group(1),), m.group(2))
    m = re.match(r"^_blocks\.(\d+)\.(.+)$", k)
    if not m:
        return None
    sub = _block_route(m.group(2))
    if sub is None:
        return None
    tree, path, tf = sub
    return tree, (f"block_{m.group(1)}",) + path, tf


def _classifier_route(k: str) -> Route:
    root, _, rest = k.partition(".")
    sub = {"features": _frontend_route, "model": _backbone_route}.get(root)
    spec = sub(rest) if sub is not None else None
    if spec is None:
        return None
    tree, path, tf = spec
    return tree, (root,) + path, tf


_ROUTERS = ((Classifier, _classifier_route), (Leaf, _frontend_route),
            (EfficientNet, _backbone_route), (MBConvBlock, _block_route))


def _leaves(tree: Mapping, pre: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, pre + (k,))
        else:
            yield pre + (k,), v


def load_jax_variables(module: nn.Module, variables: Mapping) -> nn.Module:
    """Copy JAX ``variables`` into ``module`` in place; returns ``module``."""
    route = next((r for cls, r in _ROUTERS if isinstance(module, cls)), None)
    if route is None:
        raise TypeError(f"no JAX layout map for {type(module).__name__}")
    flat = {(tree,) + path: v for tree, sub in variables.items()
            for path, v in _leaves(sub)}
    updates, used = {}, set()
    state = module.state_dict()
    for key, tensor in state.items():
        if key.endswith("num_batches_tracked"):
            continue
        spec = route(key)
        if spec is None:
            raise KeyError(f"port tensor '{key}' has no JAX counterpart")
        tree, path, transform = spec
        src = (tree,) + path
        if src not in flat:
            raise KeyError(f"JAX variables lack {'/'.join(src)} "
                           f"(for port tensor '{key}')")
        arr = np.asarray(flat[src], dtype=np.float32)
        if transform is not None:
            arr = transform(arr)
        if tuple(arr.shape) != tuple(tensor.shape):
            raise ValueError(
                f"shape mismatch loading {'/'.join(src)} → '{key}': JAX "
                f"{tuple(arr.shape)} vs port {tuple(tensor.shape)}")
        updates[key] = arr
        used.add(src)
    unknown = sorted("/".join(p) for p in flat if p not in used)
    if unknown:
        raise KeyError(f"{len(unknown)} JAX leaves have no port tensor "
                       f"(first: {unknown[:8]})")
    with torch.no_grad():
        for key, arr in updates.items():
            state[key].copy_(torch.from_numpy(np.array(arr)))
    return module
