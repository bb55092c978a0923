"""Initializers for the learnable Gabor filterbank parameters.

Each initializer is a callable ``(shape, generator, dtype) -> Tensor`` that
returns a CPU tensor; the module copies it to its own device. The random
schemes draw from the given ``torch.Generator`` (the global RNG when it is
None). Schemes mirror the reference's init sweep (reference:
leaf_pytorch/convolution.py:44-54):

- ``"default"`` — mel-initialized Gabor parameters (the LEAF init)
- ``"random"``  — standard normal
- ``"xavier_normal"`` — Glorot normal on the (F, 2) parameter matrix
- ``"kaiming_normal"`` — He normal, torch's fan_in of a (F, 2) matrix
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from leaf_tpu_torch.frontend.filters import GaborParams

__all__ = ["GaborInit", "make_initializer"]

Initializer = Callable[[tuple, Optional[torch.Generator], torch.dtype],
                       torch.Tensor]


class GaborInit:
    """Mel-scale Gabor parameter initializer (draws no random numbers).

    ``shape`` must be (n_filters, 2). Parity: reference
    leaf_pytorch/initializers.py:7-24 (2-D branch only, as there).
    """

    def __init__(self, default_window_len: int = 401, **kwargs):
        self.def_win_len = default_window_len
        self._kwargs = kwargs

    def __call__(self, shape, generator=None, dtype=torch.float32):
        if len(shape) != 2:
            raise NotImplementedError("GaborInit only supports (n_filters, 2) shapes")
        params = GaborParams(
            n_filters=shape[0], window_len=self.def_win_len, **self._kwargs
        ).gabor_params_from_mels()
        return torch.as_tensor(params, dtype=dtype)


def _normal(std: float) -> Initializer:
    def init(shape, generator=None, dtype=torch.float32):
        return std * torch.randn(shape, generator=generator, dtype=dtype)
    return init


def _xavier_normal(shape, generator=None, dtype=torch.float32):
    # torch.nn.init.xavier_normal_ on a 2-D (fan_out, fan_in) matrix:
    # std = sqrt(2 / (fan_in + fan_out))  (reference: convolution.py:48-50)
    return _normal(math.sqrt(2.0 / (shape[0] + shape[1])))(
        shape, generator, dtype)


def _kaiming_normal(shape, generator=None, dtype=torch.float32):
    # torch.nn.init.kaiming_normal_ defaults: gain sqrt(2), mode fan_in,
    # where a 2-D torch tensor's fan_in is shape[1] (= 2 here).
    return _normal(math.sqrt(2.0) / math.sqrt(shape[1]))(
        shape, generator, dtype)


def make_initializer(
    initializer,
    window_len: int,
    sample_rate: int,
    min_freq: float,
    max_freq: float,
) -> Initializer:
    """Resolve a config string (or callable) to an initializer callable.

    Parity: reference leaf_pytorch/convolution.py:44-54.
    """
    if callable(initializer):
        return initializer
    if initializer == "default":
        return GaborInit(
            default_window_len=window_len,
            sample_rate=sample_rate,
            min_freq=min_freq,
            max_freq=max_freq,
        )
    if initializer == "random":
        return _normal(1.0)
    if initializer == "xavier_normal":
        return _xavier_normal
    if initializer == "kaiming_normal":
        return _kaiming_normal
    raise ValueError(f"unsupported initializer {initializer!r}")
