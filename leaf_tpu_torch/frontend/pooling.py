"""Learnable Gaussian lowpass (the LEAF "pooling" stage).

Depthwise strided correlation whose per-channel Gaussian window is
regenerated from a learnable width every forward pass. Parity: reference
leaf_pytorch/pooling.py:8-42 (weight init 0.4, bias init 1.0, TF-SAME
padding, groups=C, stride = hop length); parameter names and shapes are
the reference's (``weights`` (1, 1, C, 1), ``_bias`` (C,)).
"""

from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from leaf_tpu_torch.frontend.impulse_responses import gaussian_lowpass
from leaf_tpu_torch.frontend.utils import tf_same_padding_1d

__all__ = ["GaussianLowPass", "depthwise_strided_conv"]


def depthwise_strided_conv(x: torch.Tensor, windows: torch.Tensor,
                           stride: int, pad: Tuple[int, int]) -> torch.Tensor:
    """Per-channel 1-D correlation: (B, T, C) ⊛ (C, K) → (B, F, C).

    out[b,f,c] = Σ_k x_pad[b, f·H + k, c] · w[c, k], H = stride, with
    F = (T + pl + pr − K)//H + 1. Channels-last, as the JAX function.
    The windows are rounded to x's dtype and the sums are f32, as are
    the outputs: under bf16 operands that is the JAX function's
    ``preferred_element_type=float32`` (each product is exact in f32).
    """
    out = F.conv1d(F.pad(x.transpose(1, 2), pad).float(),
                   windows.to(x.dtype).float()[:, None, :], stride=stride,
                   groups=windows.shape[0])
    return out.transpose(1, 2)


class GaussianLowPass(nn.Module):
    """Strided Gaussian lowpass with bias — the configuration LEAF uses
    (reference ``GaussianLowPass``, pooling.py:8-42). ``padding`` is
    ``"same"`` (TF-SAME, the default) or a (left, right) pair."""

    def __init__(self, in_channels: int, kernel_size: int, strides: int = 1,
                 padding: Union[str, Tuple[int, int]] = "same",
                 device=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel_size = kernel_size
        self.strides = strides
        self.padding = (tf_same_padding_1d(kernel_size)
                        if padding == "same" else tuple(padding))
        self.weights = nn.Parameter(torch.full(
            (1, 1, in_channels, 1), 0.4, device=device, dtype=dtype))
        self._bias = nn.Parameter(torch.ones(in_channels, device=device,
                                             dtype=dtype))

    def emit_windows(self):
        """(windows (C, K), bias (C,)) — what the fused op consumes."""
        return gaussian_lowpass(self.weights.reshape(-1),
                                self.kernel_size), self._bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, C) → (B, T', C), T' = ceil(T / strides) under SAME."""
        windows, bias = self.emit_windows()
        return depthwise_strided_conv(x, windows, self.strides,
                                      self.padding) + bias
