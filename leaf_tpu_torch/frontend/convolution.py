"""Learnable complex Gabor filterbank as a real 1-D convolution.

The module holds only the (F, 2) (μ, σ) parameters (reference name
``_kernel``); the (2F, K) real filter bank is regenerated every forward
pass after clamping by :func:`gabor_constraint`, so the constraint takes
part in autograd like the reference's constraint-in-forward (reference:
leaf_pytorch/convolution.py:73-76). Layout is PyTorch's channels-first:
(B, 1, T) → (B, 2F, T'), the first F channels the real parts and the last
F the imaginary parts ([real | imag], the JAX package's order; the
reference interleaves them, which the squared modulus pairs back up).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from leaf_tpu_torch.frontend import initializers
from leaf_tpu_torch.frontend.impulse_responses import gabor_filters_real_imag
from leaf_tpu_torch.frontend.utils import tf_same_padding_1d

__all__ = ["GaborConstraint", "GaborConv1d", "gabor_constraint"]


def gabor_constraint(kernel_data: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Clamp (F, 2) Gabor params: μ ∈ [0, π], σ ∈ [4√(2ln2)/π, K·√(2ln2)/π].

    Parity: reference leaf_pytorch/convolution.py:10-22.
    """
    # bounds in the parameters' dtype, rounded as the JAX function rounds
    # them (a device fill: no host-to-device copy inside a CUDA graph)
    sqrt_2log2 = torch.sqrt(2.0 * torch.log(torch.full(
        (), 2.0, dtype=kernel_data.dtype, device=kernel_data.device)))
    mu = torch.clamp(kernel_data[:, 0], 0.0, math.pi)
    sigma = torch.clamp(
        kernel_data[:, 1],
        4.0 * sqrt_2log2 / math.pi,
        kernel_size * sqrt_2log2 / math.pi,
    )
    return torch.stack([mu, sigma], dim=1)


class GaborConstraint(nn.Module):
    """Module wrapper around :func:`gabor_constraint` (API parity with the
    JAX package's ``GaborConstraint``)."""

    def __init__(self, kernel_size: int):
        super().__init__()
        self.kernel_size = kernel_size

    def forward(self, kernel_data: torch.Tensor) -> torch.Tensor:
        return gabor_constraint(kernel_data, self.kernel_size)


class GaborConv1d(nn.Module):
    """Complex Gabor filterbank applied as a real stride-1 conv1d, without
    bias — the configuration LEAF uses (reference ``GaborConv1d``,
    convolution.py:25-99). ``padding`` is ``"same"`` (TF-SAME, the
    default) or a (left, right) pair; the streaming cell uses (0, 0)."""

    def __init__(self, filters: int, kernel_size: int,
                 padding: Union[str, Tuple[int, int]] = "same",
                 initializer: Union[str, Callable] = "default",
                 sample_rate: int = 16000, min_freq: float = 60.0,
                 max_freq: float = 7800.0, device=None,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel_size = kernel_size
        self.padding = (tf_same_padding_1d(kernel_size)
                        if padding == "same" else tuple(padding))
        init_fn = initializers.make_initializer(
            initializer, window_len=kernel_size, sample_rate=sample_rate,
            min_freq=min_freq, max_freq=max_freq)
        self._kernel = nn.Parameter(
            init_fn((filters // 2, 2), generator, dtype).to(device))

    def emit_filters(self) -> torch.Tensor:
        """The (K, 2F) [real | imag] bank the fused op consumes."""
        constrained = gabor_constraint(self._kernel, self.kernel_size)
        real_f, imag_f = gabor_filters_real_imag(constrained, self.kernel_size)
        return torch.cat([real_f, imag_f], dim=0).T

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 1, T) → (B, 2F, T')."""
        bank = self.emit_filters().T[:, None, :]  # (2F, 1, K)
        return F.conv1d(F.pad(x, self.padding), bank.to(x.dtype))
