"""The LEAF frontend module: Gabor conv → squared modulus → Gaussian lowpass
→ clamp → sPCEN.

Public layout is the JAX package's: waveform ``(B, T)``, ``(B, T, 1)`` or
the reference's ``(B, 1, T)`` in; features ``(B, frames, n_filters)`` out.
Inside, the convolution runs channels-first as PyTorch convolutions do.

Defaults are the LEAF paper's and the reference's (frontend.py:25-76): 40
filters, 16 kHz, 25 ms window (401 taps), 10 ms hop (stride 160), mel init
in [60, 7800] Hz, sPCEN with α=0.96, smooth=0.04, δ=2.0, r=2.0,
floor=1e-12; post-pool clamp at 1e-5. ``preemp`` (a learnable 2-tap filter
initialised to [-0.97, 1]) and ``mean_var_norm`` (per-(clip, channel)
normalisation over time) are implemented as in the JAX package.

Parameter names follow the reference leaf-pytorch ``state_dict``
(``_complex_conv._kernel``, ``_pooling.weights``/``_bias``,
``_compression.{alpha,delta,root,ema._weights}``), so
``leaf_tpu.models.torch_import`` reads a port ``state_dict`` unchanged.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from leaf_tpu_torch.frontend import convolution, pooling, postprocessing
from leaf_tpu_torch.frontend.utils import tf_same_padding_1d

__all__ = ["SquaredModulus", "Preemphasis", "Leaf"]

_FUSED_MODES = ("auto", "on", "off")


class SquaredModulus(nn.Module):
    """|real + i·imag|² over [real-bank | imag-bank] channel halves.

    (B, 2F, T) → (B, F, T). Equivalent to the reference's
    ``2·AvgPool1d(k=2, s=2)`` over interleaved channels
    (reference: frontend.py:10-19).
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = x.shape[1] // 2
        real, imag = x[:, :f], x[:, f:]
        return real * real + imag * imag


class Preemphasis(nn.Module):
    """Learnable pre-emphasis: 2-tap conv initialised to [-0.97, 1].

    (B, 1, T) → (B, 1, T): out[t] = w0·x[t] + w1·x[t+1], zero past the end.
    """

    def __init__(self, device=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.tensor(
            [[[-0.97, 1.0]]], device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv1d(F.pad(x, (0, 1)), self.weight.to(x.dtype))


class Leaf(nn.Module):
    """The LEAF learnable frontend.

    ``use_fused_kernel``: ``'off'`` runs plain torch ops; ``'on'`` runs
    the fused op (kernel on CUDA, its plain version on CPU) and raises if
    the geometry does not fit it; ``'auto'`` takes the kernel for CUDA
    inputs when preemp is off and the window is 401 taps at stride 160.
    The parameters are the same either way.

    ``compute_dtype`` (``torch.float32`` or ``torch.bfloat16``) is the
    JAX package's: the waveform is cast to it after preemp, the Gabor
    conv and the squared modulus run in it (the fused op: x and the bank
    in it, the windows f32), the lowpass sums in f32 from its operands,
    and the clamp and PCEN stay f32. The parameters stay f32 and are
    cast where they are used.
    """

    def __init__(self, n_filters: int = 40, sample_rate: int = 16000,
                 window_len: float = 25.0, window_stride: float = 10.0,
                 preemp: bool = False, init_min_freq: float = 60.0,
                 init_max_freq: float = 7800.0, mean_var_norm: bool = False,
                 pcen_compression: bool = True,
                 use_legacy_complex: bool = False,
                 initializer: Union[str, Callable] = "default",
                 use_fused_kernel: str = "auto",
                 compute_dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if use_fused_kernel not in _FUSED_MODES:
            raise ValueError(f"use_fused_kernel must be one of {_FUSED_MODES},"
                             f" got {use_fused_kernel!r}")
        if compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be torch.float32 or "
                             f"torch.bfloat16, got {compute_dtype!r}")
        self.n_filters = n_filters
        # int(sr * window_len // 1000 + 1) and int(sr * window_stride // 1000),
        # reference frontend.py:38-39
        self.window_size = int(sample_rate * window_len // 1000 + 1)
        self.stride = int(sample_rate * window_stride // 1000)
        self.preemp = preemp
        self.mean_var_norm = mean_var_norm
        self.use_legacy_complex = use_legacy_complex  # config-parity no-op
        self.use_fused_kernel = use_fused_kernel
        self.compute_dtype = compute_dtype
        if preemp:
            self._preemp = Preemphasis(device=device)
        self._complex_conv = convolution.GaborConv1d(
            filters=2 * n_filters, kernel_size=self.window_size,
            initializer=initializer, sample_rate=sample_rate,
            min_freq=init_min_freq,
            max_freq=init_max_freq, device=device, generator=generator)
        self._activation = SquaredModulus()
        self._pooling = pooling.GaussianLowPass(
            in_channels=n_filters, kernel_size=self.window_size,
            strides=self.stride, device=device)
        self._compression = (postprocessing.PCENLayer(
            in_channels=n_filters, alpha=0.96, smooth_coef=0.04, delta=2.0,
            root=2.0, floor=1e-12, trainable=True, learn_smooth_coef=True,
            per_channel_smooth_coef=True, device=device)
            if pcen_compression else None)

    def _fused_applicable(self, x: torch.Tensor) -> bool:
        if self.use_fused_kernel == "off":
            return False
        applicable = (not self.preemp and self.window_size == 401
                      and self.stride == 160)
        if self.use_fused_kernel == "on":
            if not applicable:
                raise ValueError(
                    "use_fused_kernel='on' requires preemp=False, "
                    "window_size=401 and stride=160")
            return True
        return applicable and x.is_cuda

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Waveform (B, T) / (B, T, 1) / (B, 1, T) → features (B, T', F)."""
        if x.ndim == 2:
            x = x[:, None, :]
        elif not (x.ndim == 3 and x.shape[1] == 1 and x.shape[2] != 1):
            x = x.transpose(1, 2)  # (B, T, 1) → (B, 1, T)
        x = x.to(torch.float32)
        if self.preemp:
            x = self._preemp(x)
        x = x.to(self.compute_dtype)

        if self._fused_applicable(x):
            # imported here: the op's plain version uses frontend.pooling
            from leaf_tpu_torch.ops.fused_frontend import (
                fused_gabor_sqmod_lowpass)
            bank = self._complex_conv.emit_filters()
            windows, bias = self._pooling.emit_windows()
            out = fused_gabor_sqmod_lowpass(
                x[:, 0, :], bank.to(x.dtype), windows, self.stride,
                tf_same_padding_1d(self.window_size))
            out = out + bias
        else:
            out = self._activation(self._complex_conv(x))  # (B, F, T)
            out = self._pooling(out.transpose(1, 2))        # (B, T', F)
        out = torch.clamp(out, min=1e-5)
        if self._compression is not None:
            out = self._compression(out)
        if self.mean_var_norm:
            mean = torch.mean(out, dim=1, keepdim=True)
            var = torch.var(out, dim=1, keepdim=True, unbiased=False)
            out = (out - mean) * torch.rsqrt(var + 1e-6)
        return out
