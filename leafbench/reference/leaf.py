"""The LEAF frontend in plain PyTorch, float32: a 401-tap complex Gabor
convolution (2F real channels, [real | imag]), the squared modulus, a
per-channel Gaussian lowpass at stride 160 with its bias, a clamp at
1e-5 and sPCEN (Zeghidour et al., ICLR 2021; the reference leaf-pytorch
code). Filters and windows are regenerated from the parameters on every
forward. The PCEN smoother is the exact EMA s_t = w·x_t + (1−w)·s_{t−1}
(s_0 = x_0) in its closed form, one triangular contraction per channel.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

TAPS, STRIDE = 401, 160
PAD = (TAPS // 2, TAPS // 2)   # TF-SAME for an odd kernel


def _mel_filters(n_filters: int, min_freq: float, max_freq: float,
                 sample_rate: int, n_fft: int = 512) -> np.ndarray:
    """(n_filters, n_fft//2 + 1) HTK mel filterbank, float32 (torchaudio's
    ``melscale_fbanks`` with norm None, transposed)."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)

    all_freqs = np.linspace(0.0, sample_rate // 2, n_fft // 2 + 1)
    f_pts = mel_to_hz(np.linspace(hz_to_mel(min_freq), hz_to_mel(max_freq),
                                  n_filters + 2))
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32).T


def gabor_init(n_filters: int, min_freq: float, max_freq: float,
               sample_rate: int, n_fft: int = 512) -> np.ndarray:
    """(n_filters, 2) initial (μ [rad/sample], σ [samples]) from the mel
    filterbank: the peak bin and the half-magnitude width of each
    sqrt-mel filter (LEAF's default initialisation)."""
    coeff = np.sqrt(2.0 * np.log(np.float32(2.0))).astype(np.float32) * n_fft
    sq = np.sqrt(_mel_filters(n_filters, min_freq, max_freq, sample_rate,
                              n_fft))
    centers = np.argmax(sq, axis=1)
    fwhms = (sq >= sq.max(axis=1, keepdims=True) / 2.0).sum(axis=1)
    return np.stack([centers.astype(np.float32) * 2.0 * np.pi / n_fft,
                     coeff / (np.pi * fwhms.astype(np.float32))], axis=1)


def gabor_bank(kernel: torch.Tensor) -> torch.Tensor:
    """(F, 2) (μ, σ) → (2F, TAPS) [real | imag] Gabor filters, after the
    constraint μ ∈ [0, π], σ ∈ [4√(2ln2)/π, TAPS·√(2ln2)/π]."""
    s2l2 = math.sqrt(2.0 * math.log(2.0))
    mu = kernel[:, 0].clamp(0.0, math.pi)
    sigma = kernel[:, 1].clamp(4.0 * s2l2 / math.pi, TAPS * s2l2 / math.pi)
    t = torch.arange(-(TAPS // 2), (TAPS + 1) // 2, dtype=kernel.dtype,
                     device=kernel.device)
    envelope = (1.0 / (math.sqrt(2.0 * math.pi) * sigma))[:, None] \
        * torch.exp(-(t[None, :] ** 2) / (2.0 * sigma[:, None] ** 2))
    phase = mu[:, None] * t[None, :]
    return torch.cat([envelope * torch.cos(phase),
                      envelope * torch.sin(phase)], dim=0)


def gaussian_windows(sigma: torch.Tensor) -> torch.Tensor:
    """(C,) widths → (C, TAPS) windows exp(−½((t − (K−1)/2)/(σ(K−1)/2))²),
    σ clamped to [2/K, 0.5]."""
    sigma = sigma.clamp(2.0 / TAPS, 0.5)
    t = torch.arange(TAPS, dtype=sigma.dtype, device=sigma.device)
    half = 0.5 * (TAPS - 1)
    return torch.exp(-0.5 * ((t[None, :] - half)
                             / (sigma[:, None] * half)) ** 2)


def ema(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact EMA over axis 1 of (B, T, C) with per-channel coefficient w:
    s_t = Σ_{u=1..t} w(1−w)^{t−u} x_u + (1−w)^t x_0."""
    t = x.shape[1]
    w = w.clamp(0.0, 1.0)
    i = torch.arange(t, dtype=x.dtype, device=x.device)
    lag = i[:, None] - i[None, :]
    lower = lag >= 0
    decay = torch.exp(torch.where(lower, lag, 0.0)[None]
                      * torch.log((1.0 - w).clamp_min(1e-30))[:, None, None])
    mat = torch.where(lower[None], decay * w[:, None, None], 0.0)
    mat = torch.cat([decay[:, :, :1], mat[:, :, 1:]], dim=2)
    return torch.einsum("ctu,buc->btc", mat, x)


class _Params(nn.Module):
    """A holder of named parameters (the reference leaf-pytorch names)."""


class Leaf(nn.Module):
    """LEAF: waveform (B, T) → features (B, frames, F)."""

    def __init__(self, n_filters: int = 40, sample_rate: int = 16000,
                 min_freq: float = 60.0, max_freq: float = 7800.0,
                 device=None):
        super().__init__()
        self.n_filters = n_filters
        self.init_args = (n_filters, min_freq, max_freq, sample_rate)
        f = n_filters
        self._complex_conv = _Params()
        self._complex_conv._kernel = nn.Parameter(
            torch.empty(f, 2, device=device))
        self._pooling = _Params()
        self._pooling.weights = nn.Parameter(
            torch.empty(1, 1, f, 1, device=device))
        self._pooling._bias = nn.Parameter(torch.empty(f, device=device))
        self._compression = _Params()
        for name in ("alpha", "delta", "root"):
            setattr(self._compression, name,
                    nn.Parameter(torch.empty(f, device=device)))
        self._compression.ema = _Params()
        self._compression.ema._weights = nn.Parameter(
            torch.empty(f, device=device))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self) -> None:
        """LEAF's initialisation: mel Gabor parameters, lowpass width 0.4
        and bias 1, PCEN α 0.96, δ 2, r 2, smoother 0.04."""
        kernel = self._complex_conv._kernel
        if kernel.device.type == "meta":
            return
        kernel.copy_(torch.from_numpy(gabor_init(*self.init_args)))
        self._pooling.weights.fill_(0.4)
        self._pooling._bias.fill_(1.0)
        self._compression.alpha.fill_(0.96)
        self._compression.delta.fill_(2.0)
        self._compression.root.fill_(2.0)
        self._compression.ema._weights.fill_(0.04)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = self.n_filters
        bank = gabor_bank(self._complex_conv._kernel)          # (2F, K)
        y = F.conv1d(F.pad(x[:, None, :], PAD), bank[:, None, :])
        power = y[:, :f] ** 2 + y[:, f:] ** 2                    # (B, F, T)
        windows = gaussian_windows(self._pooling.weights.reshape(-1))
        low = F.conv1d(F.pad(power, PAD), windows[:, None, :],
                       stride=STRIDE, groups=f)                  # (B, F, T')
        out = low.transpose(1, 2) + self._pooling._bias
        out = out.clamp_min(1e-5)
        c = self._compression
        alpha = c.alpha.clamp(max=1.0)
        root = c.root.clamp(min=1.0)
        smooth = ema(out, c.ema._weights)
        return ((out / (1e-12 + smooth) ** alpha + c.delta) ** (1.0 / root)
                - c.delta ** (1.0 / root))
