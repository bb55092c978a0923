"""Mel filterbank construction (HTK convention, no normalization).

The reference obtains its mel filterbank from
``torchaudio.functional.melscale_fbanks`` (reference: leaf_pytorch/filters.py:47-53)
with torchaudio defaults ``mel_scale="htk"``, ``norm=None``. The same math
runs here in numpy, once at model-construction time.

All results are float32 to match the reference's single-precision
filterbank, because the downstream Gabor-parameter extraction
(:mod:`leaf_tpu_torch.frontend.filters`) involves discrete argmax /
threshold comparisons that must see identical values.
"""

from __future__ import annotations

import numpy as np

__all__ = ["hz_to_mel", "mel_to_hz", "melscale_fbanks"]


def hz_to_mel(freq):
    """HTK mel scale: m = 2595 * log10(1 + f / 700)."""
    return 2595.0 * np.log10(1.0 + np.asarray(freq, dtype=np.float64) / 700.0)


def mel_to_hz(mel):
    """Inverse HTK mel scale: f = 700 * (10^(m / 2595) - 1)."""
    return 700.0 * (10.0 ** (np.asarray(mel, dtype=np.float64) / 2595.0) - 1.0)


def melscale_fbanks(
    n_freqs: int,
    f_min: float,
    f_max: float,
    n_mels: int,
    sample_rate: int,
) -> np.ndarray:
    """Triangular mel filterbank of shape ``(n_freqs, n_mels)``.

    FFT bin centres are ``linspace(0, sample_rate // 2, n_freqs)``; mel
    points are uniformly spaced between ``hz_to_mel(f_min)`` and
    ``hz_to_mel(f_max)`` with ``n_mels + 2`` knots; each filter is the
    positive part of the min of the rising and falling slopes.
    """
    all_freqs = np.linspace(0.0, sample_rate // 2, n_freqs, dtype=np.float64)
    m_pts = np.linspace(hz_to_mel(f_min), hz_to_mel(f_max), n_mels + 2)
    f_pts = mel_to_hz(m_pts)

    f_diff = f_pts[1:] - f_pts[:-1]  # (n_mels + 1,)
    slopes = f_pts[None, :] - all_freqs[:, None]  # (n_freqs, n_mels + 2)
    down_slopes = -slopes[:, :-2] / f_diff[:-1]  # rising edge
    up_slopes = slopes[:, 2:] / f_diff[1:]  # falling edge
    fb = np.maximum(0.0, np.minimum(down_slopes, up_slopes))
    return fb.astype(np.float32)
