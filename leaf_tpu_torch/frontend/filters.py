"""Mel-initialized Gabor filter parameters.

Host-side (numpy) computation of the initial (μ, σ) Gabor parameters from a
mel filterbank. Runs once at model construction.

Parity: reference leaf_pytorch/filters.py:10-65 (``GaborFilter``), minus the
reference's dead energy-scaled ``gabor_filters`` method and its stray debug
print.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from leaf_tpu_torch.frontend.melbanks import melscale_fbanks

__all__ = ["GaborParams"]


@dataclasses.dataclass
class GaborParams:
    """Extracts Gabor (center, bandwidth) parameters from a mel filterbank.

    The center frequency of each Gabor filter is the peak FFT bin of the
    corresponding (sqrt-)mel filter, in radians/sample; the bandwidth σ is
    derived from the filter's full width at half maximum:
    ``σ = sqrt(2·ln2)·n_fft / (π·FWHM_bins)``.
    """

    n_filters: int = 40
    min_freq: float = 0.0
    max_freq: float = 8000.0
    sample_rate: int = 16000
    window_len: int = 401
    n_fft: int = 512
    normalize_energy: bool = False

    def mel_filters(self) -> np.ndarray:
        """(n_filters, n_fft//2 + 1) mel filterbank."""
        fb = melscale_fbanks(
            n_freqs=self.n_fft // 2 + 1,
            f_min=self.min_freq,
            f_max=self.max_freq,
            n_mels=self.n_filters,
            sample_rate=self.sample_rate,
        ).T
        if self.normalize_energy:
            fb = fb / self._mel_filters_areas(fb)
        return fb

    def _mel_filters_areas(self, filters: np.ndarray) -> np.ndarray:
        peaks = filters.max(axis=1, keepdims=True)
        widths = (filters > 0).sum(axis=1, keepdims=True).astype(np.float32)
        return peaks * (widths + 2) * np.pi / self.n_fft

    def gabor_params_from_mels(self) -> np.ndarray:
        """(n_filters, 2) array of (μ [rad/sample], σ [samples]) parameters.

        Parity: reference leaf_pytorch/filters.py:28-40 — argmax peak bin and
        half-magnitude width measured on the *sqrt* filterbank, in float32.
        """
        coeff = np.sqrt(2.0 * np.log(np.float32(2.0))).astype(np.float32) * self.n_fft
        sqrt_filters = np.sqrt(self.mel_filters())
        center_frequencies = np.argmax(sqrt_filters, axis=1)
        peaks = sqrt_filters.max(axis=1, keepdims=True)
        half_magnitudes = peaks / 2.0
        fwhms = (sqrt_filters >= half_magnitudes).sum(axis=1).astype(np.float32)
        return np.stack(
            [
                center_frequencies.astype(np.float32) * 2.0 * np.pi / self.n_fft,
                coeff / (np.pi * fwhms),
            ],
            axis=1,
        )
