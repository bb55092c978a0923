"""Gabor and Gaussian-lowpass impulse responses, in float32 torch.

The Gabor filters are built directly from cos/sin (no complex dtype), as
the JAX package's ``gabor_filters_real_imag`` does; the reference's
"legacy complex" path computes the same numbers. The complex filters
(``gabor_impulse_response``, ``gabor_filters``, complex64) are the JAX
package's public API; the frontend does not use them. Filters are
regenerated from the learnable parameters on every forward pass, like the
reference's constraint-in-forward design (reference:
leaf_pytorch/convolution.py:73-76).
"""

from __future__ import annotations

import math

import torch

__all__ = ["gabor_impulse_response", "gabor_filters",
           "gabor_filters_real_imag", "gaussian_lowpass"]


def gabor_impulse_response(t: torch.Tensor, center: torch.Tensor,
                           fwhm: torch.Tensor) -> torch.Tensor:
    """Complex Gabor impulse responses, complex64 of shape (F, K).

    ``h_c(t) = 1/(sqrt(2π)·σ_c) · exp(i·μ_c·t) · exp(-t² / (2σ_c²))`` for
    the (K,) time support ``t``, the (F,) center frequencies ``center``
    (radians per sample) and the (F,) widths ``fwhm`` (samples). Parity:
    reference leaf_pytorch/impulse_responses.py:5-16.
    """
    denominator = 1.0 / (math.sqrt(2.0 * math.pi) * fwhm)  # (F,)
    gaussian = torch.exp(torch.outer(1.0 / (2.0 * fwhm ** 2), -(t ** 2)))
    sinusoid = torch.exp(1j * torch.outer(center, t).to(torch.complex64))
    return (denominator[:, None].to(torch.complex64) * sinusoid
            * gaussian.to(torch.complex64))


def gabor_filters(kernel: torch.Tensor, size: int = 401) -> torch.Tensor:
    """(F, 2) (μ, σ) parameters → (F, size) complex64 Gabor filters on the
    time support ``arange(-(size//2), (size+1)//2)`` (reference:
    leaf_pytorch/impulse_responses.py:66-71); ``gabor_filters_real_imag``
    gives their real and imaginary parts in float32."""
    t = torch.arange(-(size // 2), (size + 1) // 2, dtype=kernel.dtype,
                     device=kernel.device)
    return gabor_impulse_response(t, center=kernel[:, 0], fwhm=kernel[:, 1])


def gabor_filters_real_imag(kernel: torch.Tensor, size: int = 401
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(F, 2) (μ, σ) parameters → real and imaginary (F, size) filters.

    ``h_c(t) = 1/(sqrt(2π)·σ_c) · exp(i·μ_c·t) · exp(-t² / (2σ_c²))`` on the
    time support ``arange(-(size//2), (size+1)//2)`` (reference:
    leaf_pytorch/impulse_responses.py:5-16, 66-71).
    """
    t = torch.arange(-(size // 2), (size + 1) // 2, dtype=kernel.dtype,
                     device=kernel.device)
    center, fwhm = kernel[:, 0], kernel[:, 1]
    # torch.full, not torch.tensor: no host-to-device copy (a CUDA graph
    # of train steps captures this)
    norm = torch.sqrt(torch.full((), 2.0 * math.pi, dtype=kernel.dtype,
                                 device=kernel.device))
    envelope = (1.0 / (norm * fwhm))[:, None] * torch.exp(
        torch.outer(1.0 / (2.0 * fwhm ** 2), -(t ** 2)))  # (F, K)
    phase = torch.outer(center, t)  # (F, K)
    return envelope * torch.cos(phase), envelope * torch.sin(phase)


def gaussian_lowpass(sigma: torch.Tensor, filter_size: int) -> torch.Tensor:
    """(C,) widths → (C, K) windows ``exp(-0.5·((t − (K−1)/2) / (σ·(K−1)/2))²)``.

    σ is clamped to ``[2/filter_size, 0.5]``. Parity: reference
    leaf_pytorch/impulse_responses.py:74-80, in the natural (C, K) layout.
    """
    sigma = torch.clamp(sigma, 2.0 / filter_size, 0.5)
    t = torch.arange(filter_size, dtype=sigma.dtype, device=sigma.device)
    numerator = t[None, :] - 0.5 * (filter_size - 1)
    denominator = sigma[:, None] * 0.5 * (filter_size - 1)
    return torch.exp(-0.5 * (numerator / denominator) ** 2)
