"""On-device waveform augmentation, inside the train step.

The elementwise augments of ``leaf_supervised_transforms(train=True)``
(random gain, Gaussian noise, peak normalisation) run on the batch where
it already lies, as the JAX package's ``leaf_tpu.data.device_augment``
runs them inside its jitted step. The distributions are the same:

- gain: with p = 0.25 per clip, gain_db ~ U[−18, 6] (the reference wraps
  a Gain of p = 0.5 in UseWithProb(0.5));
- noise: with p = 0.5 per clip, x + a·N(0, 1), a ~ U[0.001, 0.015];
- peak normalisation: divide by |x|max only where it exceeds 1.

The numbers come from a ``torch.Generator`` on the batch's device, so
they differ from ``jax.random``'s; the tests hold the distributions.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["leaf_device_augment", "peak_normalize"]


def peak_normalize(x: torch.Tensor) -> torch.Tensor:
    """(B, T): divide by the per-clip abs peak only when it exceeds 1."""
    peak = x.abs().amax(dim=-1, keepdim=True)
    return torch.where(peak > 1.0, x / peak, x)


def leaf_device_augment(generator: Optional[torch.Generator],
                        x: torch.Tensor) -> torch.Tensor:
    """Train-time augments of leaf_supervised_transforms on a (B, T) batch.

    ``generator`` lives on x's device (None: the device's default one).
    Returns a new tensor of x's shape and dtype.
    """
    b = x.shape[0]

    def uniform(lo: float, hi: float, shape=(b, 1)) -> torch.Tensor:
        u = torch.rand(shape, generator=generator, device=x.device)
        return (lo + (hi - lo) * u).to(x.dtype)

    apply_gain = uniform(0.0, 1.0) < 0.25
    gain = torch.pow(10.0, uniform(-18.0, 6.0) / 20.0)
    x = torch.where(apply_gain, x * gain, x)

    apply_noise = uniform(0.0, 1.0) < 0.5
    amp = uniform(0.001, 0.015)
    noise = torch.randn(x.shape, generator=generator, device=x.device,
                        dtype=x.dtype)
    x = torch.where(apply_noise, x + amp * noise, x)
    return peak_normalize(x)
