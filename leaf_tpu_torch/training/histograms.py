"""On-device parameter and gradient histograms (``wandb.watch(log="all")``).

The port of ``leaf_tpu.training.histograms``: fixed-bin bucket counts and
moments are computed where the tensors lie, and only ``bins`` counts and
four scalars per tensor cross to the host (in ``TrainLogger
.log_histograms``). The train step stashes its gradients in
``metrics["_grads"]`` when ``watch_histograms`` is on; the train CLI
histograms them and the parameters at log steps only.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

__all__ = ["tensor_histogram", "histogram_tree", "DEFAULT_BINS"]

DEFAULT_BINS = 64


def tensor_histogram(x: torch.Tensor, bins: int = DEFAULT_BINS
                     ) -> Tuple[torch.Tensor, ...]:
    """``(counts[bins], lo, hi, sum, sum_sq)`` of one tensor, on its device.

    Bucket i covers [lo + i·w, lo + (i+1)·w) for w = (hi − lo)/bins, the
    top edge inclusive (``np.histogram``'s rule); a constant tensor lands
    in bucket 0 with hi == lo. The index is the JAX function's:
    trunc((x − lo) / max(hi − lo, tiny) · bins), clamped to [0, bins − 1].
    """
    x = x.detach().to(torch.float32).reshape(-1)
    lo, hi = x.min(), x.max()
    span = torch.clamp(hi - lo, min=torch.finfo(torch.float32).tiny)
    idx = ((x - lo) / span * bins).to(torch.int64).clamp_(0, bins - 1)
    counts = torch.bincount(idx, minlength=bins).to(torch.int32)
    return counts, lo, hi, x.sum(), torch.sum(x * x)


def histogram_tree(tensors: Mapping[str, torch.Tensor],
                   bins: int = DEFAULT_BINS,
                   prefix: str = "") -> Dict[str, Tuple[torch.Tensor, ...]]:
    """Histogram each named tensor (``named_parameters()`` names, or the
    ``_grads`` a watching step stashes). Returns ``{prefix + name with
    "/" for ".": (counts, lo, hi, sum, sum_sq)}``, still on the device."""
    return {prefix + name.replace(".", "/"): tensor_histogram(t, bins)
            for name, t in tensors.items()}
