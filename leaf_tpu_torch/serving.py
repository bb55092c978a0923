"""Serving: pad-to-bucket inference over a live port ``Classifier``.

The JAX package serves AOT-exported artifacts (``leaf_tpu/serving.py``);
this slice serves the live module with the same dispatch: a request of B
clips is cut into chunks of at most the largest bucket, each chunk is
zero-padded up to the smallest bucket that holds it, and the padded rows
are sliced off the logits. Fixed bucket shapes keep the kernels' launch
shapes few. Exported artifacts (``save_exported``, ``ServingModel.load``,
streaming) need the kernel registered as a ``torch.library`` op and are a
later slice (ROADMAP Queue 1 item 12).

    model = ServingModel(cfg, jax_variables=variables)   # or state_dict=
    logits = model(waveforms)        # (B, clip_samples) → (B, num_classes)
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Optional, Sequence

import numpy as np
import torch

from leaf_tpu_torch import resolve_device
from leaf_tpu_torch.models.classifier import Classifier
from leaf_tpu_torch.models.jax_import import load_jax_variables

__all__ = ["ServingModel", "DEFAULT_BATCH_SIZES"]

# The JAX package's buckets (no b=1 bucket: a single clip is padded to 8).
DEFAULT_BATCH_SIZES = (8, 64)


class ServingModel:
    """Pad-to-bucket dispatch over the live classifier, in eval mode.

    Weights come from exactly one of ``state_dict`` (the port's own) or
    ``jax_variables`` (a JAX ``{"params", "batch_stats"}`` tree). Runs on
    ``device`` — CUDA unless one is named.
    """

    def __init__(self, cfg: dict, *, state_dict: Optional[Mapping] = None,
                 jax_variables: Optional[Mapping] = None, device=None,
                 batch_sizes: Sequence[int] = DEFAULT_BATCH_SIZES,
                 clip_samples: Optional[int] = None):
        if (state_dict is None) == (jax_variables is None):
            raise ValueError("pass exactly one of state_dict= or "
                             "jax_variables=")
        self.device = resolve_device(device)
        model = Classifier(cfg, device=self.device)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        else:
            load_jax_variables(model, jax_variables)
        self.model = model.eval()
        self.batch_sizes = sorted(set(int(b) for b in batch_sizes))
        self.clip_samples = int(clip_samples
                                or cfg["audio_config"]["sample_rate"])

    def _bucket(self, n: int) -> int:
        for b in self.batch_sizes:
            if b >= n:
                return b
        return self.batch_sizes[-1]

    def __call__(self, waveforms) -> np.ndarray:
        """(B, clip_samples) float32 → (B, num_classes) float32 logits
        (a bf16 model's logits widened: numpy has no bf16)."""
        x = torch.as_tensor(np.asarray(waveforms, dtype=np.float32))
        if x.ndim != 2 or x.shape[1] != self.clip_samples:
            raise ValueError(f"expected (B, {self.clip_samples}) waveforms, "
                             f"got {tuple(x.shape)}")
        outs = []
        largest = self.batch_sizes[-1]
        with torch.inference_mode():
            for start in range(0, x.shape[0], largest):
                chunk = x[start:start + largest]
                take = chunk.shape[0]
                b = self._bucket(take)
                if take < b:
                    chunk = torch.nn.functional.pad(chunk, (0, 0, 0, b - take))
                logits = self.model(chunk.to(self.device, non_blocking=True))
                outs.append(logits[:take].float().cpu().numpy())
        return np.concatenate(outs, axis=0)
