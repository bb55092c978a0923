"""Train and eval steps, losses and on-device mixup.

The numerics are ``leaf_tpu.training.steps``'s: softmax cross-entropy for
multiclass and sigmoid BCE for multilabel (mean over the batch, resp.
over all elements), per-sample Beta(α, α) mixup, the augment before the
forward, BatchNorm on batch statistics with its running stats updated,
one optimizer update and one per-batch schedule step per call. As in the
JAX package, the step's metrics stay on the device (no ``.item()`` per
step); a driver reads them once per epoch.

Randomness (augment, mixup, dropout, drop-connect) comes from one
``torch.Generator`` on the batch's device passed to each call; it gives
other numbers than the JAX package's ``jax.random`` keys.

Under ``compute_dtype=bfloat16`` the logits are bf16 and the losses are
formed as optax forms them: the softmax cross-entropy per example in
bf16 (logsumexp minus the label's logit), its mean summed in f32 and
returned as bf16; the sigmoid BCE in the promoted dtype of logits and
targets. The eval step's weighted loss and its outputs are f32.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from leaf_tpu_torch.training.state import TrainState

__all__ = ["softmax_cross_entropy", "cross_entropy_loss", "bce_logits_loss",
           "mixup",
           "make_train_step", "make_eval_step", "waveform_from_wire",
           "pad_batch_to_multiple"]


def waveform_from_wire(x: torch.Tensor) -> torch.Tensor:
    """int16 PCM batches → float32 in [-1, 1) (× 1/32768, the scale every
    decode backend applies to int16 sources); float inputs pass through."""
    if x.dtype == torch.int16:
        return x.to(torch.float32) * (1.0 / 32768.0)
    return x


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Per-example softmax cross-entropy with integer labels at the
    logits' dtype: logsumexp minus the label's logit, as
    ``optax.softmax_cross_entropy_with_integer_labels`` forms it."""
    return (torch.logsumexp(logits, dim=-1)
            - logits.gather(-1, labels[:, None].long())[:, 0])


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy with integer labels (CrossEntropyLoss)."""
    return softmax_cross_entropy(logits, labels).mean()


def bce_logits_loss(logits: torch.Tensor,
                    targets: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid BCE over all elements (BCEWithLogitsLoss), in the
    promoted dtype of logits and targets (optax's)."""
    return _bce(logits, targets).mean()


def _bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    dt = torch.promote_types(logits.dtype, targets.dtype)
    return F.binary_cross_entropy_with_logits(
        logits.to(dt), targets.to(dt), reduction="none")


def mixup(generator: Optional[torch.Generator], inputs: torch.Tensor,
          targets: torch.Tensor, alpha: float = 1.0,
          mode: str = "multilabel"):
    """On-device mixup (reference: utilities/data/mixup.py:5-27).

    Returns (mixed_x, mixed_y, None, None) for multilabel and
    (mixed_x, y_a, y_b, lam) for multiclass; lam ~ Beta(α, α) per sample,
    drawn as G₁/(G₁+G₂) from two Gamma(α) samples of ``generator``.
    """
    b = inputs.shape[0]
    conc = torch.full((2, b), float(alpha), device=inputs.device)
    g = torch._standard_gamma(conc, generator=generator)
    lam = (g[0] / (g[0] + g[1])).to(inputs.dtype)
    perm = torch.randperm(b, generator=generator, device=inputs.device)
    lam_x = lam.reshape((b,) + (1,) * (inputs.ndim - 1))
    mixed_x = inputs * lam_x + inputs[perm] * (1.0 - lam_x)
    if mode == "multilabel":
        lam_y = lam.reshape(b, 1)
        mixed_y = targets * lam_y + targets[perm] * (1.0 - lam_y)
        return mixed_x, mixed_y, None, None
    return mixed_x, targets, targets[perm], lam


def make_train_step(model_type: str = "multiclass",
                    mixup_alpha: Optional[float] = None,
                    augment_fn: Optional[Callable] = None) -> Callable:
    """Build the train step: (state, x, y, generator) → metrics.

    It updates ``state`` in place (model parameters and BatchNorm stats,
    optimizer, schedule, ``state.step``) and returns ``{'loss',
    'correct', 'count'}`` as device scalars. ``correct`` is 0 under
    multilabel, as in the JAX package. ``augment_fn(generator, x)`` runs
    first (e.g. ``leaf_tpu_torch.data.leaf_device_augment``).
    """
    multilabel = model_type == "multilabel"
    loss_inner = bce_logits_loss if multilabel else cross_entropy_loss

    def step(state: TrainState, x: torch.Tensor, y: torch.Tensor,
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        model = state.model.train()
        x = waveform_from_wire(x)
        if augment_fn is not None:
            x = augment_fn(generator, x)
        if mixup_alpha is None:
            logits = model(x, generator)
            loss = loss_inner(logits, y)
        elif multilabel:
            xx, yy, _, _ = mixup(generator, x, y, mixup_alpha, "multilabel")
            logits = model(xx, generator)
            loss = loss_inner(logits, yy)
        else:
            xx, y_a, y_b, lam = mixup(generator, x, y, mixup_alpha,
                                      "multiclass")
            logits = model(xx, generator)
            loss = torch.mean(softmax_cross_entropy(logits, y_a) * lam
                              + softmax_cross_entropy(logits, y_b)
                              * (1.0 - lam))
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.apply_gradients()
        if multilabel:
            correct = torch.zeros((), dtype=torch.int32, device=x.device)
        else:
            correct = (logits.detach().argmax(-1) == y).sum().to(torch.int32)
        return {"loss": loss.detach(), "correct": correct,
                "count": torch.full((), x.shape[0], dtype=torch.int32,
                                    device=x.device)}

    return step


def make_eval_step(model_type: str = "multiclass") -> Callable:
    """Eval step: (state, x, y[, w]) → metrics and raw outputs.

    Multilabel returns sigmoid probabilities, multiclass logits (f32).
    ``w`` is an optional per-example {0, 1} weight for batches padded by
    ``pad_batch_to_multiple``: loss is the w-weighted mean, and correct
    and count are w-weighted sums (count = the number of real rows).
    """
    multilabel = model_type == "multilabel"

    @torch.no_grad()
    def step(state: TrainState, x: torch.Tensor, y: torch.Tensor,
             w: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        x = waveform_from_wire(x)
        logits = state.model.eval()(x)
        if multilabel:
            per_example = _bce(logits, y).mean(dim=-1)
            outputs = torch.sigmoid(logits).float()
            hits = torch.zeros(x.shape[0], device=x.device)
        else:
            per_example = softmax_cross_entropy(logits, y)
            outputs = logits.float()
            hits = (logits.argmax(-1) == y).float()
        if w is None:
            w = torch.ones(x.shape[0], device=x.device)
        return {"loss": (per_example.float() * w).sum()
                / w.sum().clamp_min(1.0),
                "correct": (hits * w).sum().to(torch.int32),
                "count": w.sum().to(torch.int32),
                "outputs": outputs}

    return step


def pad_batch_to_multiple(x, y, multiple: int):
    """Pad (x, y) on the batch axis up to a multiple of ``multiple`` by
    repeating row 0; returns (x, y, w) with w = 0 on the pad rows."""
    n = x.shape[0]
    pad = (-n) % max(1, multiple)
    w = np.ones((n + pad,), np.float32)
    if pad:
        w[n:] = 0.0
        x = np.concatenate([np.asarray(x),
                            np.repeat(np.asarray(x[:1]), pad, axis=0)])
        y = np.concatenate([np.asarray(y),
                            np.repeat(np.asarray(y[:1]), pad, axis=0)])
    return x, y, w
