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
returned as bf16; the sigmoid BCE in bf16 too (optax casts the targets
to the logits' dtype). The eval step's weighted loss and its outputs are
f32.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from leaf_tpu_torch import tracing
from leaf_tpu_torch.training.state import (TrainState, schedule_lrs,
                                           set_schedule_clock)

__all__ = ["softmax_cross_entropy", "cross_entropy_loss", "bce_logits_loss",
           "mixup", "make_train_step", "make_train_multistep",
           "TrainMultistep", "make_eval_step", "waveform_from_wire",
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
    """Mean sigmoid BCE over all elements (BCEWithLogitsLoss), at the
    logits' dtype as ``optax.sigmoid_binary_cross_entropy`` forms it."""
    return _bce(logits, targets).mean()


def _log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: −softplus(−x), softplus(z) = logaddexp(z, 0)
    = max(z, 0) + log1p(exp(−|z|)), each op at x's dtype."""
    z = -x
    return -(torch.clamp(z, min=0) + torch.log1p(torch.exp(-z.abs())))


def _bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Per-element BCE as optax forms it: the targets cast to the logits'
    dtype, −t·log σ(l) − (1 − t)·log σ(−l) with every op at that dtype (a
    bf16 model's loss is a bf16 loss, as JAX's is)."""
    t = targets.to(logits.dtype)
    return -t * _log_sigmoid(logits) - (1.0 - t) * _log_sigmoid(-logits)


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


def _train_step_body(model_type: str, mixup_alpha: Optional[float],
                     augment_fn: Optional[Callable],
                     process_group=None) -> Callable:
    """(state, x, y, generator) → metrics: augment, forward, loss and
    backward, with the gradients left in ``.grad`` and no update. Shared
    by ``make_train_step`` and the steps a ``make_train_multistep`` graph
    captures. With a ``process_group`` it is the data-parallel body
    (``leaf_tpu_torch.parallel.data_parallel``): global-batch BatchNorm,
    the loss scaled by this rank's share of the batch, and the gradients
    and metrics summed over the ranks."""
    multilabel = model_type == "multilabel"
    loss_inner = bce_logits_loss if multilabel else cross_entropy_loss
    if process_group is not None:
        from leaf_tpu_torch.parallel.data_parallel import (
            local_share, reduce_gradients_and_metrics_)
        from leaf_tpu_torch.parallel.sync_batch_norm import sync_batch_norm

    def forward(model, x, y, generator):
        if mixup_alpha is None:
            logits = model(x, generator)
            return logits, loss_inner(logits, y)
        if multilabel:
            xx, yy, _, _ = mixup(generator, x, y, mixup_alpha, "multilabel")
            logits = model(xx, generator)
            return logits, loss_inner(logits, yy)
        xx, y_a, y_b, lam = mixup(generator, x, y, mixup_alpha, "multiclass")
        logits = model(xx, generator)
        return logits, torch.mean(softmax_cross_entropy(logits, y_a) * lam
                                  + softmax_cross_entropy(logits, y_b)
                                  * (1.0 - lam))

    def body(state: TrainState, x: torch.Tensor, y: torch.Tensor,
             generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        model = state.model.train()
        tracing.mark("mark_step", x)
        x = waveform_from_wire(x)
        if augment_fn is not None:
            x = augment_fn(generator, x)
        if process_group is None:
            logits, loss = forward(model, x, y, generator)
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            tracing.mark("mark_backward", loss)
        else:
            share = local_share(x.shape[0], x.device, process_group)
            with sync_batch_norm(model, process_group):
                logits, loss = forward(model, x, y, generator)
                state.optimizer.zero_grad(set_to_none=True)
                (loss * share).backward()
            tracing.mark("mark_backward", loss)
        if multilabel:
            correct = torch.zeros((), dtype=torch.int32, device=x.device)
        else:
            correct = (logits.detach().argmax(-1) == y).sum().to(torch.int32)
        metrics = {"loss": loss.detach(), "correct": correct,
                   "count": torch.full((), x.shape[0], dtype=torch.int32,
                                       device=x.device)}
        if process_group is not None:
            reduce_gradients_and_metrics_(model, metrics, share,
                                          process_group)
        return metrics

    return body


def _global_norm(tensors) -> torch.Tensor:
    """√(Σ‖t‖²) over ``tensors`` (optax.global_norm), in f32."""
    return torch.sqrt(sum(torch.sum(t.detach().float() ** 2)
                          for t in tensors))


def make_train_step(model_type: str = "multiclass",
                    mixup_alpha: Optional[float] = None,
                    augment_fn: Optional[Callable] = None,
                    watch_norms: bool = False,
                    watch_histograms: bool = False,
                    process_group=None) -> Callable:
    """Build the train step: (state, x, y, generator) → metrics.

    It updates ``state`` in place (model parameters and BatchNorm stats,
    optimizer, schedule, ``state.step``) and returns ``{'loss',
    'correct', 'count'}`` as device scalars. ``correct`` is 0 under
    multilabel, as in the JAX package. ``augment_fn(generator, x)`` runs
    first (e.g. ``leaf_tpu_torch.data.leaf_device_augment``).

    ``watch_norms`` adds ``grad_norm`` and ``param_norm`` (global L2
    norms; the parameters after the update) and the same per top-level
    child (``grad_norm/features``, ``param_norm/model``, ...), the JAX
    step's ``wandb.watch`` scalars. ``watch_histograms`` also stashes the
    gradients by parameter name in ``metrics["_grads"]`` for
    ``training.histograms.histogram_tree`` at log steps.

    ``process_group`` (e.g. ``parallel.data_group()``) makes it the
    data-parallel step of the JAX package's GSPMD semantic: x and y are
    this rank's rows, BatchNorm takes the global batch's statistics, and
    the gradients, ``loss`` (global mean), ``correct`` and ``count``
    (global sums) are reduced over the ranks before the update, so the
    norms are the same on every rank.
    """
    body = _train_step_body(model_type, mixup_alpha, augment_fn,
                            process_group)

    def step(state: TrainState, x: torch.Tensor, y: torch.Tensor,
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        metrics = body(state, x, y, generator)
        state.apply_gradients()
        tracing.mark("mark_update", x)
        if watch_norms or watch_histograms:
            named = [(n, p) for n, p in state.model.named_parameters()
                     if p.grad is not None]
        if watch_norms:
            metrics["grad_norm"] = _global_norm(p.grad for _, p in named)
            metrics["param_norm"] = _global_norm(p for _, p in named)
            for top in dict.fromkeys(n.split(".")[0] for n, _ in named):
                sub = [p for n, p in named if n.split(".")[0] == top]
                metrics[f"grad_norm/{top}"] = _global_norm(p.grad
                                                           for p in sub)
                metrics[f"param_norm/{top}"] = _global_norm(sub)
        if watch_histograms:
            metrics["_grads"] = {n: p.grad for n, p in named}
        return metrics

    return step


def make_train_multistep(steps_per_call: int,
                         model_type: str = "multiclass",
                         mixup_alpha: Optional[float] = None,
                         augment_fn: Optional[Callable] = None,
                         process_group=None) -> "TrainMultistep":
    """K train steps per call: (state, xs (K, B, T), ys (K, B[, C]),
    generator) → {'loss' (mean over the K steps), 'correct', 'count'
    (sums)} as device scalars, the numerics of K ``make_train_step`` calls.

    The counterpart of the JAX package's ``lax.scan`` of K steps. On a
    CUDA device it is one CUDA graph of K steps (``TrainMultistep``); on
    the CPU the K steps run one after another. ``process_group`` makes
    them data-parallel steps (see ``make_train_step``); the graph then
    captures their NCCL collectives. gloo's cannot be captured: a call on
    CUDA tensors over a gloo group raises.
    """
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be ≥ 1: {steps_per_call}")
    return TrainMultistep(steps_per_call, _train_step_body(
        model_type, mixup_alpha, augment_fn, process_group),
        None if process_group is None else dist.get_backend(process_group))


class TrainMultistep:
    """K train steps per call; see ``make_train_multistep``.

    On CUDA inputs the first call runs its K steps eagerly on a side
    stream (they are the graph's warm-up: the optimizer's state exists
    after them) and then captures K steps into one CUDA graph for the
    shapes and dtypes it saw, with the step's ``torch.Generator``
    registered so that every replay draws fresh numbers; the capture runs
    nothing. Each later call copies xs and ys into the graph's static
    buffers, writes the K scheduled lrs into a (K, groups) buffer that
    captured step k copies into the groups' lr tensors, replays, and
    moves the schedule and ``state.step`` on by K on the host. The
    optimizer comes from ``optimization_helper(..., capturable=True)``. A
    capture that fails raises: there is no fallback to eager steps.

    The kernel wrappers do not count a replay's launches. ``per_replay``
    holds the launches one replay makes (by ``launch_counts`` name),
    ``replays`` the replays so far, and ``graph_launch_counts()`` their
    product; ``pool_bytes`` is the size of the graph's private memory
    pool (the K steps' activations, reused from step to step). The graph
    holds each step's seven device markers (``tracing.MARKS``); a
    replay's launch is the host span ``leaf_tpu_torch.train.replay``.
    """

    def __init__(self, steps_per_call: int, body: Callable,
                 backend: Optional[str] = None):
        self.k = steps_per_call
        self._body = body
        self._backend = backend   # of the data-parallel group, if any
        self._graph = None
        self._signature = None
        self.replays = 0
        self.per_replay: Dict[str, int] = {}
        self.pool_bytes = 0

    def graph_launch_counts(self) -> Dict[str, int]:
        return {name: n * self.replays for name, n in self.per_replay.items()}

    def can_replay(self, xs: torch.Tensor, ys: torch.Tensor) -> bool:
        """Whether a call with xs and ys runs: True before the first
        capture and on the CPU, else whether the graph was captured for
        their shapes and dtypes (a call with others raises)."""
        if self._signature is None or not xs.is_cuda:
            return True
        return (tuple(xs.shape), xs.dtype, tuple(ys.shape),
                ys.dtype) == self._signature[:4]

    def __call__(self, state: TrainState, xs: torch.Tensor, ys: torch.Tensor,
                 generator: Optional[torch.Generator] = None
                 ) -> Dict[str, torch.Tensor]:
        if xs.shape[0] != self.k or ys.shape[0] != self.k:
            raise ValueError(f"expected {self.k} stacked batches, got xs "
                             f"{tuple(xs.shape)}, ys {tuple(ys.shape)}")
        if not xs.is_cuda:
            return self._eager(state, xs, ys, generator)
        if self._backend not in (None, "nccl"):
            raise ValueError(
                f"{self.k} data-parallel steps per call on the card are one "
                f"CUDA graph, which captures NCCL collectives only, not "
                f"{self._backend}'s; use NCCL or one step per call")
        signature = (tuple(xs.shape), xs.dtype, tuple(ys.shape), ys.dtype,
                     id(state.model), id(state.optimizer), id(generator))
        if self._graph is None:
            side = torch.cuda.Stream(xs.device)
            side.wait_stream(torch.cuda.current_stream(xs.device))
            with torch.cuda.stream(side):
                metrics = self._eager(state, xs, ys, generator)
            torch.cuda.current_stream(xs.device).wait_stream(side)
            self._capture(state, xs, ys, generator)
            self._signature = signature
            return metrics
        if signature != self._signature:
            raise ValueError("the CUDA graph was captured for another state, "
                             "generator or batch shape; make a new "
                             "make_train_multistep for this one")
        return self._replay(state, xs, ys)

    def _eager(self, state, xs, ys, generator):
        out = []
        for k in range(self.k):
            out.append(self._body(state, xs[k], ys[k], generator))
            state.apply_gradients()
            tracing.mark("mark_update", xs)
        return {"loss": torch.stack([m["loss"] for m in out]).mean(),
                "correct": sum(m["correct"] for m in out),
                "count": sum(m["count"] for m in out)}

    def _capture(self, state, xs, ys, generator):
        from leaf_tpu_torch.ops.fused_frontend import KERNELS, launch_counts
        groups = state.optimizer.param_groups
        if not all(g.get("capturable") and torch.is_tensor(g["lr"])
                   and g["lr"].device == xs.device for g in groups):
            raise ValueError(
                "a CUDA graph of train steps needs the optimizer of "
                "optimization_helper(..., capturable=True): capturable Adam "
                "with each group's lr a tensor on the batch's device")
        sched = state.scheduler
        if sched is not None and not isinstance(
                sched, torch.optim.lr_scheduler.LambdaLR):
            raise TypeError(f"a per-batch schedule must be a LambdaLR, got "
                            f"{type(sched).__name__}")
        self._xs, self._ys = torch.empty_like(xs), torch.empty_like(ys)
        self._lrs = torch.empty((self.k, len(groups)), device=xs.device)
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        # the graph's markers: built and loaded now, outside the capture
        tracing._load_marks(xs.device)
        before = launch_counts()
        # thread_local: the host feeder thread may pin and copy meanwhile
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = []
            for k in range(self.k):
                if sched is not None:
                    for g, group in enumerate(groups):
                        group["lr"].copy_(self._lrs[k, g])
                out.append(self._body(state, self._xs[k], self._ys[k],
                                      generator))
                state.optimizer.step()
                tracing.mark("mark_update", self._xs)
            self._out = {
                "loss": torch.stack([m["loss"] for m in out]).mean(),
                "correct": torch.stack([m["correct"] for m in out]).sum(),
                "count": torch.stack([m["count"] for m in out]).sum()}
        pool = tuple(graph.pool())
        self.pool_bytes = sum(
            seg["total_size"] for seg in torch.cuda.memory_snapshot()
            if tuple(seg.get("segment_pool_id", ())) == pool)
        # the wrappers ran (and counted) while the capture recorded their
        # launches; those launches run at each replay, not at the capture
        after = launch_counts()
        self.per_replay = {n: after[n] - before[n] for n in after
                           if after[n] != before[n]}
        for name, fn in KERNELS.items():
            fn.launches = before[name]
        self._graph = graph

    def _replay(self, state, xs, ys):
        self._xs.copy_(xs)
        self._ys.copy_(ys)
        sched = state.scheduler
        if sched is not None:
            lrs = [schedule_lrs(sched, sched.last_epoch + k)
                   for k in range(self.k)]
            self._lrs.copy_(torch.tensor(lrs, dtype=torch.float32)
                            .pin_memory(), non_blocking=True)
        with tracing.span("leaf_tpu_torch.train.replay"):
            self._graph.replay()
        self.replays += 1
        if sched is not None:
            set_schedule_clock(sched, sched.last_epoch + self.k)
        state.step += self.k
        return {name: v.clone() for name, v in self._out.items()}


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
