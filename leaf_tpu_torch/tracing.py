"""Host spans and device phase markers, read through ``torch.profiler``.

Two primitives, nothing else; a trace is taken by whatever profiler the
caller runs (the train CLI's ``--profile_dir``, ``training.loggers
.profile_trace``, or any ``torch.profiler`` window):

- ``span(name)``: a ``torch.profiler.record_function`` while a profiler is
  enabled on this thread, else a shared no-op context (one C call). The
  names are ``SPANS``; they mark the host's work of a serving request
  (prepare, h2d, forward, fetch), the consumer's waits on an empty
  ``prefetch_to_device`` queue and the launch of a CUDA graph replay.
- ``mark(name, x)``, ``boundary(x)`` and ``attention(core, q, k, v)``:
  device phase markers, empty kernels (``ops/csrc/marks.cu``, one block
  of one thread) launched on the current stream of x's device, whose
  names (``MARKS``, ``ATTENTION_MARKS``) show in the device trace on the
  device's clock, inside CUDA graph replays too. ``boundary`` is the
  identity between the frontend and the backbone: its forward marks
  ``mark_frontend``, its backward ``mark_backbone_grad``.

A marker launches only on a CUDA tensor, never while ``torch.compile`` or
``torch.export`` traces (an exported program holds no marker), and then
always while the current stream is capturing a CUDA graph (a graph is
captured once and its replays cannot change) and otherwise only while a
profiler is enabled. So eager code launches nothing extra with tracing
off, and a captured train step holds its seven markers (and an AST's 4
a block) on every replay.
Where the marker library cannot be built or loaded (no nvcc), the
markers are off on that device, with one warning.
Markers touch no tensor: values and gradients are bit for bit those of
an unmarked run.

``attention(core, q, k, v)`` runs an attention core between the four
markers of ``ATTENTION_MARKS`` (AST's blocks, ``models/ast.py``):
``mark_attention`` before it (at the q, k and v views), and
``mark_attention_end`` after it (at the merged heads); in the backward
``mark_attention_grad`` when the gradient reaches the core's output and
``mark_attention_grad_end`` when it leaves through q, k and v. They are a
tuple of their own: ``MARKS`` stays the seven of every train step.

The markers of a train step, in launch order: ``mark_step`` (the step's
start, before the augment), ``mark_forward`` (``Classifier.forward``),
``mark_frontend`` (the frontend's output), ``mark_backbone`` (the
logits), ``mark_backbone_grad`` (the gradient reaches the frontend's
output), ``mark_backward`` (``loss.backward()`` done) and ``mark_update``
(the optimizer's step done). A forward in eval marks the middle three.
The device-busy time between the end of one marker and the start of the
next is a phase: augment [step, forward), frontend [forward, frontend) +
[backbone_grad, backward), backbone [frontend, backbone_grad) (forward,
loss and backward), optimizer [backward, update).
"""

from __future__ import annotations

import contextlib
import warnings

import torch

__all__ = ["span", "mark", "boundary", "attention", "SPANS", "MARKS",
           "ATTENTION_MARKS"]

SPANS = ("leaf_tpu_torch.serve.prepare", "leaf_tpu_torch.serve.h2d",
         "leaf_tpu_torch.serve.forward", "leaf_tpu_torch.serve.fetch",
         "leaf_tpu_torch.feed.starved", "leaf_tpu_torch.train.replay")
MARKS = ("mark_step", "mark_forward", "mark_frontend", "mark_backbone",
         "mark_backbone_grad", "mark_backward", "mark_update")

ATTENTION_MARKS = ("mark_attention", "mark_attention_end",
                   "mark_attention_grad", "mark_attention_grad_end")

# a marker's index in the library's switch (ops/csrc/marks.cu)
_MARK_INDEX = {name: i for i, name in enumerate(MARKS + ATTENTION_MARKS)}
_NO_SPAN = contextlib.nullcontext()
# the C flag: a profiler started through torch._C._autograd directly
# leaves torch.autograd.profiler's Python flag False
_profiling = torch._C._autograd._profiler_enabled


def span(name: str):
    """A ``record_function(name)`` while a profiler is enabled on this
    thread, else a no-op context manager."""
    if _profiling():
        return torch.autograd.profiler.record_function(name)
    return _NO_SPAN


def _marking(x: torch.Tensor) -> bool:
    if not x.is_cuda or torch.compiler.is_compiling():
        return False
    return _profiling() or torch.cuda.is_current_stream_capturing()


_LOADED: dict = {}   # device index → the marker library, None if it failed


def _load_marks(device: torch.device):
    """The marker library with its kernels loaded into ``device``'s
    context: once per device, at the first call, which ``TrainMultistep``
    makes before its capture (``ops/csrc/marks.cu`` says why). Where the
    library cannot be built or loaded (no nvcc), warns once and returns
    None: the markers are then off on that device, and nothing else."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    if index not in _LOADED:
        from leaf_tpu_torch.ops._build import load_library
        try:
            lib = load_library()
            with torch.cuda.device(index):
                err = lib.phase_marks_load()
            if err != 0:
                raise RuntimeError(f"CUDA error {err}")
        except (RuntimeError, OSError) as e:
            warnings.warn(f"device phase markers off on cuda:{index}: {e}")
            lib = None
        _LOADED[index] = lib
    return _LOADED[index]


def _launch(name: str, x: torch.Tensor) -> None:
    lib = _load_marks(x.device)
    if lib is None:
        return
    with torch.cuda.device(x.device):
        err = lib.phase_mark(_MARK_INDEX[name],
                             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} marker launch failed: CUDA error {err}")


def mark(name: str, x: torch.Tensor) -> None:
    """Launch the device marker ``name`` (of ``MARKS`` or
    ``ATTENTION_MARKS``) on the current
    stream of x's device, under the rules above; a no-op on the CPU."""
    if _marking(x):
        _launch(name, x)


class _Boundary(torch.autograd.Function):
    """The identity; marks ``mark_frontend`` in its forward and
    ``mark_backbone_grad`` when the gradient comes back through it."""

    @staticmethod
    def forward(ctx, x):
        _launch("mark_frontend", x)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        mark("mark_backbone_grad", grad)
        return grad


def boundary(x: torch.Tensor) -> torch.Tensor:
    """The frontend's output x, unchanged, with ``mark_frontend`` launched
    after it and, when a gradient flows back, ``mark_backbone_grad``
    launched before the frontend's backward starts."""
    if not _marking(x):
        return x
    return _Boundary.apply(x)


class _AttentionIn(torch.autograd.Function):
    """The identity on (q, k, v); marks ``mark_attention`` in its forward
    and ``mark_attention_grad_end`` when their gradients come back."""

    @staticmethod
    def forward(ctx, q, k, v):
        _launch("mark_attention", q)
        return q.view_as(q), k.view_as(k), v.view_as(v)

    @staticmethod
    def backward(ctx, dq, dk, dv):
        mark("mark_attention_grad_end", dq)
        return dq, dk, dv


class _AttentionOut(torch.autograd.Function):
    """The identity on the core's output; marks ``mark_attention_end`` in
    its forward and ``mark_attention_grad`` when the gradient reaches
    it."""

    @staticmethod
    def forward(ctx, out):
        _launch("mark_attention_end", out)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, grad):
        mark("mark_attention_grad", grad)
        return grad


def attention(core, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """``core(q, k, v)`` between the attention markers (``ATTENTION_MARKS``,
    under the rules above): values and gradients are ``core``'s own."""
    if not _marking(q):
        return core(q, k, v)
    return _AttentionOut.apply(core(*_AttentionIn.apply(q, k, v)))
