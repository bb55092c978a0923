"""Serving dispatch: Σ wall ms of the port's
``leaf_tpu_torch.serve.forward`` spans in the window (the host's dispatch
of each bucket forward: Python, aten and the kernels' launches) ÷
requests."""

from leafbench.measure import phases


def read(ctx):
    return phases.span_ms(ctx, "serve", phases.FORWARD)
