"""Serving dispatch: Σ wall ms of the port's
``leaf_tpu_torch.serve.prepare`` spans in the window (the request's
numpy-to-tensor conversion and check, each chunk's slice and padding)
÷ requests."""

from leafbench.measure import phases


def read(ctx):
    return phases.span_ms(ctx, "serve", phases.PREPARE)
