"""Serving dispatch: Σ wall ms of the port's ``leaf_tpu_torch.serve.h2d``
spans in the window (each chunk's copy to the card; a pageable copy holds
the host until it is done) ÷ requests."""

from leafbench.measure import phases


def read(ctx):
    return phases.span_ms(ctx, "serve", phases.H2D)
