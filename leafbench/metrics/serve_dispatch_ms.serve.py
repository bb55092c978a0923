"""Serving dispatch: Σ over the window's requests of their wall time
minus the device-busy time inside them, ÷ requests, in ms (the host's
share of a request: padding, dispatch, copies and waits)."""

from leafbench.measure import readers


def read(ctx):
    if ctx.get("kind") != "serve":
        return None
    return readers.dispatch_ms(ctx, "leafbench.request")
