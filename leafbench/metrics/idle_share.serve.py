"""Device: 1 − (the union of kernel and copy intervals ÷ the traced
window), from one window's own timeline, in %."""

from leafbench.measure import readers


def read(ctx):
    return readers.idle_share(ctx, "serve")
