"""Fused frontend kernels: the least time of a request's primal forward
at its (clips, T, F), counted from the shape, × requests ÷ the device
time of the fused kernels in the window, in %."""

from leafbench.measure import readers


def read(ctx):
    return readers.frontend_roofline(ctx, "serve")
