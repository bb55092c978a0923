"""Fused frontend kernels: the least time of a train step's saving
forward and backward at the cell's (B, T, F), counted from the shape,
× steps ÷ the device time of the fused kernels in the window, in %."""

from leafbench.measure import readers


def read(ctx):
    return readers.frontend_roofline(ctx, "train")
