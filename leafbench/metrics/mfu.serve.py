"""Whole request: the reference's model FLOPs of a request's forward ×
requests ÷ window seconds ÷ the H100's dense TF32 peak (494.7 TFLOP/s),
in %."""

from leafbench.measure import readers


def read(ctx):
    return readers.mfu(ctx, "serve")
