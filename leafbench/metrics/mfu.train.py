"""Whole train step: the reference's model FLOPs of a step (forward and
backward at the cell's shapes) × steps ÷ window seconds ÷ the H100's
dense TF32 peak (494.7 TFLOP/s), in %."""

from leafbench.measure import readers


def read(ctx):
    return readers.mfu(ctx, "train")
