"""Backbone: device ms per train step of its depthwise convolutions,
BatchNorms and cuDNN/cuBLAS convolutions and GEMMs, from the trace."""

from leafbench.measure import categories, readers


def read(ctx):
    return readers.per_unit_ms(ctx, "train", categories.BACKBONE)
