"""Backbone: device ms per scoring request of its depthwise
convolutions, BatchNorms and cuDNN/cuBLAS convolutions and GEMMs, from
the trace."""

from leafbench.measure import categories, readers


def read(ctx):
    return readers.per_unit_ms(ctx, "serve", categories.BACKBONE)
