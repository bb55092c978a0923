"""LEAF frontend: device-busy ms per train step in [mark_forward,
mark_frontend) and [mark_backbone_grad, mark_backward): the whole Leaf
layer forward and backward (the fused kernels, PCEN, the filters'
generation and their gradients), over the complete marker sequences in
the window (``measure/phases.py``)."""

from leafbench.measure import phases


def read(ctx):
    return phases.train_phase_ms(ctx, "frontend")
