"""Backbone: device-busy ms per train step in [mark_frontend,
mark_backbone_grad): the backbone's forward, the loss and the backbone's
backward, activations and elementwise kernels included, over the complete
marker sequences in the window (``measure/phases.py``)."""

from leafbench.measure import phases


def read(ctx):
    return phases.train_phase_ms(ctx, "backbone")
