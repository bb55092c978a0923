"""Optimizer: device-busy ms per train step in [mark_backward,
mark_update): capturable Adam's update (and a data-parallel reduction,
where a step has one), over the complete marker sequences in the window
(``measure/phases.py``)."""

from leafbench.measure import phases


def read(ctx):
    return phases.train_phase_ms(ctx, "optimizer")
