"""Device augment: device-busy ms per train step between the end of the
port's ``mark_step`` marker and the start of ``mark_forward`` (the wire
decode and ``leaf_device_augment``), over the complete marker sequences
in the window (``measure/phases.py``)."""

from leafbench.measure import phases


def read(ctx):
    return phases.train_phase_ms(ctx, "augment")
