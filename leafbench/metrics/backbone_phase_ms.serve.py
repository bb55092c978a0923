"""Backbone: device-busy ms per scoring request in [mark_frontend,
mark_backbone) (the backbone's forward, every kernel of it), the mean over
the window's complete forwards × its forwards per request
(``measure/phases.py``)."""

from leafbench.measure import phases


def read(ctx):
    return phases.serve_phase_ms(ctx, "backbone")
