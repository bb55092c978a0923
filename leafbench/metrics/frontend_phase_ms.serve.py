"""LEAF frontend: device-busy ms per scoring request in [mark_forward,
mark_frontend) (the whole Leaf layer's forward), the mean over the
window's complete forwards × its forwards per request
(``measure/phases.py``)."""

from leafbench.measure import phases


def read(ctx):
    return phases.serve_phase_ms(ctx, "frontend")
