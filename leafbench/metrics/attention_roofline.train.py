"""Attention core: its least time a train step (``measure/attention.py``:
QKᵀ, PV and their gradients in 3×TF32, the softmax, Q, K, V, O and their
gradients moved once) × steps ÷ the device time inside its markers, in
%."""

from leafbench.measure import attention


def read(ctx):
    return attention.roofline(ctx)
