"""Attention core: device-busy ms per train step inside [mark_attention,
mark_attention_end) and [mark_attention_grad, mark_attention_grad_end)
of every block (AST's; ``measure/attention.py``), over the complete
steps in the window."""

from leafbench.measure import attention


def read(ctx):
    return attention.phase_ms(ctx)
