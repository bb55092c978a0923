"""Frozen measurement code: the H100's peaks and the fused frontend's work
counts (``work``), the device rows by category (``categories``), the
profiler window and the trace's timeline (``trace``) and the card's name
and power limit (``card``). Copied from ``leaf_tpu_torch/scripts/
_measure.py`` so that later changes to the port cannot move the yardstick.
"""
