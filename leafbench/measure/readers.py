"""What the per-layer readers (``leafbench/metrics/<name>.py``) share.
Each reader takes the run's context (``loops/*.py`` build it: the
timeline of a traced run, the window's host seconds, its units — steps
or requests — and their work) and returns a number, or None where it
finds nothing to read: the harness then leaves the metric out."""

from __future__ import annotations

from typing import Optional

import numpy as np

from leafbench.measure import categories, work


def device_s(ctx: dict, cats) -> Optional[float]:
    """Device seconds in the window of the kernels of categories
    ``cats``; None without a trace or where none ran."""
    tl = ctx.get("timeline")
    if tl is None:
        return None
    total = sum(s for name, s in tl.device_rows().items()
                if categories.category(name) in cats)
    return total or None


def per_unit_ms(ctx: dict, kind: str, cats) -> Optional[float]:
    if ctx.get("kind") != kind or not ctx.get("units"):
        return None
    s = device_s(ctx, cats)
    return None if s is None else s * 1e3 / ctx["units"]


def frontend_roofline(ctx: dict, kind: str) -> Optional[float]:
    """Σ least time of the fused-frontend work the window's units need
    (``work.frontend_bound_ms`` of their shapes) ÷ the device time of the
    fused kernels, in %."""
    if ctx.get("kind") != kind or not ctx.get("units"):
        return None
    s = device_s(ctx, (categories.FRONTEND,))
    if s is None:
        return None
    bound_ms = work.frontend_bound_ms(ctx["frontend_calls"]) * ctx["units"]
    return 100.0 * bound_ms / (s * 1e3)


def idle_share(ctx: dict, kind: str) -> Optional[float]:
    tl = ctx.get("timeline")
    if ctx.get("kind") != kind or tl is None or tl.window_s <= 0 \
            or tl.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_s / tl.window_s)


def mfu(ctx: dict, kind: str) -> Optional[float]:
    """Model FLOPs of the window's units (the reference's count at the
    cell's shapes) ÷ the window's host seconds ÷ the H100's dense TF32
    tensor-core peak, in %."""
    if ctx.get("kind") != kind or not ctx.get("units"):
        return None
    flops = ctx["flops_per_unit"]() * ctx["units"]
    return 100.0 * flops / ctx["window_s"] / work.TF32_PEAK_FLOPS


def dispatch_ms(ctx: dict, span: str) -> Optional[float]:
    """Σ over the spans named ``span`` of (wall time − device-busy time
    inside it) ÷ their count, in ms."""
    tl = ctx.get("timeline")
    if tl is None:
        return None
    spans = tl.spans.get(span, [])
    if not spans:
        return None
    s = np.array([a for a, _ in spans], dtype=np.int64)
    e = np.array([b for _, b in spans], dtype=np.int64)
    host = (e - s).sum() / 1e9
    return float((host - tl.busy_within_s(s, e).sum()) * 1e3 / len(spans))
