"""The attention core of a transformer train step (AST's blocks), as the
per-layer readers see it: its device markers in a traced window's
``Timeline`` and its least time, counted from the shapes whatever
implements it.

The port brackets each block's attention core with four empty kernels
(``leaf_tpu_torch.tracing.ATTENTION_MARKS``; a frozen copy here, which a
test holds equal): ``mark_attention`` and ``mark_attention_end`` around
the forward, from the q, k and v views to the merged heads, and
``mark_attention_grad`` and ``mark_attention_grad_end`` around its
backward. A core's device time is the device-busy time between the end
of its opening marker and the start of its closing one. Only train steps
whose seven step markers all lie inside the window (``phases.sequences``)
and that hold every core's two intervals count; the readers divide by
their number.

The least time of one core, forward and backward (``core_work``): QKᵀ and
PV in the forward and dQ, dK, dV and dP in the backward, 12·B·H·n²·d
operations on the tensor cores in 3×TF32 for f32 operands (three TF32
products each); the softmax on the CUDA cores, 5 operations a score in
the forward (scale, max, subtract, exp, sum and normalise counted as 5)
and 3 in the backward (dS = P ∘ (dP − D), scaled); Q, K, V, O, dO, dQ,
dK and dV each moved once. Counted without recompute, so it reads the
same work whatever implements the core.

The shapes come from the run's train shapes (its ``frontend_calls``: the
batch, the clip's samples, the filters) and from the one AST
configuration under ``leafbench/configs/`` with those shapes: the image
is (filters, frames), n = 2 + f_dim·t_dim tokens of its patch grid, H
heads of d = D/H, ``depth`` cores a step. Two AST configurations with
the same shapes cannot be told apart by the run: the lookup raises.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Optional

import numpy as np

from leafbench.measure import phases, work

ATTENTION_MARKS = ("mark_attention", "mark_attention_end",
                   "mark_attention_grad", "mark_attention_grad_end")
# the (opening, closing) markers of a core's forward and backward
PAIRS = (("mark_attention", "mark_attention_end"),
         ("mark_attention_grad", "mark_attention_grad_end"))
PATCH = 16
SOFTMAX_FLOPS = 8            # a score's, forward 5 + backward 3
_MARK = re.compile(r"leaf_tpu_torch(?:::|\d+)(mark_[a-z_]+)")
_CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")


def marker(name: str) -> Optional[str]:
    """The attention marker a device row's kernel name is, or None."""
    if "leaf_tpu_torch" not in name:
        return None
    m = _MARK.search(name)
    return m.group(1) if m and m.group(1) in ATTENTION_MARKS else None


def tokens(model: dict) -> int:
    """n: the cls and dist tokens and AST's patch grid."""
    f_dim = (int(model["input_fdim"]) - PATCH) // int(model["fstride"]) + 1
    t_dim = (int(model["input_tdim"]) - PATCH) // int(model["tstride"]) + 1
    return 2 + f_dim * t_dim


def core_work(b: int, n: int, heads: int, d: int, es: int = 4) -> dict:
    """``work.bound``'s arguments for one attention core's forward and
    backward over (B, H, n, d) operands of ``es`` bytes (f32: 4)."""
    scores = b * heads * n * n
    return {"flops": SOFTMAX_FLOPS * scores,
            "nbytes": 8 * es * b * heads * n * d,
            "tc_flops": 3 * 12 * scores * d,
            "tc_peak": work.TF32_PEAK_FLOPS}


def step_bound_ms(model: dict, b: int) -> float:
    """Least ms of a train step's attention cores: ``depth`` of them."""
    heads = int(model["num_heads"])
    d = int(model["embed_dim"]) // heads
    one = work.bound(**core_work(b, tokens(model), heads, d))["bound_ms"]
    return int(model["depth"]) * one


def ast_model(ctx: dict) -> Optional[dict]:
    """The ``model`` section of the AST configuration whose batch, clip
    samples and filters are the run's train shapes, with the image
    (``input_fdim``, ``input_tdim``) those shapes give; None where no
    configuration has them. Raises ``ValueError`` where more than one
    has."""
    calls = ctx.get("frontend_calls") or []
    if not calls:
        return None
    _, b, t, f, _ = calls[0]
    found, model = [], None
    for path in sorted(glob.glob(os.path.join(_CONFIGS, "*.json"))):
        with open(path) as fh:
            cfg = json.load(fh)["cfg"]
        fe, ac = cfg["frontend"], cfg["audio_config"]
        if cfg["model"].get("arch") != "ast" or fe.get("default_args"):
            continue
        samples = int(float(ac["random_clip_size"]) * int(ac["sample_rate"]))
        if (int(cfg["opt"]["batch_size"]), samples,
                int(fe.get("n_filters", 40))) == (b, t, f):
            found.append(path)
            model = {**cfg["model"], "input_fdim": f,
                     "input_tdim": work.frames_out(t)}
    if len(found) > 1:
        raise ValueError(f"AST configurations with the same train shapes "
                         f"{(b, t, f)}: {found}")
    return model


def core_intervals(tl, cores: int) -> Optional[tuple]:
    """((k, 2) [start, end] ns of the device time of each counted core
    interval, forward and backward, the number of steps counted): the
    complete train steps in the window that hold ``cores`` forward and
    ``cores`` backward intervals; None where there is none."""
    seqs = phases.sequences(tl, phases.TRAIN_SEQUENCE)
    if not len(seqs):
        return None
    rows = sorted((int(tl.dev_start[i]), int(tl.dev_end[i]), m)
                  for i, name in enumerate(tl.dev_names)
                  if (m := marker(name)) is not None)
    spans, steps = [], 0
    for seq in seqs:
        lo, hi = seq[0, 0], seq[-1, 1]
        inside = [r for r in rows if lo <= r[0] and r[1] <= hi]
        got = []
        for a, z in PAIRS:
            opened = None
            for s, e, m in inside:
                if m == a:
                    opened = e
                elif m == z and opened is not None:
                    got.append((opened, s))
                    opened = None
        if len(got) == 2 * cores:
            spans += got
            steps += 1
    if not steps:
        return None
    return np.array(spans, dtype=np.int64).reshape(-1, 2), steps


def _read(ctx: dict) -> Optional[tuple]:
    """(the AST configuration's model section, device-busy s of the
    counted cores, steps counted); None where there is nothing to read."""
    tl = ctx.get("timeline")
    if ctx.get("kind") != "train" or tl is None:
        return None
    model = ast_model(ctx)
    if model is None:
        return None
    got = core_intervals(tl, int(model["depth"]))
    if got is None:
        return None
    spans, steps = got
    return (model, float(tl.busy_within_s(spans[:, 0], spans[:, 1]).sum()),
            steps)


def phase_ms(ctx: dict) -> Optional[float]:
    """Device-busy ms a train step inside the attention cores."""
    got = _read(ctx)
    return None if got is None else got[1] * 1e3 / got[2]


def roofline(ctx: dict) -> Optional[float]:
    """The cores' least time a step × steps ÷ their device time, in %."""
    got = _read(ctx)
    if got is None or got[1] <= 0:
        return None
    model, busy_s, steps = got
    b = ctx["frontend_calls"][0][1]
    return 100.0 * step_bound_ms(model, b) * steps / (busy_s * 1e3)
