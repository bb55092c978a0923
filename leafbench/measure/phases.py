"""The port's own spans and device phase markers, as the per-layer
readers see them in a traced window's ``Timeline``.

A frozen copy of ``leaf_tpu_torch.tracing``'s names (``SPANS``, ``MARKS``):
the yardstick imports nothing of the port, and a test holds the copies
equal. The port's spans (``record_function`` names that begin with
``leaf_tpu_torch.``) land in the timeline's host rows; each marker is an
empty kernel whose device row is named ``leaf_tpu_torch::<mark>()``.

A train step launches the seven markers in ``MARKS``' order, a forward in
eval the middle three (``SERVE_SEQUENCE``). A phase is the device-busy
time between the end of one marker and the start of the next
(``TRAIN_PHASES``, ``SERVE_PHASES``). Only complete sequences whose
markers all lie inside the window count; the readers divide by their
number, so a step or forward cut by either edge of the window is dropped.
"""

from __future__ import annotations

import re
from typing import Optional

import numpy as np

SPAN = "leaf_tpu_torch."
PREPARE = SPAN + "serve.prepare"
H2D = SPAN + "serve.h2d"
FORWARD = SPAN + "serve.forward"
FETCH = SPAN + "serve.fetch"
STARVED = SPAN + "feed.starved"
REPLAY = SPAN + "train.replay"
SPANS = (PREPARE, H2D, FORWARD, FETCH, STARVED, REPLAY)
MARKS = ("mark_step", "mark_forward", "mark_frontend", "mark_backbone",
         "mark_backbone_grad", "mark_backward", "mark_update")

TRAIN_SEQUENCE = MARKS
SERVE_SEQUENCE = ("mark_forward", "mark_frontend", "mark_backbone")
# phase → the (from, to) marker pairs whose busy time it sums
TRAIN_PHASES = {
    "augment": (("mark_step", "mark_forward"),),
    "frontend": (("mark_forward", "mark_frontend"),
                 ("mark_backbone_grad", "mark_backward")),
    "backbone": (("mark_frontend", "mark_backbone_grad"),),
    "optimizer": (("mark_backward", "mark_update"),),
}
SERVE_PHASES = {
    "frontend": (("mark_forward", "mark_frontend"),),
    "backbone": (("mark_frontend", "mark_backbone"),),
}

# a demangled (leaf_tpu_torch::mark_step()) or mangled
# (14leaf_tpu_torch9mark_step) kernel name
_MARK = re.compile(r"leaf_tpu_torch(?:::|\d+)(mark_[a-z_]+)")


def marker(name: str) -> Optional[str]:
    """The marker a device row's kernel name is, or None."""
    if "leaf_tpu_torch" not in name:
        return None
    m = _MARK.search(name)
    return m.group(1) if m and m.group(1) in MARKS else None


def sequences(tl, sequence) -> np.ndarray:
    """(n, len(sequence), 2) [start, end] ns of the complete runs of
    ``sequence``'s markers, in order, that lie inside the window."""
    rows = [(int(tl.dev_start[i]), int(tl.dev_end[i]), m)
            for i, name in enumerate(tl.dev_names)
            if (m := marker(name)) is not None
            and tl.dev_start[i] >= tl.win[0] and tl.dev_end[i] <= tl.win[1]]
    rows.sort()
    names = [m for _, _, m in rows]
    want, n = list(sequence), len(sequence)
    out, i = [], 0
    while i + n <= len(rows):
        if names[i:i + n] == want:
            out.append([rows[j][:2] for j in range(i, i + n)])
            i += n
        else:
            i += 1
    return np.array(out, dtype=np.int64).reshape(-1, n, 2)


def phase_s(tl, sequence, pairs) -> Optional[tuple]:
    """(Σ device-busy seconds of the phase made of ``pairs`` over the
    complete sequences, their number); None where there is none."""
    seqs = sequences(tl, sequence)
    if not len(seqs):
        return None
    pos = {m: j for j, m in enumerate(sequence)}
    total = sum(float(tl.busy_within_s(seqs[:, pos[a], 1],
                                       seqs[:, pos[b], 0]).sum())
                for a, b in pairs)
    return total, len(seqs)


def span_rows(tl, name: str) -> np.ndarray:
    """(n, 2) [start, end] ns of the host rows named ``name`` inside the
    window."""
    rows = [(s, e) for n, s, e in zip(tl.host_names, tl.host_start,
                                       tl.host_end)
            if n == name and s >= tl.win[0] and e <= tl.win[1]]
    return np.array(rows, dtype=np.int64).reshape(-1, 2)


def instrumented(tl) -> bool:
    """Whether the traced program records the port's spans at all."""
    return any(n.startswith(SPAN) for n in tl.host_names)


def train_phase_ms(ctx: dict, phase: str) -> Optional[float]:
    """Device ms per train step of ``phase`` (a key of TRAIN_PHASES)."""
    tl = ctx.get("timeline")
    if ctx.get("kind") != "train" or tl is None:
        return None
    got = phase_s(tl, TRAIN_SEQUENCE, TRAIN_PHASES[phase])
    return None if got is None else got[0] * 1e3 / got[1]


def serve_phase_ms(ctx: dict, phase: str) -> Optional[float]:
    """Device ms per scoring request of ``phase`` (a key of SERVE_PHASES):
    the mean over complete forwards × the window's forwards per request
    (its ``serve.forward`` spans ÷ requests)."""
    tl = ctx.get("timeline")
    if ctx.get("kind") != "serve" or tl is None or not ctx.get("units"):
        return None
    got = phase_s(tl, SERVE_SEQUENCE, SERVE_PHASES[phase])
    if got is None:
        return None
    forwards = len(span_rows(tl, FORWARD)) / ctx["units"]
    return got[0] * 1e3 / got[1] * forwards


def span_ms(ctx: dict, kind: str, name: str) -> Optional[float]:
    """Σ wall ms of the port's spans ``name`` in the window ÷ its units
    (steps or requests); 0 where the program records spans but none of
    these, None where it records none."""
    tl = ctx.get("timeline")
    if ctx.get("kind") != kind or tl is None or not ctx.get("units") \
            or not instrumented(tl):
        return None
    rows = span_rows(tl, name)
    return float((rows[:, 1] - rows[:, 0]).sum()) / 1e6 / ctx["units"]
