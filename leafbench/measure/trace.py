"""The profiler's window and its timeline.

``traced(on)`` runs its body under the profiler (kineto, CPU and CUDA
activities) with a host pause of 50 ms at each edge (kineto keeps a
device row only where its span, moved onto the host clock, lies inside
the window; on the H100 that move has been seen a few ms early: a frozen
copy of ``leaf_tpu_torch.scripts._measure.profile_window``'s padding) and
gives a ``Timeline`` of what it recorded, read from kineto's raw events.
It records the user scope alone: the harness's spans, the CUDA runtime's
calls and the device's rows, and not each of the port's aten ops, whose
recording (a few µs an op) would add to the host time it measures.

The harness marks its own spans with ``torch.profiler.record_function``
under names that begin with ``leafbench.``: the measured window
(``leafbench.window``), each fetch of the next batch group, each step
and each request. ``Timeline`` keeps them beside the device's kernels and
copies and the host's ops, all on one clock (ns).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

WINDOW_PAD_S = 0.05
SPAN = "leafbench."
WINDOW = SPAN + "window"
# device rows that are not work of the card: synchronisations and
# user annotations kineto mirrors onto the device's rows
_NOT_WORK = ("sync", "annotation", "overhead")
# the profiler's own host rows: never what the host was doing for the run
_PROFILER_OWN = ("Activity Buffer Request", "Buffer Flush")
_NAME_CHARS = 160


class Holder:
    """What ``traced`` yields: ``timeline`` is set once the body ends."""
    timeline: Optional["Timeline"] = None


@contextlib.contextmanager
def traced(on: bool):
    holder = Holder()
    if not on:
        yield holder
        return
    from torch._C import _autograd, _profiler
    from torch.autograd import profiler as autograd_profiler
    acts = {_profiler.ProfilerActivity.CPU}
    if torch.cuda.is_available():
        acts.add(_profiler.ProfilerActivity.CUDA)
    config = autograd_profiler.profile(use_kineto=True).config()
    _autograd._prepare_profiler(config, acts)
    _autograd._enable_profiler(config, acts,
                               {_profiler.RecordScope.USER_SCOPE})
    try:
        time.sleep(WINDOW_PAD_S)
        yield holder
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        time.sleep(WINDOW_PAD_S)
    finally:
        result = _autograd._disable_profiler()
    holder.timeline = Timeline.from_events(result.events())


def _merge(starts: np.ndarray, ends: np.ndarray
           ) -> Tuple[np.ndarray, np.ndarray]:
    """The union of intervals as sorted disjoint (starts, ends)."""
    if starts.size == 0:
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(s.size, dtype=bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    return s[idx], np.append(run_end[idx[1:] - 1], run_end[-1])


class Timeline:
    """Device rows (kernels, copies, sets), host ops and the harness's
    spans of one traced window, in ns on the host clock."""

    def __init__(self, dev: List[Tuple[str, int, int]],
                 host: List[Tuple[str, int, int]],
                 spans: Dict[str, List[Tuple[int, int]]]):
        self.dev_names = [d[0] for d in dev]
        self.dev_start = np.array([d[1] for d in dev], dtype=np.int64)
        self.dev_end = np.array([d[2] for d in dev], dtype=np.int64)
        self.host_names = [h[0] for h in host]
        self.host_start = np.array([h[1] for h in host], dtype=np.int64)
        self.host_end = np.array([h[2] for h in host], dtype=np.int64)
        self.spans = spans
        win = spans.get(WINDOW) or [(0, 0)]
        self.win = (min(s for s, _ in win), max(e for _, e in win))
        inside = (self.dev_end > self.win[0]) & (self.dev_start < self.win[1])
        self._inside = inside
        self.busy_start, self.busy_end = _merge(
            np.clip(self.dev_start[inside], *self.win),
            np.clip(self.dev_end[inside], *self.win))
        self._cum = np.concatenate([[0], np.cumsum(self.busy_end
                                                   - self.busy_start)])

    @classmethod
    def from_events(cls, events) -> "Timeline":
        from torch.autograd import DeviceType
        dev, host, spans = [], [], {}
        for e in events:
            name = e.name()
            start = e.start_ns()
            end = start + e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                if e.is_user_annotation() or any(w in name.lower()
                                                  for w in _NOT_WORK):
                    continue
                dev.append((name, start, end))
            elif name.startswith(SPAN):
                spans.setdefault(name, []).append((start, end))
            elif name not in _PROFILER_OWN:
                host.append((name, start, end))
        return cls(dev, host, spans)

    @property
    def window_s(self) -> float:
        return (self.win[1] - self.win[0]) / 1e9

    @property
    def busy_s(self) -> float:
        """Seconds of the window in which some kernel or copy ran."""
        return float(self._cum[-1]) / 1e9

    def busy_within_s(self, start: np.ndarray, end: np.ndarray
                      ) -> np.ndarray:
        """Busy seconds of the device inside each [start, end]."""
        def before(t):
            i = np.searchsorted(self.busy_start, t, side="right")
            part = np.clip(t - self.busy_start[np.maximum(i - 1, 0)], 0,
                           (self.busy_end - self.busy_start)[
                               np.maximum(i - 1, 0)]) if self.busy_start.size \
                else np.zeros_like(t)
            return np.where(i > 0, self._cum[np.maximum(i - 1, 0)] + part, 0)
        return (before(np.asarray(end)) - before(np.asarray(start))) / 1e9

    def device_rows(self) -> Dict[str, float]:
        """Device seconds by kernel name, of the rows inside the window."""
        out: Dict[str, float] = {}
        dur = (np.minimum(self.dev_end, self.win[1])
               - np.maximum(self.dev_start, self.win[0]))
        for i in np.flatnonzero(self._inside):
            name = self.dev_names[i]
            out[name] = out.get(name, 0.0) + float(dur[i]) / 1e9
        return out

    def span_s(self, name: str) -> List[Tuple[float, float]]:
        return [(s / 1e9, e / 1e9) for s, e in self.spans.get(name, [])]

    def idle_gaps(self, longest: int = 500) -> Dict[str, float]:
        """The ``longest`` idle gaps of the device in the window, summed
        by the innermost host op (or harness span) running at each gap's
        middle."""
        starts = np.concatenate([[self.win[0]], self.busy_end])
        ends = np.concatenate([self.busy_start, [self.win[1]]])
        lengths = ends - starts
        pick = np.argsort(-lengths)[:longest]
        pick = pick[lengths[pick] > 0]
        names = self.host_names + [n for n, v in self.spans.items()
                                   if n != WINDOW for _ in v]
        hs = np.concatenate([self.host_start, np.array(
            [s for n, v in self.spans.items() if n != WINDOW for s, _ in v],
            dtype=np.int64)])
        he = np.concatenate([self.host_end, np.array(
            [e for n, v in self.spans.items() if n != WINDOW for _, e in v],
            dtype=np.int64)])
        out: Dict[str, float] = {}
        for i in pick:
            mid = (starts[i] + ends[i]) // 2
            cover = np.flatnonzero((hs <= mid) & (he >= mid))
            name = ("(no host op)" if cover.size == 0 else
                    names[cover[np.argmin((he - hs)[cover])]])
            out[name] = out.get(name, 0.0) + float(lengths[i]) / 1e9
        return out

    def breakdown(self, top: int = 10) -> dict:
        """{"device_ops": the ``top`` kernels by device seconds,
        "idle_gaps": the ``top`` host ops by the idle seconds of the
        longest gaps they ran in}, each [name, seconds]."""
        def best(d):
            return [[k[:_NAME_CHARS], v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": best(self.device_rows()),
                "idle_gaps": best(self.idle_gaps())}
