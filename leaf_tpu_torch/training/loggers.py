"""Observability: throughput tracking, TensorBoard, wandb (optional),
profiler traces.

``leaf_tpu.training.loggers`` in the port: ``RateTracker``
(``xm.RateTracker``'s examples/s), ``TrainLogger`` (stdout, and
TensorBoard through tensorboardX and wandb where they are installed —
both imported only when a logger asks for them — with scalars and the
watched histograms), and ``profile_trace``
around ``torch.profiler``, which writes a Chrome trace.
"""

from __future__ import annotations

import os
import time
from typing import Optional

__all__ = ["RateTracker", "TrainLogger", "profile_trace"]


class RateTracker:
    """Examples/sec tracker (xm.RateTracker equivalent)."""

    def __init__(self, smooth_factor: float = 0.4):
        self.smooth_factor = smooth_factor
        self.reset()

    def reset(self) -> None:
        self._start = time.time()
        self._partial_time = self._start
        self._partial_count = 0.0
        self._count = 0.0
        self._rate = 0.0

    def add(self, count: float) -> None:
        now = time.time()
        self._count += count
        self._partial_count += count
        dt = now - self._partial_time
        if dt > 0.5:
            partial_rate = self._partial_count / dt
            self._rate = (self._rate * self.smooth_factor
                          + partial_rate * (1.0 - self.smooth_factor)) \
                if self._rate else partial_rate
            self._partial_count = 0.0
            self._partial_time = now

    def rate(self) -> float:
        return self._rate

    def global_rate(self) -> float:
        dt = time.time() - self._start
        return self._count / dt if dt > 0 else 0.0


class TrainLogger:
    """stdout + optional TensorBoard + optional wandb, master-process only."""

    def __init__(self, exp_dir: str, is_master: bool = True,
                 use_tensorboard: bool = True,
                 wandb_config: Optional[dict] = None):
        self.is_master = is_master
        self.tb = None
        self.wandb = None
        if not is_master:
            return
        os.makedirs(exp_dir, exist_ok=True)
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter
                self.tb = SummaryWriter(os.path.join(exp_dir, "tb"))
            except ImportError:
                pass
        if wandb_config:
            try:
                import wandb
                self.wandb = wandb
                wandb.init(**wandb_config)
            except ImportError:
                print("wandb not installed; skipping wandb logging")

    def print(self, msg: str) -> None:
        """xm.master_print equivalent."""
        if self.is_master:
            print(msg, flush=True)

    def log_scalars(self, scalars: dict, step: int) -> None:
        if not self.is_master:
            return
        if self.tb is not None:
            for k, v in scalars.items():
                self.tb.add_scalar(k, v, step)
        if self.wandb is not None:
            self.wandb.log(scalars, step=step)

    def log_histograms(self, hists: dict, step: int) -> None:
        """Write per-tensor histograms (``wandb.watch(log="all")``):
        ``hists`` maps tag → ``(counts, lo, hi, sum, sum_sq)`` as
        ``training.histograms.histogram_tree`` gives them on the device;
        only these cross to the host, here."""
        if not self.is_master or (self.tb is None and self.wandb is None):
            return
        import numpy as np
        for tag, (counts, lo, hi, s, ssq) in hists.items():
            counts = counts.cpu().numpy()
            lo, hi = float(lo), float(hi)
            if not hi > lo:
                # a constant tensor: widen by a RELATIVE epsilon (an
                # absolute one underflows against |lo| ≳ 1e4, and equal
                # edges are malformed buckets to tensorboard and wandb)
                hi = lo + max(abs(lo), 1.0) * 1e-6
            edges = np.linspace(lo, hi, counts.shape[0] + 1)
            if self.tb is not None:
                self.tb.add_histogram_raw(
                    tag, min=lo, max=hi, num=int(counts.sum()),
                    sum=float(s), sum_squares=float(ssq),
                    bucket_limits=edges[1:].tolist(),
                    bucket_counts=counts.tolist(), global_step=step)
            if self.wandb is not None:
                self.wandb.log(
                    {tag: self.wandb.Histogram(
                        np_histogram=(counts, edges))}, step=step)

    def close(self) -> None:
        if self.tb is not None:
            self.tb.close()
        if self.wandb is not None:
            self.wandb.finish()


class profile_trace:
    """Context manager around ``torch.profiler`` for step-range traces:
    CPU activity, and CUDA activity where a card is present; on exit it
    writes ``<logdir>/trace.json`` (Chrome trace format). A falsy
    ``logdir`` makes it a no-op."""

    def __init__(self, logdir: Optional[str]):
        self.logdir = logdir
        self.profiler = None

    def __enter__(self):
        if self.logdir:
            import torch
            from torch.profiler import ProfilerActivity, profile
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            self.profiler = profile(activities=activities)
            self.profiler.__enter__()
        return self

    def __exit__(self, *exc):
        if self.profiler is not None:
            self.profiler.__exit__(*exc)
            os.makedirs(self.logdir, exist_ok=True)
            self.profiler.export_chrome_trace(
                os.path.join(self.logdir, "trace.json"))
            self.profiler = None
        return False
