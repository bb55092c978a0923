"""Device time, host time and rooflines on the card: the measurement core
the tools of ``leaf_tpu_torch.scripts`` and ``chip_smoke.py`` share.

- ``cuda_time_ms``: CUDA events around ``iters`` launches after a
  warm-up (a kernel's time).
- ``host_times_ms``: the host clock around calls that end in a
  synchronize (a step's or a request's time).
- ``device_profile``: torch.profiler with CPU and CUDA activities; the
  device rows by kernel name (count and ms per call), the busy ms per
  call and the idle share against a host-clock median taken without the
  profiler. ``host_profile``: the host ops by self CPU time.
  ``profile_window``: the profiler's window under them, padded.
  ``collectives``: the c10d calls and NCCL kernels of one call.
- ``categorize``: the device rows rolled up by what they compute.
- The H100's published peaks, ``bound`` and ``frontend_work``: the
  operations and bytes of each fused-frontend kernel from its shape,
  whatever implements it.
- ``card``: the device's name, power limit and count.

A CPU run gives no device number: the device readers are for CUDA
devices only, and the tools write ``None`` where a device metric was not
measured (a CPU time is never written under a device metric's name).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from leaf_tpu_torch import resolve_device
from leaf_tpu_torch.ops.fused_frontend import lowpass_frames_out

__all__ = ["F32_PEAK_FLOPS", "TF32_PEAK_FLOPS", "BF16_PEAK_FLOPS",
           "HBM_BYTES_PER_S", "CATEGORIES", "OTHER", "bound",
           "frontend_work",
           "cuda_time_ms", "event_timer", "host_times_ms", "DeviceProfile",
           "WINDOW_PAD_S", "profile_window", "device_profile",
           "host_profile", "collectives", "categorize",
           "card", "smi_line", "open_device", "emit", "sync"]

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
F32_PEAK_FLOPS = 67e12
TF32_PEAK_FLOPS = 494.7e12  # tensor cores
BF16_PEAK_FLOPS = 989e12    # tensor cores
HBM_BYTES_PER_S = 3.35e12

_TAPS, _STRIDE, _PAD = 401, 160, (200, 200)


def bound(flops: float, nbytes: float, tc_flops: float = 0.0,
          tc_peak: float = TF32_PEAK_FLOPS) -> dict:
    """Least time for ``flops`` f32 operations on the CUDA cores plus
    ``tc_flops`` tensor-core operations at ``tc_peak`` (TF32 unless
    named), or for moving ``nbytes``: {"bound_ms", "bound_by"}."""
    flop_ms = (flops / F32_PEAK_FLOPS + tc_flops / tc_peak) * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(flop_ms, byte_ms),
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes"}


def frontend_work(b: int, t: int, f: int, dtype: torch.dtype,
                  kind: str) -> dict:
    """``bound``'s arguments for one fused-frontend kernel call at (B, T,
    F): ``kind`` 'fwd' (primal), 'fwd_save' (also writes OUT) or 'bwd'.

    Operations: the 401-tap correlation of x with the bank (2·B·T·2F·401)
    on the tensor cores, three times in 3×TF32 for f32 operands, once at
    the bf16 rate for bf16; the rest (|·|², the lowpass, dS and
    d_windows) on the CUDA cores. Bytes: each input read once and each
    output written once, at its dtype (x, the bank, OUT and d_bank at
    ``dtype``; the windows, out, dY and d_windows f32). Both depend on
    the function and the shape only."""
    if kind not in ("fwd", "fwd_save", "bwd"):
        raise ValueError(f"kind must be fwd, fwd_save or bwd: {kind!r}")
    es = 2 if dtype == torch.bfloat16 else 4
    n_frames = lowpass_frames_out(t, _STRIDE, _TAPS, _PAD)
    conv_flops = 2 * b * t * 2 * f * _TAPS
    x_b, bank_b, win_b = es * b * t, es * _TAPS * 2 * f, 4 * f * _TAPS
    out_b, conv_b = 4 * b * n_frames * f, es * b * 2 * f * t
    if kind == "bwd":
        # S positions each frame's window covers inside [0, T): the work
        # of dS and of d_windows
        covered = sum(min(_STRIDE * fr + 201, t) - max(_STRIDE * fr - 200, 0)
                      for fr in range(n_frames))
        flops = 7 * b * t * f + 2 * 2 * b * f * covered
        nbytes = x_b + conv_b + win_b + out_b + bank_b + win_b
    else:
        flops = 3 * b * t * f + 2 * b * n_frames * f * _TAPS
        nbytes = x_b + bank_b + win_b + out_b + (conv_b if kind == "fwd_save"
                                                 else 0)
    if es == 2:
        return {"flops": flops, "nbytes": nbytes, "tc_flops": conv_flops,
                "tc_peak": BF16_PEAK_FLOPS}
    return {"flops": flops, "nbytes": nbytes, "tc_flops": 3 * conv_flops,
            "tc_peak": TF32_PEAK_FLOPS}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def cuda_time_ms(fn: Callable, iters: int = 20, warmup: int = 3) -> float:
    """ms per call of ``fn`` on the card: CUDA events around ``iters``
    calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def event_timer(device, iters: int) -> Callable[[Callable], Optional[float]]:
    """``timed(fn)``: on the card ``cuda_time_ms`` over ``iters`` launches
    (warm-up min(3, iters)); on the CPU one call of ``fn`` (its path runs)
    and None (no device time)."""
    if torch.device(device).type == "cuda":
        return lambda fn: cuda_time_ms(fn, iters=iters, warmup=min(3, iters))

    def once(fn):
        fn()
        return None
    return once


def host_times_ms(fn: Callable, n: int, device, warmup: int = 3,
                  per: int = 1) -> List[float]:
    """Host-clock ms of each of ``n`` calls of ``fn`` after ``warmup``,
    each call ending in a synchronize of ``device``; divided by ``per``
    (the steps a call makes)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3 / per)
    return times


# Kineto keeps a device activity only where its span, moved onto the host
# clock, lies inside the profiler's window. On the H100 that move has been
# seen a few ms early (kernels stamped before the host launched them),
# which dropped the first ~100 kernels of a CUDA-graph replay, a saving
# forward among them (``python -m tests.torch_profile_window_check``
# counts such windows). A host pause at each edge of the window keeps the
# work inside it; a pause adds no device row and no host op.
WINDOW_PAD_S = 0.05


def profile_window(fn: Callable, n: int, pad: float = WINDOW_PAD_S):
    """torch.profiler (CPU and CUDA) over ``n`` calls of ``fn`` and a
    synchronize, with a host pause of ``pad`` s at each edge."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(pad)
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        time.sleep(pad)
    return prof


def _events(fn: Callable, n: int):
    return profile_window(fn, n).key_averages()


def _is_device_work(event) -> bool:
    """A kernel or copy on the card; not a user annotation (such as
    ``Optimizer.step#Adam.step``), whose span covers kernels already
    counted."""
    from torch.autograd import DeviceType
    return (event.device_type == DeviceType.CUDA
            and not getattr(event, "is_user_annotation", False))


@dataclass
class DeviceProfile:
    """One window of ``device_profile``: ``rows`` (kernel name, launches
    per call, device ms per call) largest first; ``busy_ms`` their sum
    per call (None when the trace holds no device time: not measured);
    ``host_ms`` the host-clock median per call and ``idle`` the share of
    it the card sat idle (None without a host median)."""
    rows: List[Tuple[str, float, float]]
    busy_ms: Optional[float]
    host_ms: Optional[float] = None
    idle: Optional[float] = None
    categories: Dict[str, float] = field(default_factory=dict)

    @property
    def launches(self) -> float:
        return sum(r[1] for r in self.rows)

    def ms(self, *patterns: str) -> float:
        """Device ms per call of the rows whose name holds a pattern."""
        return sum(r[2] for r in self.rows
                   if any(p in r[0] for p in patterns))

    def count(self, pattern: str) -> float:
        """Launches per call of the rows whose name holds ``pattern``."""
        return sum(r[1] for r in self.rows if pattern in r[0])


def device_profile(fn: Callable, n: int = 1, host_ms: Optional[float] = None,
                   per: int = 1, device=None) -> DeviceProfile:
    """``n`` calls of ``fn`` under torch.profiler: the device rows by kernel
    name per call (divided by ``per`` more: the steps a call makes), busy
    ms, and the idle share against ``host_ms`` — the host-clock median per
    call (per step) without the profiler; with ``device`` and no
    ``host_ms`` it is measured here first (``n`` calls)."""
    if host_ms is None and device is not None:
        host_ms = float(np.median(host_times_ms(fn, n, device, warmup=0,
                                                per=per)))
    by_name: Dict[str, list] = {}
    for e in _events(fn, n):
        if _is_device_work(e):
            row = by_name.setdefault(e.key, [0, 0.0])
            row[0] += e.count
            row[1] += e.self_device_time_total
    rows = sorted(((k, c / n / per, us / 1e3 / n / per)
                   for k, (c, us) in by_name.items()),
                  key=lambda r: -r[2])
    busy = sum(r[2] for r in rows) or None
    idle = (1.0 - busy / host_ms) if busy and host_ms else None
    return DeviceProfile(rows, busy, host_ms, idle,
                         categorize(rows) if busy else {})


def host_profile(fn: Callable, n: int = 1, top: int = 10
                 ) -> List[Tuple[str, float, float]]:
    """The host ops of ``n`` calls of ``fn`` by self CPU time: (name, calls
    per call, self CPU ms per call), the ``top`` largest."""
    rows = [(e.key, e.count / n, e.self_cpu_time_total / 1e3 / n)
            for e in _events(fn, n)
            if not _is_device_work(e) and e.self_cpu_time_total > 0]
    return sorted(rows, key=lambda r: -r[2])[:top]


def collectives(fn: Callable) -> tuple:
    """(c10d collective calls, NCCL kernels, their device ms, host ms of
    the c10d calls) of one ``fn()`` under torch.profiler. A one-rank NCCL
    all_reduce in place launches no kernel: at world 1 the calls cost
    host time only, and a graph replay makes none."""
    events = _events(fn, 1)
    nccl = [e for e in events if _is_device_work(e)
            and "nccl" in e.key.lower()]
    host = [e for e in events if e.key.startswith("c10d::")]
    return (sum(e.count for e in host), sum(e.count for e in nccl),
            sum(e.self_device_time_total for e in nccl) / 1e3,
            sum(e.cpu_time_total for e in host) / 1e3)


# The port's device rows by what they compute, matched in this order by
# (lower-case) patterns of the names the card's trace prints (PERF.md §3
# lists those seen on the H100). The first category that matches wins.
CATEGORIES = (
    ("fused frontend kernels", ("fused_fwd", "fused_bwd")),
    ("NCCL", ("nccl",)),
    ("depthwise convolutions", ("depthwise",)),
    ("BatchNorm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw", "bn_",
                   "welford")),
    ("optimizer (foreach Adam)", ("multi_tensor_apply", "adam", "foreach")),
    ("cuDNN/cuBLAS convolutions and GEMMs",
     ("conv", "gemm", "xmma", "cudnn", "cutlass", "nvjet", "fprop", "dgrad",
      "wgrad", "sm90_", "sm80_", "ampere_", "hopper_")),
    ("copies/casts", ("memcpy", "memset", "copy_kernel", "batchedcopy",
                      "transpose", "permute")),
    ("elementwise/reductions", ("elementwise", "reduce", "scan", "sort",
                                "index", "gather", "scatter", "softmax",
                                "pool", "pad", "fill", "where",
                                "distribution", "random")),
)
OTHER = "other"


def categorize(rows) -> Dict[str, float]:
    """Device ms per category of ``rows`` ((name, count, ms) or (name, ms)
    tuples): every category of CATEGORIES and OTHER, in that order."""
    out = {name: 0.0 for name, _ in CATEGORIES}
    out[OTHER] = 0.0
    for row in rows:
        name, ms = row[0].lower(), row[-1]
        for cat, patterns in CATEGORIES:
            if any(p in name for p in patterns):
                out[cat] += ms
                break
        else:
            out[OTHER] += ms
    return out


def smi_line() -> Optional[str]:
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card, or
    None where there is no nvidia-smi."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0] if lines else None


def card(device) -> dict:
    """{"device": the card's name or "cpu", "power_limit": nvidia-smi's
    power limit (None on the CPU), "count": torch.cuda.device_count()}."""
    if torch.device(device).type != "cuda":
        return {"device": "cpu", "power_limit": None,
                "count": torch.cuda.device_count()}
    line = smi_line()
    return {"device": torch.cuda.get_device_name(torch.device(device)),
            "power_limit": line.split(",")[-1].strip() if line else None,
            "count": torch.cuda.device_count()}


def open_device(name: Optional[str], prog: str) -> Optional[torch.device]:
    """The tool's device (``--device``; cuda unless named), TF32 off on the
    card as in every measurement of the port; None (after a message on
    stderr) where it asks for the card and there is none."""
    try:
        dev = resolve_device(name)
    except RuntimeError as e:
        print(f"{prog}: {e}", file=sys.stderr)
        return None
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def emit(record: dict) -> None:
    """One JSON line on stdout."""
    print(json.dumps(record), flush=True)
