"""Device profile of the fused op's fwd+bwd, the counterpart of the JAX
repo's ``scripts/kernel_profile.py``.

Runs ``fused_gabor_sqmod_lowpass`` forward and backward (the gradients
of the bank and the windows of sum(out²)) at B=256 × 1 s, F=40, bf16
unless ``--f32``, over ``--execs`` calls under torch.profiler after a
warm-up, and prints the device ms per call by kernel name: the
``fused_fwd_*`` / ``fused_bwd_*`` rows are the hand-written kernels, the
rest the PyTorch glue around them (the backward's partial-sum reduction,
the loss, casts). The last line is the JSON record.

    python -m leaf_tpu_torch.scripts.kernel_profile [--batch 256]
        [--clip_seconds 1] [--execs 4] [--f32] [--top 40] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from leaf_tpu_torch.scripts import _measure
from leaf_tpu_torch.scripts.kernel_microbench import leaf_operands

FILTERS = 40


def op_fwdbwd(device, b: int, t: int, f: int, dtype: torch.dtype):
    """A callable: one fwd+bwd of the fused op on seeded operands."""
    from leaf_tpu_torch.ops.fused_frontend import fused_gabor_sqmod_lowpass
    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.randn(b, t) * 0.1).astype(np.float32))
    x = x.to(device).to(dtype)
    bank, windows = leaf_operands(device, f)
    g = bank.to(dtype).requires_grad_()
    w = windows.clone().requires_grad_()

    def call():
        return torch.autograd.grad(
            (fused_gabor_sqmod_lowpass(x, g, w) ** 2).sum(), (g, w))
    return call


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m leaf_tpu_torch.scripts.kernel_profile",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--clip_seconds", type=float, default=1.0)
    ap.add_argument("--execs", type=int, default=4)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (the default) or cpu (plain versions, no "
                         "device metric)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = _measure.open_device(args.device, "kernel_profile")
    if device is None:
        return 1
    dtype = torch.float32 if args.f32 else torch.bfloat16
    call = op_fwdbwd(device, args.batch, int(16000 * args.clip_seconds),
                     FILTERS, dtype)
    for _ in range(4):
        call()
    prof = None
    if device.type == "cuda":
        prof = _measure.device_profile(call, args.execs, device=device)
        for name, count, ms in prof.rows[:args.top]:
            print(f"{ms:9.3f} ms  x{count:5.1f}  {name[:110]}")
    else:
        print("device time not measured on the CPU")
    _measure.emit({
        "metric": "kernel_profile", "batch": args.batch,
        "clip_seconds": args.clip_seconds, "filters": FILTERS,
        "dtype": "f32" if args.f32 else "bf16", "execs": args.execs,
        "device_busy_ms": prof.busy_ms if prof else None,
        "idle_share": prof.idle if prof else None,
        "frontend_kernel_ms": prof.ms("fused_fwd", "fused_bwd")
        if prof and prof.busy_ms else None,
        "rows": [{"name": n, "count": c, "ms": m}
                 for n, c, m in prof.rows[:args.top]] if prof else [],
        **_measure.card(device)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
