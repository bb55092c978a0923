"""A/B: the depthwise convolutions' memory layout (NCHW against
channels-last) and the backward's split into dx and dw, the counterpart
of the JAX repo's ``scripts/dw_layout_ab.py``.

For every depthwise site of EfficientNet-b0 at the flagship input
(``dw_ab.B0_DW_SHAPES``, B=256) it times with CUDA events, f32 and
bf16:

- forward and fwd+bwd (dx and dw) in NCHW, the port's layout, and with
  x, w and dY in ``torch.channels_last`` (does cuDNN take the depthwise
  weight gradient there, where NCHW runs PyTorch's native kernel?);
- fwd+dx only and fwd+dw only in NCHW: the backward's attribution.

    python -m leaf_tpu_torch.scripts.dw_layout_ab [--batch 256]
        [--iters 20] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

import torch

from leaf_tpu_torch.scripts import _measure
from leaf_tpu_torch.scripts.dw_ab import (B0_DW_SHAPES, dw_conv, grads,
                                          operands)

COLS = ("nchw_fwd", "cl_fwd", "nchw_fwdbwd", "cl_fwdbwd", "nchw_fwd_dx",
        "nchw_fwd_dw")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m leaf_tpu_torch.scripts.dw_layout_ab",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (the default) or cpu (no device metric)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = _measure.open_device(args.device, "dw_layout_ab")
    if device is None:
        return 1
    timed = _measure.event_timer(device, args.iters)
    cl = torch.channels_last
    out = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        rows, total = [], {c: 0.0 for c in COLS}
        print(f"{'shape (H, W, C, k, s)':>26} " + " ".join(
            f"{c:>12}" for c in COLS) + f"   (ms, B={args.batch}, {tag})")
        for i, shape in enumerate(B0_DW_SHAPES):
            x, w, dy = operands(shape, args.batch, dtype, device, seed=i)
            xc, wc, dyc = (t.contiguous(memory_format=cl) for t in (x, w, dy))
            s = shape[4]
            with torch.no_grad():
                r = {"nchw_fwd": timed(lambda: dw_conv(x, w, s)),
                     "cl_fwd": timed(lambda: dw_conv(xc, wc, s))}
            r["nchw_fwdbwd"] = timed(lambda: grads(dw_conv, x, w, dy, s))
            r["cl_fwdbwd"] = timed(lambda: grads(dw_conv, xc, wc, dyc, s))
            r["nchw_fwd_dx"] = timed(lambda: grads(dw_conv, x, w, dy, s,
                                                   (True, False)))
            r["nchw_fwd_dw"] = timed(lambda: grads(dw_conv, x, w, dy, s,
                                                   (False, True)))
            for c in COLS:
                total[c] = (None if r[c] is None or total[c] is None
                            else total[c] + r[c] * shape[5])
            rows.append({"shape": list(shape[:5]), "repeats": shape[5], **r})
            print(f"{str(shape[:5]):>26} " + " ".join(
                f"{'n/a' if r[c] is None else round(r[c], 4):>12}"
                for c in COLS) + (f"  x{shape[5]}" if shape[5] > 1 else ""))
        print(f"{'TOTAL (x repeats)':>26} " + " ".join(
            f"{'n/a' if total[c] is None else round(total[c], 4):>12}"
            for c in COLS))
        out[tag] = {"shapes": rows, "total": total}
    _measure.emit({"metric": "dw_layout_ab", "batch": args.batch,
                   "iters": args.iters, **out, **_measure.card(device)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
