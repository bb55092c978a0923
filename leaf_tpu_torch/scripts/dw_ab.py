"""A/B: cuDNN's grouped conv2d against a shift-multiply formulation of
EfficientNet-b0's depthwise convolutions, the counterpart of the JAX
repo's ``scripts/dw_ab.py``.

A depthwise conv is k·k shifted elementwise multiply-adds; autograd of
that form gives dx as shifted pads and dw as k·k multiply-reduces. For
every depthwise site of b0 at the flagship input (B=256, 1 s at 16 kHz →
the (100, 40) spectrogram; ``B0_DW_SHAPES``, NCHW as the port runs them,
TF-SAME padding) this times both, forward and fwd+bwd (dx and dw for a
fixed dY), in f32 and bf16, with CUDA events (``--iters`` launches after
a warm-up), and the totals over the sites × their repeats. Each shape's
two forms are first held equal on 8 clips in f32 (forward, dx and dw to
1e-4 absolute + 1e-3 relative, the JAX script's check).

    python -m leaf_tpu_torch.scripts.dw_ab [--batch 256] [--iters 20]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
import torch.nn.functional as F

from leaf_tpu_torch.scripts import _measure

# (H, W, C, k, stride, repeats): every depthwise site of EfficientNet-b0
# at the (100, 40) input (25 ms windows at a 10 ms hop → 100 frames, 40
# filters), the stem's stride 2 applied
B0_DW_SHAPES = (
    (50, 20, 32, 3, 1, 1),    # block 1
    (50, 20, 96, 3, 2, 1),    # block 2 reduce
    (25, 10, 144, 3, 1, 1),   # block 2
    (25, 10, 144, 5, 2, 1),   # block 3 reduce
    (13, 5, 240, 5, 1, 1),    # block 3
    (13, 5, 240, 3, 2, 1),    # block 4 reduce
    (7, 3, 480, 3, 1, 2),     # block 4
    (7, 3, 480, 5, 1, 1),     # block 5 reduce (stride 1)
    (7, 3, 672, 5, 1, 2),     # block 5
    (7, 3, 672, 5, 2, 1),     # block 6 reduce
    (4, 2, 1152, 5, 1, 3),    # block 6
    (4, 2, 1152, 3, 1, 1),    # block 7
)


def same_pads(size: int, k: int, stride: int):
    """TF-SAME padding (before, after) of one spatial axis."""
    out = -(-size // stride)
    pad = max(0, (out - 1) * stride + k - size)
    return pad // 2, pad - pad // 2


def _pad(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    ph = same_pads(x.shape[2], k, stride)
    pw = same_pads(x.shape[3], k, stride)
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]))


def dw_conv(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """The port's depthwise conv: TF-SAME pad, then cuDNN's grouped
    conv2d; x (B, C, H, W), w (C, 1, k, k)."""
    return F.conv2d(_pad(x, w.shape[-1], stride), w, stride=stride,
                    groups=x.shape[1])


def dw_shift(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """Shift-multiply: y = Σ_{i,j} w[c, i, j] · x_pad[..., i::s, j::s],
    summed in f32, returned at x's dtype."""
    b, c, h, wd = x.shape
    k = w.shape[-1]
    xp = _pad(x, k, stride)
    oh, ow = -(-h // stride), -(-wd // stride)
    acc = torch.zeros((b, c, oh, ow), device=x.device, dtype=torch.float32)
    for i in range(k):
        for j in range(k):
            sl = xp[:, :, i:i + (oh - 1) * stride + 1:stride,
                    j:j + (ow - 1) * stride + 1:stride]
            wij = w[:, 0, i, j].float()[None, :, None, None]
            acc = acc + sl.float() * wij
    return acc.to(x.dtype)


def operands(shape, batch: int, dtype, device, seed: int):
    """Seeded (x, w, dY) of one site."""
    h, wd, c, k, s, _ = shape
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(batch, c, h, wd).astype(np.float32))
    w = torch.from_numpy((rng.randn(c, 1, k, k) * 0.1).astype(np.float32))
    dy = torch.from_numpy(rng.randn(batch, c, -(-h // s), -(-wd // s))
                          .astype(np.float32))
    return (t.to(device=device, dtype=dtype) for t in (x, w, dy))


def grads(impl, x, w, dy, stride, wrt=(True, True)):
    """(y, dx, dw) of ``impl`` for the cotangent ``dy``; dx / dw None
    where ``wrt`` leaves them out."""
    xr = x.detach().requires_grad_(wrt[0])
    wr = w.detach().requires_grad_(wrt[1])
    y = impl(xr, wr, stride)
    want = [t for t, on in ((xr, wrt[0]), (wr, wrt[1])) if on]
    got = iter(torch.autograd.grad(y, want, dy))
    return (y, next(got) if wrt[0] else None, next(got) if wrt[1] else None)


def check_parity(shape, device, batch: int = 8, atol: float = 1e-4,
                 rtol: float = 1e-3) -> None:
    """``dw_shift`` against ``dw_conv`` at one site in f32: y, dx, dw."""
    x, w, dy = operands(shape, batch, torch.float32, device, seed=1)
    s = shape[4]
    for a, b, what in zip(grads(dw_conv, x, w, dy, s),
                          grads(dw_shift, x, w, dy, s), ("y", "dx", "dw")):
        torch.testing.assert_close(b, a, atol=atol, rtol=rtol,
                                   msg=f"{what} at {shape}")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m leaf_tpu_torch.scripts.dw_ab",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (the default) or cpu (no device metric)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = _measure.open_device(args.device, "dw_ab")
    if device is None:
        return 1
    timed = _measure.event_timer(device, args.iters)
    cols = ("conv_fwd", "shift_fwd", "conv_fwdbwd", "shift_fwdbwd")
    out = {}
    for shape in B0_DW_SHAPES:
        check_parity(shape, device)
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        rows, total = [], {c: 0.0 for c in cols}
        print(f"{'shape (H, W, C, k, s)':>26} " + " ".join(
            f"{c:>12}" for c in cols) + f"   (ms, B={args.batch}, {tag})")
        for i, shape in enumerate(B0_DW_SHAPES):
            x, w, dy = operands(shape, args.batch, dtype, device, seed=i)
            s = shape[4]
            with torch.no_grad():
                r = {"conv_fwd": timed(lambda: dw_conv(x, w, s)),
                     "shift_fwd": timed(lambda: dw_shift(x, w, s))}
            r["conv_fwdbwd"] = timed(lambda: grads(dw_conv, x, w, dy, s))
            r["shift_fwdbwd"] = timed(lambda: grads(dw_shift, x, w, dy, s))
            for c in cols:
                total[c] = (None if r[c] is None or total[c] is None
                            else total[c] + r[c] * shape[5])
            rows.append({"shape": list(shape[:5]), "repeats": shape[5], **r})
            print(f"{str(shape[:5]):>26} " + " ".join(
                f"{'n/a' if r[c] is None else round(r[c], 4):>12}"
                for c in cols) + (f"  x{shape[5]}" if shape[5] > 1 else ""))
        print(f"{'TOTAL (x repeats)':>26} " + " ".join(
            f"{'n/a' if total[c] is None else round(total[c], 4):>12}"
            for c in cols))
        out[tag] = {"shapes": rows, "total": total}
    _measure.emit({"metric": "dw_ab", "batch": args.batch,
                   "iters": args.iters, **out, **_measure.card(device)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
