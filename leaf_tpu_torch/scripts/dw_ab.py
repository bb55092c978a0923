"""A/B: the native grouped conv2d against a shift-multiply formulation of
EfficientNet-b0's depthwise convolutions, the counterpart of the JAX
repo's ``scripts/dw_ab.py``, and the port's depthwise kernels
(``ops/depthwise.py``) beside the native conv.

A depthwise conv is k·k shifted elementwise multiply-adds; autograd of
that form gives dx as shifted pads and dw as k·k multiply-reduces. For
every depthwise site of b0 at the flagship input (B=256, 1 s at 16 kHz →
the classifier's (40, 100) image, filters × frames; ``B0_DW_SHAPES``, NCHW
as the port runs them, TF-SAME padding) this times both, forward and
fwd+bwd (dx and dw for a fixed dY), in f32 and bf16, with CUDA events
(``--iters`` launches after a warm-up), and the totals over the sites ×
their repeats. Each shape's
two forms are first held equal on 8 clips in f32 (forward, dx and dw to
1e-4 absolute + 1e-3 relative, the JAX script's check).

The kernels' table gives each pass at each site on its own: the forward
(``fwd``),
the input gradient (``dx``) and the weight gradient (``dw``) of the
kernels (``kernel_*``) and of the native conv (``native_*``: F.pad and
the grouped conv2d; the conv's input gradient and the pad's backward;
the conv's weight gradient on the padded x), in device-busy ms per call
(torch.profiler, ``--iters`` calls: the small sites' launches outrun the
card, so CUDA events would time the host), beside the pass's bytes bound
(``bound``: x and y, or dy and dx, or x and dy, once each at 3.35 TB/s)
and the kernels' share of it. The kernels take f32 operands: the bf16
table times them on the operands widened to f32, as the port's bf16 mode
runs them (``Conv2d._operands``).

    python -m leaf_tpu_torch.scripts.dw_ab [--batch 256] [--iters 20]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch
import torch.nn.functional as F

from leaf_tpu_torch.ops import depthwise
from leaf_tpu_torch.scripts import _measure

# (H, W, C, k, stride, repeats): every depthwise site of EfficientNet-b0
# as the classifier runs it, on its (40, 100) image (40 filters × 100
# frames: 25 ms windows at a 10 ms hop), the stem's stride 2 applied
B0_DW_SHAPES = (
    (20, 50, 32, 3, 1, 1),    # block 1
    (20, 50, 96, 3, 2, 1),    # block 2 reduce
    (10, 25, 144, 3, 1, 1),   # block 2
    (10, 25, 144, 5, 2, 1),   # block 3 reduce
    (5, 13, 240, 5, 1, 1),    # block 3
    (5, 13, 240, 3, 2, 1),    # block 4 reduce
    (3, 7, 480, 3, 1, 2),     # block 4
    (3, 7, 480, 5, 1, 1),     # block 5 reduce (stride 1)
    (3, 7, 672, 5, 1, 2),     # block 5
    (3, 7, 672, 5, 2, 1),     # block 6 reduce
    (2, 4, 1152, 5, 1, 3),    # block 6
    (2, 4, 1152, 3, 1, 1),    # block 7
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


KERNEL_COLS = ("kernel_fwd", "native_fwd", "kernel_dx", "native_dx",
               "kernel_dw", "native_dw")


def busy_timer(device, iters: int):
    """``busy(fn)``: on the card the device-busy ms per call of ``iters``
    calls under torch.profiler, each kernel's mean time a launch times its
    launches a call (a session past a process's eighth can lose its first
    kernel row, PERF.md §6); on the CPU one call (its path runs) and None
    (no device time)."""
    if torch.device(device).type == "cuda":
        def busy(fn):
            fn()
            rows = _measure.device_profile(fn, n=iters).rows
            return sum(ms / count * math.ceil(count - 1e-9)
                       for _, count, ms in rows if count)
        return busy

    def once(fn):
        fn()
        return None
    return once


def kernel_passes(x, w, dy, stride: int, busy) -> dict:
    """Each pass of the port's kernels and of the native conv on f32
    operands (x, w and dy widened), timed by ``busy``."""
    x, w, dy = x.float(), w.float(), dy.float()
    k = w.shape[-1]
    xp = _pad(x, k, stride)
    if x.is_cuda:
        fwd = lambda: depthwise.depthwise_forward_cuda(x, w, stride)  # noqa: E731
        dx = lambda: depthwise.depthwise_dgrad_cuda(x, w, dy, stride)  # noqa: E731
        dw = lambda: depthwise.depthwise_wgrad_cuda(x, w, dy, stride)  # noqa: E731
    else:  # the ops' plain versions: the path runs, nothing is timed
        fwd = lambda: depthwise.depthwise_fwd_op(x, w, stride)  # noqa: E731
        dx = lambda: depthwise.depthwise_bwd_op(  # noqa: E731
            x, w, dy, stride, True, False)
        dw = lambda: depthwise.depthwise_bwd_op(  # noqa: E731
            x, w, dy, stride, False, True)
    return {
        "kernel_fwd": busy(fwd),
        "native_fwd": busy(lambda: dw_conv(x, w, stride)),
        "kernel_dx": busy(dx),
        "native_dx": busy(lambda: depthwise.depthwise_backward_reference(
            x, w, dy, stride, True, False)),
        "kernel_dw": busy(dw),
        # autograd's weight gradient reads the x it padded in the forward
        "native_dw": busy(lambda: torch.ops.aten.convolution_backward(
            dy, xp, w, None, [stride, stride], [0, 0], [1, 1], False, [0, 0],
            x.shape[1], [False, True, False])),
    }


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


def _share(bound, ms):
    return "n/a" if ms is None else f"{bound / ms:.1%}"


def _print_passes(rows, total, batch: int, tag: str) -> None:
    """The kernels' and the native conv's passes, each site and the
    totals, against the bytes bound."""
    print(f"{'site (H, W, C, k, s)':>26} " + " ".join(
        f"{c:>11}" for c in KERNEL_COLS + ("bound_ms",))
        + f"  kernel share of bound fwd/dx/dw   (device-busy ms, B={batch}, "
        f"{tag}: f32 kernels)")
    for row in rows + [dict(total, shape="TOTAL (x repeats)")]:
        print(f"{str(row['shape']):>26} " + " ".join(
            f"{'n/a' if row[c] is None else round(row[c], 4):>11}"
            for c in KERNEL_COLS + ("bound_ms",)) + "  " + " / ".join(
                _share(row["bound_ms"], row[c])
                for c in ("kernel_fwd", "kernel_dx", "kernel_dw")))


def main(argv=None) -> int:
    args = parse_args(argv)
    device = _measure.open_device(args.device, "dw_ab")
    if device is None:
        return 1
    timed = _measure.event_timer(device, args.iters)
    busy = busy_timer(device, args.iters)
    cols = ("conv_fwd", "shift_fwd", "conv_fwdbwd", "shift_fwdbwd")
    out = {}
    for shape in B0_DW_SHAPES:
        check_parity(shape, device)
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        rows, total, bound = [], {c: 0.0 for c in cols + KERNEL_COLS}, 0.0
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
            h, wd, c, k = shape[:4]
            r.update(kernel_passes(x, w, dy, s, busy))
            r["bound_ms"] = (depthwise.pass_bytes(args.batch, c, h, wd, k, s)
                             / _measure.HBM_BYTES_PER_S * 1e3)
            bound += r["bound_ms"] * shape[5]
            for col in total:
                total[col] = (None if r[col] is None or total[col] is None
                              else total[col] + r[col] * shape[5])
            rows.append({"shape": list(shape[:5]), "repeats": shape[5], **r})
            print(f"{str(shape[:5]):>26} " + " ".join(
                f"{'n/a' if r[c] is None else round(r[c], 4):>12}"
                for c in cols) + (f"  x{shape[5]}" if shape[5] > 1 else ""))
        print(f"{'TOTAL (x repeats)':>26} " + " ".join(
            f"{'n/a' if total[c] is None else round(total[c], 4):>12}"
            for c in cols))
        _print_passes(rows, dict(total, bound_ms=bound), args.batch, tag)
        out[tag] = {"shapes": rows, "total": total, "bound_ms": bound}
    _measure.emit({"metric": "dw_ab", "batch": args.batch,
                   "iters": args.iters, **out, **_measure.card(device)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
