"""Micro-bench of the fused frontend on the card, the counterpart of the
JAX repo's ``scripts/kernel_microbench.py``.

Times, CUDA events (``--iters`` launches after a warm-up), TF32 off:

- the fused op forward alone, and fwd+bwd (its autograd function), f32
  and bf16 (``op_fwd_f32`` … ``op_fwdbwd_bf16``);
- the whole Leaf forward, and fwd+bwd, f32 and bf16 (``leaf_fwd_f32`` …),
  so PCEN's, the filter generation's and the backward's shares separate;
- each of the six kernels alone (``fwd``, ``fwd_save``, ``bwd`` and their
  ``_bf16``), beside its bound (``_measure.bound`` of
  ``_measure.frontend_work``: the work of the function at that shape,
  whatever implements it), its share of the bound, and the cuDNN
  composition of the same function (conv1d → |·|² → grouped strided
  conv1d, its autograd backward for the backward) in the kernel's dtype;
  with ``--plain`` also its plain PyTorch version (off by default: the
  plain version's time is no yardstick).

``--shape flagship`` is B=256, T=16000, F=40; ``audioset`` B=128,
T=80000, F=64 (the AudioSet ResNet-18 cfg). ``--batch`` and
``--clip_seconds`` override B and T.

    python -m leaf_tpu_torch.scripts.kernel_microbench [--shape flagship]
        [--iters 20] [--plain] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
import numpy as np
import torch
import torch.nn.functional as F

from leaf_tpu_torch.scripts import _measure

SHAPES = {"flagship": (256, 16000, 40), "audioset": (128, 80000, 64)}


def leaf_operands(device, n_filters: int):
    """(bank, windows) of a Leaf of ``n_filters`` at its mel init."""
    from leaf_tpu_torch.frontend import Leaf
    leaf = Leaf(n_filters=n_filters, device=device)
    with torch.no_grad():
        bank = leaf._complex_conv.emit_filters().contiguous()
        windows = leaf._pooling.emit_windows()[0].contiguous()
    return bank, windows


def kernel_timings(device, b: int, t: int, f: int, iters: int = 20,
                   plain: bool = False, log=print, tag: str = "") -> dict:
    """Each kernel (f32 and bf16) at (B, T, F) = (b, t, f): its ms (CUDA
    events over ``iters`` launches), bound, share, the cuDNN composition's
    ms (``library_ms``) and, with ``plain``, its plain version's ms
    (``plain_ms``; None otherwise). On the CPU the plain versions run in
    the kernels' place once each and every time is None."""
    from leaf_tpu_torch.ops import fused_frontend as ff
    cuda = device.type == "cuda"
    timed = _measure.event_timer(device, iters)
    bank, windows = leaf_operands(device, f)
    rng = np.random.RandomState(2)
    x = torch.from_numpy((rng.randn(b, t) * 0.1).astype(np.float32)).to(device)
    n_frames = ff.lowpass_frames_out(t, 160, 401, (200, 200))
    d_out = torch.from_numpy(
        rng.randn(b, n_frames, f).astype(np.float32)).to(device)
    kernel = {  # the plain versions stand in on the CPU
        "fwd": (ff.fused_forward_cuda, ff.fused_forward_bf16_cuda,
                ff.fused_reference),
        "fwd_save": (ff.fused_forward_saving_cuda,
                     ff.fused_forward_saving_bf16_cuda,
                     ff.fused_forward_saving_reference),
        "bwd": (ff.fused_backward_cuda, ff.fused_backward_bf16_cuda,
                ff.fused_backward_reference)}
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        bf16 = dtype == torch.bfloat16
        sfx = "_bf16" if bf16 else ""
        xd, bankd = x.to(dtype), bank.to(dtype)
        weight = bankd.T[:, None, :].contiguous()
        win = windows[:, None, :].to(dtype).contiguous()

        def library(w=weight, wn=win, xd=xd):
            # cuDNN: conv1d → |·|² → grouped strided conv1d (at the dtype:
            # it rounds the conv output and S where the bf16 kernels keep
            # them in f32; not the same rounding, the same work)
            out = F.conv1d(xd[:, None, :], w, padding=200)
            s = out[:, :f] ** 2 + out[:, f:] ** 2
            return F.conv1d(s, wn, stride=160, padding=200, groups=f)

        def fn(kind):
            return kernel[kind][1 if bf16 else 0] if cuda else kernel[kind][2]

        fwd_lib = timed(library)
        _, conv = (fn("fwd_save") if cuda else kernel["fwd_save"][2])(
            xd, bankd, windows)
        wr, wnr = weight.clone().requires_grad_(), win.clone().requires_grad_()
        lib_out = library(wr, wnr)
        d_lib = d_out.to(dtype).transpose(1, 2)
        calls = {"fwd": (lambda: fn("fwd")(xd, bankd, windows), fwd_lib),
                 "fwd_save": (lambda: fn("fwd_save")(xd, bankd, windows),
                              fwd_lib),
                 "bwd": (lambda: fn("bwd")(xd, conv, windows, d_out),
                         timed(lambda: torch.autograd.grad(
                             lib_out, (wr, wnr), d_lib, retain_graph=True)))}
        for kind, (call, lib_ms) in calls.items():
            ms = timed(call)
            bnd = _measure.bound(**_measure.frontend_work(b, t, f, dtype,
                                                          kind))
            results[kind + sfx] = {
                "ms": ms,
                "plain_ms": timed(lambda k=kind: kernel[k][2](
                    *((xd, conv, windows, d_out) if k == "bwd"
                      else (xd, bankd, windows)))) if plain else None,
                "library_ms": lib_ms, **bnd,
                "share": bnd["bound_ms"] / ms if ms else None}
        del conv, lib_out, xd
        if cuda:
            torch.cuda.empty_cache()
    for name, r in results.items():
        w = _measure.frontend_work(b, t, f, torch.bfloat16 if "bf16" in name
                                   else torch.float32, name.split("_bf16")[0])
        line = (f"{tag}{name} kernel B={b} T={t} F={f}: "
                f"{_fmt(r['ms'])} ms ({_pct(r['share'])} of the "
                f"{r['bound_by']} bound {r['bound_ms']:.4f} ms); cuDNN "
                f"composition (library) {_fmt(r['library_ms'])} ms")
        if plain:
            line += f"; plain version {_fmt(r['plain_ms'])} ms"
        if "bf16" not in name:
            # the f32-FMA bound any CUDA-core design has: the correlation
            # once, in f32, on the CUDA cores
            fma = _measure.bound(w["flops"] + w["tc_flops"] / 3,
                                 w["nbytes"])["bound_ms"]
            line += (f"; f32-FMA bound {fma:.4f} ms ("
                     f"{_pct(fma / r['ms'] if r['ms'] else None)})")
        log(line + f" ({iters} launches each)")
    return results


def _fmt(v) -> str:
    return "not measured" if v is None else f"{v:.4f}"


def _pct(v) -> str:
    return "n/a" if v is None else f"{v:.1%}"


def op_and_leaf_rows(device, b: int, t: int, f: int, iters: int) -> dict:
    """ms per call (and clips/s) of the fused op forward and fwd+bwd (sum
    of out², gradients of the bank and the windows) and of the whole Leaf
    forward and fwd+bwd (sum of features², gradients of its parameters),
    f32 and bf16: {"op_fwd_f32": {"ms", "clips_per_sec"}, ...}."""
    from leaf_tpu_torch.frontend import Leaf
    from leaf_tpu_torch.ops.fused_frontend import fused_gabor_sqmod_lowpass
    timed = _measure.event_timer(device, iters)
    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.randn(b, t) * 0.1).astype(np.float32)).to(device)
    bank, windows = leaf_operands(device, f)
    rows = {}
    for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        xd = x.to(dtype)
        g = bank.to(dtype).clone().requires_grad_()
        w = windows.clone().requires_grad_()

        def op_fwd():
            with torch.no_grad():
                return fused_gabor_sqmod_lowpass(xd, g, w)

        def op_fwdbwd():
            return torch.autograd.grad(
                (fused_gabor_sqmod_lowpass(xd, g, w) ** 2).sum(), (g, w))

        leaf = Leaf(n_filters=f, compute_dtype=dtype, device=device)
        params = [p for p in leaf.parameters() if p.requires_grad]

        def leaf_fwd():
            with torch.no_grad():
                return leaf(x)

        def leaf_fwdbwd():
            return torch.autograd.grad((leaf(x).float() ** 2).sum(), params)

        for name, fn in (("op_fwd", op_fwd), ("op_fwdbwd", op_fwdbwd),
                         ("leaf_fwd", leaf_fwd),
                         ("leaf_fwdbwd", leaf_fwdbwd)):
            ms = timed(fn)
            rows[f"{name}_{tag}"] = {
                "ms": ms, "clips_per_sec": b / ms * 1e3 if ms else None}
    return rows


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m leaf_tpu_torch.scripts.kernel_microbench",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--shape", choices=sorted(SHAPES), default="flagship")
    ap.add_argument("--batch", type=int, default=None,
                    help="override the shape's batch")
    ap.add_argument("--clip_seconds", type=float, default=None,
                    help="override the shape's clip length (16 kHz)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--plain", action="store_true",
                    help="also time each kernel's plain PyTorch version")
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (the default) or cpu (plain versions, no "
                         "device metric)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = _measure.open_device(args.device, "kernel_microbench")
    if device is None:
        return 1
    b, t, f = SHAPES[args.shape]
    b = args.batch or b
    t = int(16000 * args.clip_seconds) if args.clip_seconds else t
    rows = op_and_leaf_rows(device, b, t, f, args.iters)
    for name, r in rows.items():
        rate = r["clips_per_sec"]
        print(f"{name:16s} {_fmt(r['ms'])} ms/step   "
              f"({'n/a' if rate is None else round(rate, 1)} clips/s)")
    kernels = kernel_timings(device, b, t, f, iters=args.iters,
                             plain=args.plain)
    _measure.emit({"metric": "kernel_microbench", "shape": args.shape,
                   "batch": b, "samples": t, "filters": f,
                   "iters": args.iters, **rows, "kernels": kernels,
                   **_measure.card(device)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
