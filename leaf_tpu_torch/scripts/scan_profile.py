"""Profile-based A/B of one train step per call against K steps per call
as one CUDA graph, the counterpart of the JAX repo's
``scripts/scan_profile.py``.

For the eager step (``make_train_step``) and the K-step graph
(``make_train_multistep``, capturable Adam) of the flagship (Leaf +
EfficientNet-b0, B=256, bf16 unless ``--f32``, augment, dropout and
drop-connect on) it reports, per optimizer step: the device-busy ms
(torch.profiler's kernel rows), the host-clock ms (calls ending in a
synchronize), the idle share and the kernels per step; then each
kernel's device ms per step in both and the delta (graph − eager),
largest first: where the graph's extra device time goes.

    python -m leaf_tpu_torch.scripts.scan_profile [--batch 256] [--k 8]
        [--steps 8] [--top 25] [--f32] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from leaf_tpu_torch.scripts import _measure
from leaf_tpu_torch.scripts.step_profile import (SR, flagship_cfg,
                                                 measure_program, stacked,
                                                 trainer)


def kernel_deltas(single: _measure.DeviceProfile,
                  multi: _measure.DeviceProfile) -> list:
    """[{name, eager_ms, graph_ms, delta_ms, eager_count, graph_count}] per
    step, by the size of the delta."""
    a = {n: (c, m) for n, c, m in single.rows}
    b = {n: (c, m) for n, c, m in multi.rows}
    rows = [{"name": n, "eager_ms": a.get(n, (0, 0.0))[1],
             "graph_ms": b.get(n, (0, 0.0))[1],
             "delta_ms": b.get(n, (0, 0.0))[1] - a.get(n, (0, 0.0))[1],
             "eager_count": a.get(n, (0, 0.0))[0],
             "graph_count": b.get(n, (0, 0.0))[0]}
            for n in set(a) | set(b)]
    return sorted(rows, key=lambda r: -abs(r["delta_ms"]))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m leaf_tpu_torch.scripts.scan_profile",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--steps", type=int, default=8,
                    help="eager steps to profile (the graph: max(2, "
                         "steps // k) calls)")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--arch", type=str, default="efficientnet:b0")
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (the default) or cpu (no device metric)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = _measure.open_device(args.device, "scan_profile")
    if device is None:
        return 1
    from leaf_tpu_torch.data import leaf_device_augment
    from leaf_tpu_torch.models import Classifier
    from leaf_tpu_torch.training import make_train_multistep
    cfg = flagship_cfg(not args.f32, args.arch)
    state = Classifier(cfg, device=device,
                       generator=torch.Generator().manual_seed(0)).state_dict()
    xs, ys = stacked(np.random.RandomState(0), args.k, args.batch, SR, device)
    cuda = device.type == "cuda"

    st, step = trainer(cfg, state, device)
    gen = torch.Generator(device=device).manual_seed(1)
    single = measure_program(lambda: step(st, xs[0], ys[0], gen), device,
                             args.steps)
    del st, step
    st, _ = trainer(cfg, state, device, capturable=cuda)
    multi = make_train_multistep(args.k, augment_fn=leaf_device_augment)
    n_exec = max(2, args.steps // args.k)
    fused = measure_program(lambda: multi(st, xs, ys, gen), device, n_exec,
                            per=args.k)

    out = {}
    for name, m in (("single", single), ("multi", fused)):
        p = m["profile"]
        out[name] = {"busy_ms_per_step": p.busy_ms if p else None,
                     "wall_ms_per_step": m["wall_ms"],
                     "idle_share": p.idle if p else None,
                     "kernels_per_step": p.launches if p and p.busy_ms
                     else None}
        busy = "not measured" if not p or p.busy_ms is None else (
            f"{p.busy_ms:.3f} ms/step ({p.launches:.0f} kernels/step, idle "
            f"{p.idle:.1%})")
        print(f"{'single-step' if name == 'single' else f'K={args.k} graph'}"
              f": busy {busy}, host clock {m['wall_ms']:.3f} ms/step")
    deltas = []
    if cuda and single["profile"].busy_ms and fused["profile"].busy_ms:
        deltas = kernel_deltas(single["profile"], fused["profile"])
        d = fused["profile"].busy_ms - single["profile"].busy_ms
        print(f"\nper-step deltas (graph - eager): busy {d:+.3f} ms, host "
              f"clock {fused['wall_ms'] - single['wall_ms']:+.3f} ms")
        for r in deltas[:args.top]:
            print(f"  {r['delta_ms']:+8.3f} ms  eager {r['eager_ms']:.3f} "
                  f"(x{r['eager_count']:.1f}) graph {r['graph_ms']:.3f} "
                  f"(x{r['graph_count']:.1f})  {r['name'][:90]}")
    _measure.emit({
        "metric": "scan_profile", "batch": args.batch, "k": args.k,
        "dtype": "f32" if args.f32 else "bf16", "arch": args.arch, **out,
        "delta_busy_ms": (out["multi"]["busy_ms_per_step"]
                          - out["single"]["busy_ms_per_step"])
        if deltas else None,
        "delta_wall_ms": fused["wall_ms"] - single["wall_ms"],
        "pool_bytes": multi.pool_bytes if cuda else None,
        "kernel_deltas": deltas[:args.top], **_measure.card(device)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
