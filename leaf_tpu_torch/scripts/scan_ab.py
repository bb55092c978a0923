"""A/B: one train step per call against K steps per call as one CUDA
graph, the counterpart of the JAX repo's ``scripts/scan_ab.py`` (its
``lax.scan`` of K steps in one program is ``TrainMultistep`` here: K
steps captured once, then replayed with one launch from the host).

For each K of ``--ks`` (default 1, 4, 8, 16; K = 1 is the eager
``make_train_step``) the flagship train step (Leaf + EfficientNet-b0,
B=256, bf16 unless ``--f32``, augment, dropout and drop-connect on) runs
``--steps`` steps per measurement, ``--reps`` times: the host-clock ms
per step (median of the calls, each ending in a synchronize; the best
of the reps), clips/s, and on the card the device-busy ms per step and
the idle share (torch.profiler, one call), the fused frontend kernels'
device ms per step, and the graph's memory pool. One JSON line.

    python -m leaf_tpu_torch.scripts.scan_ab [--steps 48] [--batch 256]
        [--ks 1 4 8 16] [--reps 2] [--f32] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from leaf_tpu_torch.scripts import _measure
from leaf_tpu_torch.scripts.step_profile import (SR, flagship_cfg, stacked,
                                                 trainer)


def multistep_timing(cfg: dict, state: dict, device, ks=(1, 4, 8),
                     calls: int = 12, reps: int = 1, batch: int = 256,
                     pg=None, log=print, tag: str = "") -> dict:
    """For each K of ``ks``: {"ms" (host-clock ms per step, the best of
    ``reps`` medians of ``calls`` calls after 3), "runs", "busy_ms",
    "idle", "frontend_ms" (device ms per step; None off the card),
    "pool_bytes"} of ``cfg``'s train step from the weights ``state`` at
    ``batch`` clips (K = 1: eager ``make_train_step``; K > 1: a graph);
    with a process group ``pg`` the data-parallel step, and its
    collectives per step (c10d calls and their host ms, NCCL kernels and
    their device ms)."""
    from leaf_tpu_torch.data import leaf_device_augment
    from leaf_tpu_torch.training import make_train_multistep
    cuda = torch.device(device).type == "cuda"
    out = {}
    for k in ks:
        st, step = trainer(cfg, state, device, capturable=k > 1 and cuda,
                           pg=pg)
        gen = torch.Generator(device=device).manual_seed(17)
        xs, ys = stacked(np.random.RandomState(17), k, batch, SR, device)
        multi = None
        if k == 1:
            def call(st=st, step=step, gen=gen, xs=xs, ys=ys):
                step(st, xs[0], ys[0], gen)
        else:
            multi = make_train_multistep(k, augment_fn=leaf_device_augment,
                                         process_group=pg)

            def call(st=st, multi=multi, gen=gen, xs=xs, ys=ys):
                multi(st, xs, ys, gen)
        runs, times = [], []
        for rep in range(reps):
            t = _measure.host_times_ms(call, calls, device,
                                       warmup=3 if rep == 0 else 0, per=k)
            runs.append(float(np.median(t)))
            times += t
        med = min(runs)
        prof = (_measure.device_profile(call, 1, host_ms=med, per=k)
                if cuda else None)
        busy = prof.busy_ms if prof else None
        front = prof.ms("fused_fwd", "fused_bwd") if busy else None
        pool = multi.pool_bytes if multi is not None else 0
        out[k] = {"ms": med, "runs": runs, "clips_per_sec": batch / med * 1e3,
                  "busy_ms": busy, "idle": prof.idle if prof else None,
                  "frontend_ms": front, "pool_bytes": pool}
        if pg is not None and cuda:
            n_calls, n, dev_ms, host_ms = _measure.collectives(call)
            out[k].update(collectives=n_calls / k, nccl_kernels=n / k,
                          collective_ms=dev_ms / k,
                          collective_host_ms=host_ms / k)
            log(f"{tag} K={k}: collectives per step: {n_calls / k:g} c10d "
                f"calls ({host_ms / k:.3f} host ms; a replay makes none), "
                f"{n / k:g} NCCL kernels ({dev_ms / k:.3f} device ms)")
        dev = ("device time not measured" if busy is None else
               f"device busy {busy:.3f} ms/step, idle {prof.idle:.1%}; "
               f"frontend kernels {front:.3f} ms/step ({front / busy:.1%} "
               f"of busy)")
        log(f"{tag} timing K={k} ({'eager' if k == 1 else 'graph'}): "
            f"median {med:.3f} ms/step ({batch / med * 1e3:.1f} clips/s), "
            f"min {min(times):.3f}, max {max(times):.3f} ({calls} calls "
            f"after 3, host clock{f', best of {reps}' if reps > 1 else ''})"
            f"; {dev}; graph pool {pool / 2**30:.2f} GiB")
        del st, step, call, multi
        if cuda:
            torch.cuda.empty_cache()
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m leaf_tpu_torch.scripts.scan_ab",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=48)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--ks", type=int, nargs="+", default=[1, 4, 8, 16])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--arch", type=str, default="efficientnet:b0")
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (the default) or cpu (no device metric)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = _measure.open_device(args.device, "scan_ab")
    if device is None:
        return 1
    from leaf_tpu_torch.models import Classifier
    cfg = flagship_cfg(not args.f32, args.arch)
    state = Classifier(cfg, device=device,
                       generator=torch.Generator().manual_seed(0)).state_dict()
    res = {}
    for k in args.ks:
        r = multistep_timing(cfg, state, device, (k,),
                             calls=max(1, args.steps // k), reps=args.reps,
                             batch=args.batch, log=lambda s: None)[k]
        print(f"K={k:3d}: {r['ms']:7.2f} ms/step {r['clips_per_sec']:9.0f} "
              f"clips/s   (runs: {', '.join(f'{v:.2f}' for v in r['runs'])}"
              f" ms/step)")
        res[str(k)] = {"ms_per_step": r["ms"], "runs_ms": r["runs"],
                       "clips_per_sec": r["clips_per_sec"],
                       "busy_ms_per_step": r["busy_ms"],
                       "idle_share": r["idle"],
                       "frontend_ms_per_step": r["frontend_ms"],
                       "pool_bytes": r["pool_bytes"]}
    _measure.emit({"metric": "scan_ab", "batch": args.batch,
                   "dtype": "f32" if args.f32 else "bf16", "arch": args.arch,
                   "steps": args.steps, "ks": res, **_measure.card(device)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
