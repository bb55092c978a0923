"""Device profile of the whole train step, the counterpart of the JAX
repo's ``scripts/step_profile.py``.

Where ``kernel_profile`` dissects the fused frontend op only, this
profiles, in one process, the flagship's train step (Leaf +
EfficientNet-b0, B=256, bf16 unless ``--f32``, the device augment on),
the frontend's fwd+bwd alone and the inference forward, each over
``--steps`` calls, and prints for each the device ms per step by
category (``_measure.categorize``) and the top ``--top`` kernels, then
the cross-check step ≈ frontend + (backbone fwd+bwd + optimizer).
``--steps_per_call K`` profiles K steps per call as one CUDA graph.

The last line is the JSON record: ``step_busy_ms``,
``frontend_fwdbwd_busy_ms``, ``inference_busy_ms`` (device time per
step, torch.profiler), ``step_wall_ms`` (measured: the host-clock median
per step of calls ending in a synchronize, where the JAX script predicts
it), ``step_idle_share``, the categories, and the card.

    python -m leaf_tpu_torch.scripts.step_profile [--steps 8] [--batch 256]
        [--top 40] [--f32] [--arch efficientnet:b0] [--clip_seconds 1]
        [--steps_per_call 1] [--device cuda]
"""

from __future__ import annotations

import argparse
import itertools
import sys
from typing import Callable, Optional

import numpy as np
import torch

from leaf_tpu_torch.scripts import _measure

SR = 16000
N_CLASSES = 35
# the recipe's schedule: SpeechCommands' 84843 clips at B=256, 40 epochs
STEPS_PER_EPOCH, EPOCHS = 84843 // 256, 40


def flagship_cfg(bf16: bool, arch: str = "efficientnet:b0") -> dict:
    """cfgs/speechcommands/efficientnet-b0-leaf-default.cfg's model and
    optimizer (Adam lr 1e-3, coupled L2 1e-4, warm-up cosine over 10
    epochs) with the backbone ``arch:depth``; bf16 compute as ``train
    --bf16`` sets it."""
    name, _, depth = arch.partition(":")
    cfg = {"frontend": {"name": "leaf", "default_args": True},
           "audio_config": {"sample_rate": SR},
           "model": {"arch": name,
                     "model_depth": int(depth) if depth.isdigit() else depth,
                     "num_classes": N_CLASSES},
           "opt": {"optimizer": "Adam", "lr": 1e-3, "weight_decay": 1e-4,
                   "scheduler": "warmupcosine", "warmup_epochs": 10}}
    if bf16:
        for part in ("frontend", "model"):
            cfg[part]["compute_dtype"] = "bfloat16"
    return cfg


def trainer(cfg: dict, state: dict, device, augment: bool = True,
            steps_per_epoch: int = STEPS_PER_EPOCH, epochs: int = EPOCHS,
            capturable: bool = False, pg=None):
    """(TrainState, train step) for ``cfg`` from the weights ``state``;
    the step's loss is the cfg's ``model.type`` (multiclass unless
    named); with a process group ``pg`` the data-parallel step."""
    from leaf_tpu_torch.data import leaf_device_augment
    from leaf_tpu_torch.models import Classifier
    from leaf_tpu_torch.training import (TrainState, make_train_step,
                                         optimization_helper)
    clf = Classifier(cfg, device=device)
    clf.load_state_dict(state)
    opt, sched, _, _ = optimization_helper(
        cfg, clf.parameters(), num_tr_steps_per_epoch=steps_per_epoch,
        num_epochs=epochs, capturable=capturable)
    return (TrainState(clf, opt, sched),
            make_train_step(cfg["model"].get("type", "multiclass"),
                            augment_fn=leaf_device_augment if augment
                            else None, process_group=pg))


def stacked(rng, k: int, b: int, t: int, device):
    """K seeded batches of (b, t) clips and labels, stacked."""
    xs = torch.from_numpy((rng.randn(k, b, t) * 0.1)
                          .astype(np.float32)).to(device)
    ys = torch.from_numpy(rng.randint(0, N_CLASSES, (k, b))).to(device)
    return xs, ys


def build_programs(batch: int, device, bf16: bool = True,
                   arch: str = "efficientnet:b0", t_samples: int = SR,
                   steps_per_call: int = 1, seed: int = 0):
    """(run_train, run_frontend, run_infer): callables without arguments
    that take turns over two seeded groups of batches (``stacked``): K
    train steps per call (one CUDA graph for K > 1 on the card; augment,
    dropout, drop-connect on), the Leaf's fwd+bwd of sum(features²), and
    the classifier's eval forward."""
    from leaf_tpu_torch.data import leaf_device_augment
    from leaf_tpu_torch.frontend import Leaf
    from leaf_tpu_torch.models import Classifier
    from leaf_tpu_torch.training import make_train_multistep
    cfg = flagship_cfg(bf16, arch)
    k = steps_per_call
    gen0 = torch.Generator().manual_seed(seed)
    state = Classifier(cfg, device=device, generator=gen0).state_dict()
    st, step = trainer(cfg, state, device, capturable=k > 1)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    rng = np.random.RandomState(seed)
    groups = [stacked(rng, k, batch, t_samples, device) for _ in range(2)]
    turn = itertools.count()
    if k == 1:
        def run_train():
            xs, ys = groups[next(turn) % 2]
            return step(st, xs[0], ys[0], gen)
    else:
        multi = make_train_multistep(k, augment_fn=leaf_device_augment)

        def run_train():
            return multi(st, *groups[next(turn) % 2], gen)
        run_train.multi = multi

    leaf = Leaf(compute_dtype=torch.bfloat16 if bf16 else torch.float32,
                device=device, generator=torch.Generator().manual_seed(seed))

    def run_frontend():
        x = groups[next(turn) % 2][0][0]
        leaf.zero_grad(set_to_none=True)
        (leaf(x).float() ** 2).sum().backward()

    clf = Classifier(cfg, device=device)
    clf.load_state_dict(state)
    clf.eval()

    def run_infer():
        with torch.inference_mode():
            return clf(groups[next(turn) % 2][0][0])

    return run_train, run_frontend, run_infer


def measure_program(call: Callable, device, n: int, warmup: int = 3,
                    per: int = 1, profile: bool = True) -> dict:
    """The host-clock times of ``n`` calls (each ending in a synchronize,
    after ``warmup``) per step (``per`` steps a call), and on the card a
    torch.profiler window of ``n`` calls with the idle share against the
    host median: {"wall_ms" (median), "wall_min_ms", "wall_max_ms",
    "profile" (a ``DeviceProfile`` or None)}."""
    times = _measure.host_times_ms(call, n, device, warmup, per)
    med = float(np.median(times))
    prof = None
    if profile and torch.device(device).type == "cuda":
        prof = _measure.device_profile(call, n, host_ms=med, per=per)
    return {"wall_ms": med, "wall_min_ms": min(times),
            "wall_max_ms": max(times), "profile": prof}


def report(title: str, prof: Optional[_measure.DeviceProfile],
           top: int) -> Optional[float]:
    """Print a window's categories and top kernels; its busy ms per step."""
    if prof is None or prof.busy_ms is None:
        print(f"\n=== {title}: device time not measured ===")
        return None
    print(f"\n=== {title}: device-busy {prof.busy_ms:.3f} ms/step "
          f"({prof.launches:.0f} kernels/step) ===")
    for label, ms in sorted(prof.categories.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:8.3f} ms/step  {label}")
    print(f"  top {top} kernels:")
    for name, count, ms in prof.rows[:top]:
        print(f"  {ms:8.3f} ms/step  x{count:6.1f}  {name[:100]}")
    return prof.busy_ms


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m leaf_tpu_torch.scripts.step_profile",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--clip_seconds", type=float, default=1.0,
                    help="clip length in seconds at 16 kHz (3 = VoxCeleb "
                         "shape, 10 = AudioSet shape)")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--arch", type=str, default="efficientnet:b0",
                    help="backbone 'arch:depth'; cifar_resnet:20 for fast "
                         "CPU runs")
    ap.add_argument("--steps_per_call", type=int, default=1,
                    help="K train steps per call (one CUDA graph on the "
                         "card)")
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (the default) or cpu (plain kernel "
                         "versions, no device metric)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = _measure.open_device(args.device, "step_profile")
    if device is None:
        return 1
    t = int(SR * args.clip_seconds)
    k = args.steps_per_call
    run_train, run_frontend, run_infer = build_programs(
        args.batch, device, bf16=not args.f32, arch=args.arch, t_samples=t,
        steps_per_call=k)
    calls = max(1, args.steps // k)
    fe = measure_program(run_frontend, device, args.steps)
    inf = measure_program(run_infer, device, args.steps)
    step = measure_program(run_train, device, calls, per=k)
    t_fe = report("frontend fwd+bwd", fe["profile"], args.top)
    t_inf = report("inference (full model fwd)", inf["profile"], args.top)
    t_step = report(f"FULL train step (K={k} per call)", step["profile"],
                    args.top)
    if t_step is not None:
        print(f"\ncross-check: step {t_step:.3f} ms vs frontend "
              f"{t_fe:.3f} + (backbone fwd+bwd + optimizer) "
              f"{t_step - t_fe:.3f} ms; full-model fwd (incl. frontend "
              f"fwd) {t_inf:.3f} ms")
    print(f"step wall (host clock, synchronized): median "
          f"{step['wall_ms']:.3f} ms/step over {calls} calls")
    sp = step["profile"]
    _measure.emit({
        "metric": "step_profile", "batch": args.batch,
        "clip_seconds": args.clip_seconds, "arch": args.arch,
        "dtype": "f32" if args.f32 else "bf16", "steps_per_call": k,
        "step_busy_ms": t_step, "frontend_fwdbwd_busy_ms": t_fe,
        "inference_busy_ms": t_inf, "step_wall_ms": step["wall_ms"],
        "step_idle_share": sp.idle if sp else None,
        "frontend_fwdbwd_wall_ms": fe["wall_ms"],
        "inference_wall_ms": inf["wall_ms"],
        "categories": {name: p["profile"].categories if p["profile"]
                       else None for name, p in (("step", step),
                                                 ("frontend", fe),
                                                 ("inference", inf))},
        "pool_bytes": getattr(getattr(run_train, "multi", None),
                              "pool_bytes", None),
        **_measure.card(device)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
