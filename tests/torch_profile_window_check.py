"""How often torch.profiler misses a fused-frontend kernel of a K-step
CUDA-graph replay, with the profiler's window unpadded and padded.

On the card only (imports no JAX): build the kernels as ``chip_smoke.py``
does, capture the flagship's K = 4 train step at B = 256 (augment on,
``chip_smoke``'s ``[multistep]`` set-up) in bf16 and f32, then profile
one replay in each of ``--windows`` windows per dtype and pad, with
``leaf_tpu_torch.scripts._measure.profile_window`` at pad 0 and at its
default ``WINDOW_PAD_S``. A window misses when it holds fewer than K
saving-forward or K backward launches. Each missing window is printed
with where its device rows and its fused kernels sit (µs from the
window's start), the last line is a summary, and the exit code is 1 when
a padded window missed:

    python -m tests.torch_profile_window_check --windows 40 \\
        --out chiprun_out/profile_window.json
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

K = 4


def _record(prof, symbols: dict) -> dict:
    from torch.autograd import DeviceType
    events = prof.events()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    rec = {"device_rows": len(dev),
           "device_first_us": min(e.time_range.start for e in dev),
           "host_first_us": min(e.time_range.start for e in cpu)}
    for name, sym in symbols.items():
        rec[name] = sorted(round(e.time_range.start, 1) for e in dev
                           if sym in e.name)
    rec["missed"] = any(len(rec[name]) != K for name in symbols)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--windows", type=int, default=40)
    ap.add_argument("--out", default=None,
                    help="write every window's record here (JSON)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_profile_window_check: no CUDA device", file=sys.stderr)
        return 1

    import chip_smoke as cs
    from leaf_tpu_torch.data import leaf_device_augment
    from leaf_tpu_torch.models import Classifier
    from leaf_tpu_torch.scripts import _measure
    from leaf_tpu_torch.training import make_train_multistep

    cs.phase_build()
    device = torch.device("cuda", 0)
    state = Classifier(cs.FLAGSHIP_CFG, device=device,
                       generator=torch.Generator().manual_seed(0)
                       ).state_dict()
    records, summary = [], {}
    for dtype, cfg, sfx in (("bf16", cs._bf16(cs.TRAIN_CFG), "_bf16"),
                            ("f32", cs.TRAIN_CFG, "")):
        symbols = {name: cs.KERNEL_SYMBOLS[name]
                   for name in ("fwd_save" + sfx, "bwd" + sfx)}
        rng = np.random.RandomState(16)
        st, _ = cs.trainer(cfg, state, device, True, cs.STEPS_PER_EPOCH,
                           cs.EPOCHS, capturable=True)
        gen = torch.Generator(device=device).manual_seed(16)
        multi = make_train_multistep(K, augment_fn=leaf_device_augment)
        groups = [cs.stacked(rng, K, cs.TRAIN_B, 16000, device)
                  for _ in range(2)]
        multi(st, *groups[0], gen)  # K eager steps, then the capture
        torch.cuda.synchronize()
        for pad in (0.0, _measure.WINDOW_PAD_S):
            missed = 0
            for window in range(args.windows):
                prof = _measure.profile_window(
                    lambda: multi(st, *groups[1], gen), 1, pad=pad)
                rec = {"dtype": dtype, "pad_s": pad, "window": window,
                       **_record(prof, symbols)}
                records.append(rec)
                missed += rec["missed"]
                if rec["missed"]:
                    print(json.dumps(rec), flush=True)
            summary[f"{dtype} pad {pad:g} s"] = f"{missed} of {args.windows}"
            print(f"{dtype}, pad {pad:g} s: {missed} of {args.windows} "
                  "windows miss a kernel", flush=True)
        del multi, st
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f)
    print(json.dumps({"windows_missing_a_kernel": summary}))
    padded_missed = any(r["missed"] for r in records
                        if r["pad_s"] == _measure.WINDOW_PAD_S)
    return 1 if padded_missed else 0


if __name__ == "__main__":
    sys.exit(main())
