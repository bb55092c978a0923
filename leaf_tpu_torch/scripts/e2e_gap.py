"""Decompose the gap between the train loop's clips/s and the device
step's, the counterpart of the JAX repo's ``scripts/e2e_gap.py``.

On one tone dataset (``--clips`` unique 1 s WAVs, 35 classes, written to
``--root`` or a temporary directory) and the flagship train step (Leaf +
``--arch``, B=256, bf16, the device augment on), in one process, for the
int16 and the float32 wire:

  loader_only       the host pipeline alone (decode, crop, collate; the
                    DataLoader's threads), with ``data.in_memory`` on
                    (``loader_only_clips_per_sec_<wire>``, the last of
                    ``--epochs``: the first fills the cache) and off
                    (``..._<wire>_disk``)
  h2d               ``pinned_placer``'s copy of each batch to the card
                    (``h2d_ms_per_batch_<wire>``)
  step_only         the train step on batches already on the card
  e2e_sync          loader + copy + step, no overlap
  e2e_prefetch      the train CLI's path: ``prefetch_to_device`` with
                    ``pinned_placer`` (the copies overlap the steps)

All are clips/s on the host clock, each pass ending in a synchronize.

    python -m leaf_tpu_torch.scripts.e2e_gap [--clips 4096] [--batch 256]
        [--epochs 3] [--root DIR] [--arch efficientnet:b0] [--device cuda]
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from leaf_tpu_torch.scripts import _measure
from leaf_tpu_torch.scripts.step_profile import flagship_cfg, trainer

SR = 16000
WORKERS = 2   # the DataLoader's threads, as the JAX script's
AUDIO_CONFIG = {"sample_rate": SR, "min_duration": 1.0,
                "random_clip_size": 1.0, "val_clip_size": 1.0,
                "normalize": False, "feature": "raw"}


def make_dataset(root: str, n_clips: int) -> None:
    """Unique 1 s tone WAVs (35 classes), train.csv and lbl.json."""
    from leaf_tpu_torch.data import write_wav
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(0)
    t = np.arange(SR) / SR
    rows = []
    for i in range(n_clips):
        f0 = 200.0 + 13.7 * i  # unique per clip: no two batches equal
        x = 0.3 * np.sin(2 * np.pi * f0 * t) + 0.01 * rng.randn(SR)
        path = os.path.join(root, f"clip{i:05d}.wav")
        write_wav(path, x.astype(np.float32), SR)
        rows.append((path, f"class{i % 35}"))
    with open(os.path.join(root, "train.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(("files", "labels"))
        w.writerows(rows)
    with open(os.path.join(root, "lbl.json"), "w") as f:
        json.dump({f"class{i}": i for i in range(35)}, f)


def build_loader(manifest: str, labels: str, batch: int, wire: str,
                 in_memory: bool, workers: int = WORKERS,
                 audio_config: dict = AUDIO_CONFIG):
    """The train CLI's train DataLoader over ``manifest``: 1 s random
    crops, multiclass, ``wire`` int16 or float32."""
    from leaf_tpu_torch.data import (RawWaveformDataset,
                                     leaf_host_crop_transforms,
                                     setup_dataloaders)
    ds = RawWaveformDataset(manifest, labels, audio_config, mode="multiclass",
                            transform=leaf_host_crop_transforms(True, SR),
                            in_memory=in_memory, wire_dtype=wire)
    loader, _ = setup_dataloaders(ds, None, batch, target_len=SR,
                                  num_workers=workers, need_val=False)
    return loader


def loader_rates(loader, epochs: int) -> list:
    """clips/s of ``loader`` alone (no model), per epoch."""
    rates = []
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        t0 = time.perf_counter()
        n = sum(x.shape[0] for x, _ in loader)
        rates.append(n / (time.perf_counter() - t0))
    return rates


def decode_us(files, sample_rate: int = SR) -> float:
    """µs per clip of ``load_audio`` alone, one thread, over ``files``
    (read once before, so the OS cache holds them)."""
    from leaf_tpu_torch.data.audio import load_audio
    for f in files:
        load_audio(f, sample_rate, 1.0, dtype="int16")
    t0 = time.perf_counter()
    for f in files:
        load_audio(f, sample_rate, 1.0, dtype="int16")
    return (time.perf_counter() - t0) / len(files) * 1e6


def _rate(fn, loader, epochs: int, batch: int, device) -> float:
    """clips/s of the last of ``epochs`` passes of ``fn(loader)`` (the
    batches it ran), each pass ending in a synchronize."""
    rate = 0.0
    for ep in range(epochs):
        loader.set_epoch(ep)
        _measure.sync(device)
        t0 = time.perf_counter()
        n = fn(loader)
        _measure.sync(device)
        rate = n * batch / (time.perf_counter() - t0)
    return rate


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m leaf_tpu_torch.scripts.e2e_gap",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--clips", type=int, default=4096)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--root", type=str, default=None,
                    help="reuse (or write) the dataset in this directory")
    ap.add_argument("--arch", type=str, default="efficientnet:b0",
                    help="backbone 'arch:depth'; cifar_resnet:20 for fast "
                         "CPU runs")
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (the default) or cpu (no device metric)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = _measure.open_device(args.device, "e2e_gap")
    if device is None:
        return 1
    with tempfile.TemporaryDirectory(prefix="e2e_gap_") as tmp:
        return _run(args, device, args.root or tmp)


def _run(args, device, root: str) -> int:
    from leaf_tpu_torch.data.loader import pinned_placer, prefetch_to_device
    from leaf_tpu_torch.models import Classifier
    if not os.path.exists(os.path.join(root, "train.csv")):
        print(f"generating {args.clips} clips in {root}", file=sys.stderr)
        make_dataset(root, args.clips)
    manifest = os.path.join(root, "train.csv")
    labels = os.path.join(root, "lbl.json")
    cfg = flagship_cfg(True, args.arch)
    state = Classifier(cfg, device=device,
                       generator=torch.Generator().manual_seed(0)).state_dict()
    st, step = trainer(cfg, state, device)
    gen = torch.Generator(device=device).manual_seed(1)
    place = pinned_placer(device)
    out = {"metric": "e2e_gap", "batch": args.batch, "clips": args.clips,
           "arch": args.arch, "workers": WORKERS}
    for wire in ("int16", "float32"):
        loader = build_loader(manifest, labels, args.batch, wire, True,
                              WORKERS)
        out[f"loader_only_clips_per_sec_{wire}"] = loader_rates(
            loader, args.epochs)[-1]
        out[f"loader_only_clips_per_sec_{wire}_disk"] = loader_rates(
            build_loader(manifest, labels, args.batch, wire, False,
                         WORKERS), args.epochs)[-1]

        host_batches = list(loader)
        _measure.sync(device)
        t0 = time.perf_counter()
        for hb in host_batches:
            place(hb)
        _measure.sync(device)
        dt = time.perf_counter() - t0
        out[f"h2d_ms_per_batch_{wire}"] = dt / len(host_batches) * 1e3
        out[f"h2d_only_clips_per_sec_{wire}"] = (len(host_batches)
                                                 * args.batch / dt)

        if "step_only_clips_per_sec" not in out:
            dev_batches = [place(hb) for hb in host_batches[:8]]
            step(st, *dev_batches[0], gen)
            _measure.sync(device)
            t0 = time.perf_counter()
            for _ in range(3):
                for dx, dy in dev_batches:
                    step(st, dx, dy, gen)
            _measure.sync(device)
            out["step_only_clips_per_sec"] = (3 * len(dev_batches)
                                              * args.batch
                                              / (time.perf_counter() - t0))

        def e2e_sync(ld):
            n = 0
            for hb in ld:
                step(st, *place(hb), gen)
                n += 1
            return n

        def e2e_prefetch(ld):
            n = 0
            for dx, dy in prefetch_to_device(iter(ld), place):
                step(st, dx, dy, gen)
                n += 1
            return n

        out[f"e2e_sync_clips_per_sec_{wire}"] = _rate(
            e2e_sync, loader, 2, args.batch, device)
        out[f"e2e_prefetch_clips_per_sec_{wire}"] = _rate(
            e2e_prefetch, loader, 2, args.batch, device)
    for k, v in out.items():
        if isinstance(v, float):
            print(f"{k:40s} {v:12.2f}", file=sys.stderr)
    _measure.emit({**out, **_measure.card(device)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
