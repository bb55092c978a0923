"""Evaluate a trained checkpoint on a test manifest — the port of the JAX
package's ``evaluate.py``.

Long clips are replicate-padded up to a whole number of seconds, chunked
into 1-second windows, and scored as the MEAN of per-window logits
(reference: test.py:57-71,126-128); clips are batched by window count.
Multiclass reports accuracy; multilabel reports mAP/mAUC/d-prime.
Results go to <exp_dir>/results.txt in the JAX ``evaluate.py``'s format, and a run
whose results.txt exists skips. The cfg, and with it the compute dtype
(bf16 after ``train --bf16``), is the run's saved ``hparams.json``, as
the JAX ``evaluate.py`` reads its saved cfg; the logits are scored in
f32, and the run ends by printing the fused kernels' launch counts.

``--n_devices N`` under ``torchrun`` (one process per device) splits the
windows of each forward over the ranks; every rank gathers the logits,
and rank 0 reports and writes the metrics, equal to a one-device run's.

Example:

    python -m leaf_tpu_torch.evaluate --exp_dir ./exp_scv2_b0 \\
        --meta_dir ~/scv2/meta --test_csv_name test.csv
    python -m torch.distributed.run --nproc_per_node 8 \\
        -m leaf_tpu_torch.evaluate --n_devices 8 --exp_dir ... ...
"""

from __future__ import annotations

import argparse
import json
import math
import os
from typing import List, Tuple

import numpy as np
import torch

from leaf_tpu_torch.data import (RawWaveformDataset, leaf_host_crop_transforms,
                                 peak_normalize, pinned_placer,
                                 setup_dataloaders)
from leaf_tpu_torch.data.transforms import Compose, PeakNormalization
from leaf_tpu_torch.models import Classifier
from leaf_tpu_torch.ops.fused_frontend import launch_counts
from leaf_tpu_torch.parallel import (all_gather_rows, barrier, data_group,
                                     join_world, shutdown_distributed)
from leaf_tpu_torch.training import TrainState
from leaf_tpu_torch.training.bn_recalibrate import recalibrate_batch_stats
from leaf_tpu_torch.training.checkpoint import (best_checkpoint,
                                                load_checkpoint, load_hparams)
from leaf_tpu_torch.training.metrics import (calculate_mAP, calculate_stats,
                                             d_prime)

_DROPPED = ("evaluate.py's --platform and --compilation_cache_dir are "
            "dropped: --device picks the device, and nothing is compiled "
            "ahead of the run.")
MAX_CLIPS_PER_BATCH = 64


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, epilog=_DROPPED,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--test_csv_name", type=str, required=True)
    p.add_argument("--exp_dir", type=str, required=True)
    p.add_argument("--meta_dir", type=str, required=True)
    p.add_argument("--metrics", type=str, default="multiclass",
                   choices=["multiclass", "multilabel"])
    p.add_argument("--separator", type=str, default=",")
    p.add_argument("--ckpt", type=str, default=None,
                   help="explicit checkpoint dir (default: best by val_acc)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default cuda)")
    p.add_argument("--n_devices", type=int, default=None,
                   help="devices (= torchrun processes) to split the "
                        "windows over (default: torchrun's world size, "
                        "else 1)")
    p.add_argument("--bn_recalibrate", type=int, default=0, metavar="N",
                   help="before scoring, re-estimate the BatchNorm running "
                        "statistics from N train-manifest batches with "
                        "frozen parameters; 0 = off")
    p.add_argument("--train_csv_name", type=str, default="train.csv",
                   help="train manifest (under --meta_dir) to draw "
                        "--bn_recalibrate batches from")
    p.add_argument("--recal_batch_size", type=int, default=256)
    return p.parse_args(argv)


def pad_to_windows(signal: np.ndarray, sr: int) -> np.ndarray:
    """(T,) → (n_windows, sr): replicate-pad to ceil(T/sr)·sr, centered,
    then reshape into 1 s windows (reference: test.py:57-71)."""
    t = signal.shape[-1]
    size = int(math.ceil(t / sr) * sr)
    padding = size - t
    offset = padding // 2
    signal = np.pad(signal, (offset, padding - offset), mode="edge")
    return signal.reshape(-1, sr)


@torch.no_grad()
def score_clips(model: torch.nn.Module, clips: List[np.ndarray], sr: int,
                device, group=None) -> List[np.ndarray]:
    """Mean logits over each clip's 1 s windows, in clip order.

    Clips are bucketed by window count, so each forward takes one shape
    and clips batch together (at most MAX_CLIPS_PER_BATCH per forward);
    the model runs in eval mode. With a process ``group`` each forward's
    windows are split over its ranks (zero rows pad them to a multiple;
    eval-mode BatchNorm keeps rows independent) and every rank gathers
    the logits."""
    model.eval()
    buckets = {}
    for i, x in enumerate(clips):
        windows = pad_to_windows(np.asarray(x, dtype=np.float32), sr)
        buckets.setdefault(windows.shape[0], []).append((windows, i))
    out: List[np.ndarray] = [None] * len(clips)
    n_done = 0
    for n_windows, items in sorted(buckets.items()):
        for start in range(0, len(items), MAX_CLIPS_PER_BATCH):
            chunk = items[start:start + MAX_CLIPS_PER_BATCH]
            stacked = np.stack([w for w, _ in chunk])
            b = stacked.shape[0]
            x = torch.from_numpy(stacked.reshape(b * n_windows, sr))
            logits = _forward(model, x.to(device), group).cpu().numpy()
            mean_logits = logits.reshape(b, n_windows, -1).mean(axis=1)
            for (_, idx), ml in zip(chunk, mean_logits):
                out[idx] = ml
            n_done += len(chunk)
            if n_done % 512 < MAX_CLIPS_PER_BATCH:
                print(f"{n_done}/{len(clips)}")
    return out


def _forward(model, x: torch.Tensor, group) -> torch.Tensor:
    """f32 logits of the rows of x: on this process alone, or split over
    ``group``'s ranks and gathered."""
    if group is None:
        return model(x).float()
    world = torch.distributed.get_world_size(group)
    n = x.shape[0]
    per = -(-n // world)
    x = torch.cat([x, x.new_zeros((per * world - n,) + x.shape[1:])])
    r = torch.distributed.get_rank(group)
    mine = model(x[r * per:(r + 1) * per]).float()
    return all_gather_rows(mine, group)[:n]


def _recalibrate(args, state: TrainState, cfg: dict, sr: int,
                 device) -> None:
    """BN statistics from random train-manifest crops, peak-normalized
    like training, with the parameters frozen (under data parallelism
    every rank walks the same batches and the statistics are reduced, so
    the replicas stay equal). The clips are decoded once and kept when
    the run's cfg keeps its data in memory (``data.in_memory``), as the
    train CLI does: N batches may walk a short manifest many times."""
    ac = cfg["audio_config"]
    tr_clip = int(float(ac.get("random_clip_size", 1.0)) * sr)
    recal_set = RawWaveformDataset(
        os.path.join(args.meta_dir, args.train_csv_name),
        os.path.join(args.meta_dir, "lbl_map.json"),
        ac, mode=args.metrics,
        transform=leaf_host_crop_transforms(True, tr_clip),
        delimiter=args.separator,
        in_memory=bool(cfg.get("data", {}).get("in_memory", False)))
    recal_loader, _ = setup_dataloaders(
        recal_set, None, args.recal_batch_size, target_len=tr_clip,
        multiclass=args.metrics == "multiclass", num_workers=2,
        need_val=False)
    if len(recal_loader) == 0:
        # the batches below would cycle an empty loader for ever
        raise ValueError(
            f"--bn_recalibrate: {args.train_csv_name} holds "
            f"{len(recal_set)} clips, fewer than one batch of "
            f"--recal_batch_size {args.recal_batch_size}")
    place = pinned_placer(device)

    def recal_batches(n):
        done = 0
        while done < n:
            for bx, _ in iter(recal_loader):
                yield place((bx,))[0]
                done += 1
                if done >= n:
                    return

    print(f"recalibrating BN stats on {args.bn_recalibrate} batches "
          f"of {args.recal_batch_size} from {args.train_csv_name}")
    recalibrate_batch_stats(
        state, recal_batches(args.bn_recalibrate),
        torch.Generator(device=device).manual_seed(0),
        preprocess=lambda _, x: peak_normalize(x),
        process_group=data_group())


def results_text(cfg: dict, metrics: str, preds, gts,
                 ckpt_name: str) -> Tuple[str, str]:
    """(summary printed, results.txt body) — the JAX ``evaluate.py``'s format."""
    if metrics == "multiclass":
        acc = float(np.mean(np.asarray(preds) == np.asarray(gts)))
        return (f"Accuracy: {acc:.4f}",
                f"model,acc,ckpt\n{cfg['model']['arch']},{acc},{ckpt_name}\n")
    macro_mAP = calculate_mAP(preds, gts, mode="macro")
    stats = calculate_stats(np.concatenate(preds), np.concatenate(gts))
    mAUC = float(np.mean([s["auc"] for s in stats]))
    dp = d_prime(mAUC)
    return (f"mAP: {macro_mAP:.5f}\nmAUC: {mAUC:.5f}\ndprime: {dp:.5f}",
            f"model,mAP,mAUC,dprime,ckpt\n{cfg['model']['arch']},"
            f"{macro_mAP},{mAUC},{dp},{ckpt_name}\n")


def main(argv=None) -> int:
    args = parse_args(argv)
    rank, world, device = join_world("leaf_tpu_torch.evaluate", args.device,
                                     args.n_devices)
    try:
        return _evaluate(args, rank, world, device)
    finally:
        shutdown_distributed()


def _evaluate(args, rank: int, world: int, device) -> int:
    cfg = load_hparams(args.exp_dir)
    ckpt = args.ckpt or best_checkpoint(args.exp_dir)
    if not ckpt:
        raise FileNotFoundError(f"no checkpoint found under {args.exp_dir}")
    ckpt_name = os.path.basename(ckpt)
    res_path = os.path.join(args.exp_dir, "results.txt")
    if os.path.exists(res_path):
        print(f"{res_path} exists, skipping (reference test.py:88-91)")
        return 0

    ac = cfg["audio_config"]
    sr = int(ac["sample_rate"])
    test_set = RawWaveformDataset(
        os.path.join(args.meta_dir, args.test_csv_name),
        os.path.join(args.meta_dir, "lbl_map.json"),
        ac, mode=args.metrics, transform=Compose([PeakNormalization(sr=sr)]),
        is_val=True, delimiter=args.separator)

    model = Classifier(cfg, device=device,
                       generator=torch.Generator().manual_seed(0))
    state, meta = load_checkpoint(ckpt, TrainState(model, None),
                                  with_opt=False)
    print(f"loaded {ckpt} (val metric {meta.get('val_acc', 'n/a')}); "
          f"compute dtype: frontend {model.features.compute_dtype}, model "
          f"{model.model.compute_dtype}")
    if args.bn_recalibrate > 0:
        _recalibrate(args, state, cfg, sr, device)

    clips, labels = zip(*(test_set[i] for i in range(len(test_set))))
    if world > 1:
        print(f"rank {rank}: splitting the windows over {world} devices")
    mean_logits = score_clips(model, list(clips), sr, device, data_group())
    if args.metrics == "multiclass":
        preds = [int(np.argmax(ml)) for ml in mean_logits]
        gts = [int(y) for y in labels]
    else:
        preds = [torch.sigmoid(torch.from_numpy(ml)).numpy()[None]
                 for ml in mean_logits]
        gts = [np.asarray(y, dtype=np.float32)[None] for y in labels]
    summary, body = results_text(cfg, args.metrics, preds, gts, ckpt_name)
    print(summary if rank == 0 else f"rank {rank}: {summary}")
    print(f"kernels {json.dumps(launch_counts())}")
    if rank == 0:
        with open(res_path, "w") as fd:
            fd.write(body)
    barrier()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
