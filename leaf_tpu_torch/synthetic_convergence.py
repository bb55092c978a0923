"""Train a recipe to convergence on synthetic audio and score it — the
port's counterpart of ``scripts/synthetic_convergence.py``.

A 35-class tone task that requires learning (class c is a tone in the
band 200 + 150·c ± 40 Hz with a random gain and phase, plus noise;
multilabel clips hold 1–3 bands and carry k-hot labels) is written as
WAVs with CSV manifests, then the recipe runs through the port's own
CLIs: ``python -m leaf_tpu_torch.train --bf16`` (Adam + warm-up cosine,
B=256, the fused frontend kernels' bf16 variants) and
``python -m leaf_tpu_torch.evaluate`` (1 s-window mean logits, accuracy
or mAP/mAUC/d′). The splits, the cfg, the child commands and the JSON
line are the JAX harness's:

    --arch efficientnet:b0 --task multiclass   (the flagship, SCv2-shaped)
    --arch resnet:18       --task multiclass
    --arch efficientnet:b0 --task multilabel   (AudioSet-shaped)

``--bn_recalibrate N`` re-estimates the BatchNorm running statistics
from N train batches before scoring (EfficientNet's 0.99 EMA lags on
short runs); ``--skip_train`` re-scores the experiment already in
``--root``.

Prints one JSON line: ``metric``, ``value`` (the test metric),
``final_val_metric`` (the last epoch's val metric; under
``--skip_train`` the last checkpoint's), ``arch``, ``task``, ``epochs``,
``train_clips``, ``train_wall_s``, ``bn_recalibrate``, ``mAUC`` and
``dprime`` for multilabel, and ``kernels``: the train run's last launch
counts of the fused frontend kernels (null under ``--skip_train``). A
child that exits non-zero, or a metric missing from a child's output,
raises.

    python -m leaf_tpu_torch.synthetic_convergence --epochs 100
    python -m leaf_tpu_torch.synthetic_convergence --device cpu \\
        --arch cifar_resnet:20 --clips 70 --batch 35 --epochs 2
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

from leaf_tpu_torch import resolve_device
from leaf_tpu_torch.data import write_wav
from leaf_tpu_torch.training.checkpoint import latest_checkpoint

SR = 16000
N_CLASSES = 35
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_EPOCH_METRIC = re.compile(r"^epoch \d+: tr_loss .* val_(?:acc|mAP) (\S+) ",
                           re.M)
_KERNELS = re.compile(r"^epoch \d+: .* kernels (\{.*\})$", re.M)


def _tone(rng, c, t):
    """One tone from class-c's frequency band; the network must resolve
    the band through the random offset, gain, phase, and noise."""
    f0 = 200.0 + 150.0 * c + rng.uniform(-40.0, 40.0)
    amp = rng.uniform(0.1, 0.5)
    phase = rng.uniform(0, 2 * np.pi)
    return amp * np.sin(2 * np.pi * f0 * t + phase)


def _cached(csv_path: str, n_clips: int, seed: int, task: str) -> bool:
    """Whether ``csv_path`` is this split already. The generation
    parameters ride along as the ``task`` and ``seed`` columns (the
    dataset reader ignores them), so a rerun with another task or seed
    regenerates instead of training on a stale split."""
    with open(csv_path, newline="") as f:
        reader = csv.DictReader(f)
        rows = list(reader)
    return (len(rows) == n_clips and "task" in (reader.fieldnames or ())
            and rows[0]["task"] == task and int(rows[0]["seed"]) == seed)


def make_split(root: str, name: str, n_clips: int, seed: int,
               task: str = "multiclass") -> None:
    """Write ``<root>/<name>/clipNNNNN.wav`` and ``<root>/<name>.csv``
    (columns files, labels, task, seed), reusing a cached split of the
    same (clips, seed, task)."""
    rng = np.random.RandomState(seed)
    files, labels = [], []
    t = np.arange(SR) / SR
    csv_path = os.path.join(root, f"{name}.csv")
    if os.path.exists(csv_path) and _cached(csv_path, n_clips, seed, task):
        return
    os.makedirs(os.path.join(root, name), exist_ok=True)
    for i in range(n_clips):
        if task == "multilabel":
            # 1-3 simultaneous band tones, k-hot label ('|'-delimited:
            # commas would collide with the CSV)
            k = rng.randint(1, 4)
            cs = sorted(rng.choice(N_CLASSES, size=k, replace=False)
                        .tolist())
            x = sum(_tone(rng, c, t) for c in cs) + 0.05 * rng.randn(SR)
            labels.append("|".join(f"class{c}" for c in cs))
        else:
            c = i % N_CLASSES
            x = _tone(rng, c, t) + 0.05 * rng.randn(SR)
            labels.append(f"class{c}")
        p = os.path.join(root, name, f"clip{i:05d}.wav")
        write_wav(p, x.astype(np.float32), SR)
        files.append(p)
    with open(csv_path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(("files", "labels", "task", "seed"))
        w.writerows((p, y, task, seed) for p, y in zip(files, labels))


CFG = """frontend:
    name: leaf
    default_args: True
model:
    arch: {arch}
    num_classes: 35
    model_depth: {depth}
    pool: avgpool
    type: {task}
opt:
    optimizer: Adam
    lr: 1e-3
    momentum: 0.9
    scheduler: warmupcosine
    warmup_epochs: {warmup}
    weight_decay: 1e-4
    batch_size: {batch}
audio_config:
    feature: raw
    normalize: False
    sample_rate: 16000
    min_duration: 1
    random_clip_size: 1
    val_clip_size: 1
    mixup: False
data:
    meta_root: "{root}"
    is_lmdb: False
    in_memory: True
    train_manifest: "{train_csv}"
    val_manifest: "{val_csv}"
    test_manifest: "{test_csv}"
    label_map: lbl_map.json
"""


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--clips", type=int, default=2560)
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device of the train and evaluate runs "
                         "(default cuda; raises without a card)")
    ap.add_argument("--arch", type=str, default="efficientnet:b0",
                    help="'efficientnet:b0', 'resnet:18', 'cifar_resnet:20'")
    ap.add_argument("--task", type=str, default="multiclass",
                    choices=["multiclass", "multilabel"])
    ap.add_argument("--root", type=str, default=None,
                    help="dataset/exp dir (default: fresh tempdir)")
    ap.add_argument("--bn_recalibrate", type=int, default=0,
                    help="pass --bn_recalibrate N to evaluate: re-estimate "
                         "the BN running stats from N train batches before "
                         "scoring (the fix for the momentum-0.99 EMA lag "
                         "on short runs)")
    ap.add_argument("--skip_train", action="store_true",
                    help="reuse --root's existing expdir checkpoint and "
                         "only run evaluate (e.g. to score the same run "
                         "with and without --bn_recalibrate)")
    return ap.parse_args(argv)


def _child(module: str, args) -> str:
    """Run ``python -m leaf_tpu_torch.<module>`` from the repository root;
    returns its stdout (its tails go to stderr). A non-zero exit raises."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (_REPO, os.environ.get("PYTHONPATH")) if p)}
    r = subprocess.run([sys.executable, "-m", f"leaf_tpu_torch.{module}",
                        *args], cwd=_REPO, env=env, capture_output=True,
                       text=True)
    sys.stderr.write(r.stdout[-4000:] + r.stderr[-2000:])
    r.check_returncode()
    return r.stdout


def _number(pattern: str, text: str, what: str) -> float:
    m = re.search(pattern, text, re.M)
    if m is None:
        raise RuntimeError(f"no {what} in the output: {text[-2000:]}")
    return float(m.group(1))


def run(args) -> dict:
    """Write the splits and the cfg, train, evaluate; the JSON line's
    fields."""
    resolve_device(args.device)
    arch, depth = args.arch.split(":")
    root = args.root or tempfile.mkdtemp(prefix="leaf_convergence_")
    os.makedirs(root, exist_ok=True)
    print(f"dataset/exp root: {root}", file=sys.stderr)
    # split names and the expdir are task-keyed, the expdir also
    # arch-keyed, so runs sharing a --root never alias
    tr, va, te = (f"{n}_{args.task}" for n in ("train", "val", "test"))
    make_split(root, tr, args.clips, seed=0, task=args.task)
    make_split(root, va, max(args.batch, args.clips // 8), seed=1,
               task=args.task)
    make_split(root, te, max(args.batch, args.clips // 8), seed=2,
               task=args.task)
    with open(os.path.join(root, "lbl_map.json"), "w") as f:
        json.dump({f"class{i}": i for i in range(N_CLASSES)}, f)
    cfg_path = os.path.join(root, "cfg.yaml")
    with open(cfg_path, "w") as f:
        f.write(CFG.format(root=root, batch=args.batch,
                           warmup=max(1, args.epochs // 6),
                           arch=arch, depth=depth, task=args.task,
                           train_csv=f"{tr}.csv", val_csv=f"{va}.csv",
                           test_csv=f"{te}.csv"))
    expdir = os.path.join(root, f"exp_{arch}{depth}_{args.task}")

    train_s, kernels = 0.0, None
    if args.skip_train:
        ckpt = latest_checkpoint(expdir)
        if ckpt is None:
            raise FileNotFoundError(f"--skip_train: no checkpoint in {expdir}")
        with open(os.path.join(ckpt, "meta.json")) as f:
            final_val = float(json.load(f)["val_acc"])
    else:
        t0 = time.time()
        out = _child("train", [
            "--cfg_file", cfg_path, "--expdir", expdir,
            "--epochs", str(args.epochs), "--num_workers", "2",
            "--log_steps", "10", "--bf16", "--labels_delimiter", "|",
            "--device", args.device,
            # EffNet's BN 0.99-EMA needs ~1000 steps to calibrate; the
            # best epochs and the last always save, so checkpoint sparsely
            "--save_every", str(max(1, args.epochs // 8))])
        train_s = time.time() - t0
        vals = _EPOCH_METRIC.findall(out)
        counts = _KERNELS.findall(out)
        if not vals or not counts:
            raise RuntimeError(f"no epoch line in the train output: "
                               f"{out[-2000:]}")
        final_val = float(vals[-1])
        kernels = json.loads(counts[-1])

    cmd = ["--test_csv_name", f"{te}.csv", "--exp_dir", expdir,
           "--meta_dir", root, "--metrics", args.task, "--separator", "|",
           "--device", args.device]
    if args.bn_recalibrate:
        # a reused --root must re-score: evaluate skips while results.txt
        # is there
        res_txt = os.path.join(expdir, "results.txt")
        if args.skip_train and os.path.exists(res_txt):
            os.remove(res_txt)
        # batches of the train batch (the JAX harness leaves evaluate's
        # 256, the same at the default --batch)
        cmd += ["--bn_recalibrate", str(args.bn_recalibrate),
                "--train_csv_name", f"{tr}.csv",
                "--recal_batch_size", str(args.batch)]
    out = _child("evaluate", cmd)
    if args.task == "multilabel":
        value = _number(r"^mAP: (\S+)$", out, "mAP")
        extra = {k: _number(rf"^{k}: (\S+)$", out, k)
                 for k in ("mAUC", "dprime")}
    else:
        value = _number(r"^Accuracy: (\S+)$", out, "Accuracy")
        extra = {}
    return {
        "metric": f"synthetic_convergence_test_"
                  f"{'mAP' if args.task == 'multilabel' else 'acc'}",
        "value": value,
        "final_val_metric": final_val,
        "arch": args.arch, "task": args.task,
        "epochs": args.epochs,
        "train_clips": args.clips,
        "train_wall_s": round(train_s, 1),
        "bn_recalibrate": args.bn_recalibrate,
        **extra,
        "kernels": kernels,
    }


def main(argv=None) -> int:
    print(json.dumps(run(parse_args(argv))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
