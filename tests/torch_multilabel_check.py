"""The multilabel synthetic-convergence row, port against the JAX package.

Four steps, each a subcommand:

- ``card`` (on the card; imports no JAX): train the row with the port's
  harness, ``python -m leaf_tpu_torch.synthetic_convergence --task
  multilabel --epochs 100`` (b0, 2560 clips, B=256, ``--bf16``), and
  keep its best checkpoint (the one ``evaluate`` scores; model only, no
  optimizer state), the run's ``hparams.json`` and the harness's JSON
  line under ``--out``.
- ``cross`` (on the CPU): score that checkpoint with the port's
  ``python -m leaf_tpu_torch.evaluate --device cpu`` and with the JAX
  ``evaluate.py``, after ``scripts/import_torch_classifier.py`` has
  brought the weights across (that script writes no ``hparams.json``;
  the run's own is copied beside its output). Both score the same test
  split, rebuilt here byte for byte by the port's ``make_split``; once in
  the run's compute dtype and once in f32.
- ``logits`` (on the CPU): the same checkpoint's per-clip logits on that
  test split from the port's and the JAX package's classifiers, each in
  bf16 and f32 compute (in-process, the JAX side through
  ``leaf_tpu.models.import_torch_classifier``): how far the two bf16
  computations sit apart beside JAX's own bf16-to-f32 distance, and the
  metrics of each set.
- ``spread`` (on the CPU): build the harness's splits and cfg once, then
  train and evaluate each seed with both sides' CLIs (``train.py`` /
  ``evaluate.py --platform cpu`` and ``python -m leaf_tpu_torch.train``
  / ``.evaluate --device cpu``, ``--random_seed s``), at the same
  reduced ``--clips`` / ``--epochs``.

Each prints JSON lines, the last one a summary:

    python -m tests.torch_multilabel_check card --out ./ml_row
    python -m tests.torch_multilabel_check cross --exp ./ml_row \\
        --root /tmp/ml_cross
    python -m tests.torch_multilabel_check logits --exp ./ml_row \\
        --root /tmp/ml_cross
    python -m tests.torch_multilabel_check spread --root /tmp/ml_spread \\
        --arch cifar_resnet:20 --clips 700 --batch 35 --epochs 10 \\
        --seeds 8881 8882 8883 --jobs 3 --threads 2
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import queue
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASK = "multilabel"
KEYS = ("mAP", "mAUC", "dprime")


def _run(cmd, log_path: str, cpus=None) -> str:
    """Run ``cmd`` from the repository root, pinned to the CPU set
    ``cpus`` where one is given (PyTorch's and XLA's thread pools size
    themselves to it); its output goes to ``log_path``; a non-zero exit
    raises."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p)}
    if cpus:
        env["OMP_NUM_THREADS"] = str(len(cpus))
    r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                       preexec_fn=(lambda: os.sched_setaffinity(0, cpus))
                       if cpus else None)
    with open(log_path, "w") as f:
        f.write(r.stdout + "\n--- stderr ---\n" + r.stderr)
    if r.returncode != 0:
        raise RuntimeError(f"{cmd[:4]} exited {r.returncode}; see {log_path}:"
                           f"\n{r.stdout[-1500:]}\n{r.stderr[-1500:]}")
    return r.stdout


def _results(path: str) -> dict:
    """The full-precision metrics of a results.txt (both evaluate CLIs
    write ``model,mAP,mAUC,dprime,ckpt``); ``path`` may be its directory."""
    if os.path.isdir(path):
        path = os.path.join(path, "results.txt")
    with open(path, newline="") as f:
        row = next(csv.DictReader(f))
    return {k: float(row[k]) for k in KEYS} | {"ckpt": row["ckpt"]}


def _smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not measured"


def card(args) -> dict:
    """Train the row on the card; keep its best checkpoint, slimmed."""
    if args.root:
        return _card(args, args.root)
    with tempfile.TemporaryDirectory(prefix="ml_row_") as root:
        return _card(args, root)


def _card(args, root: str) -> dict:
    import torch

    from leaf_tpu_torch.models import Classifier
    from leaf_tpu_torch.training import TrainState
    from leaf_tpu_torch.training.checkpoint import (best_checkpoint,
                                                    load_checkpoint,
                                                    load_hparams,
                                                    save_checkpoint,
                                                    save_hparams)

    os.makedirs(args.out, exist_ok=True)
    t0 = time.time()
    out = _run([sys.executable, "-m", "leaf_tpu_torch.synthetic_convergence",
                "--task", TASK, "--epochs", str(args.epochs),
                "--clips", str(args.clips), "--batch", str(args.batch),
                "--device", args.device, "--root", root],
               os.path.join(args.out, "harness.log"))
    line = json.loads(out.strip().splitlines()[-1])
    expdir = os.path.join(root, f"exp_efficientnetb0_{TASK}")
    best = best_checkpoint(expdir)
    cfg = load_hparams(expdir)
    model = Classifier(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    _, meta = load_checkpoint(best, TrainState(model, None), with_opt=False)
    kept = os.path.join(args.out, "exp")
    save_checkpoint(kept, TrainState(model, None), epoch=int(meta["epoch"]),
                    tr_loss=float(meta["tr_loss"]),
                    tr_acc=float(meta["tr_acc"]),
                    val_acc=float(meta["val_acc"]))
    save_hparams(kept, cfg)
    shutil.copy(os.path.join(expdir, "results.txt"),
                os.path.join(args.out, "card_results.txt"))
    return {"step": "card", "card": _smi(), "harness": line,
            "best": os.path.basename(best),
            "card_results": _results(os.path.join(args.out,
                                                  "card_results.txt")),
            "seconds": round(time.time() - t0, 1)}


def _splits(root: str, clips: int, batch: int, test_only: bool) -> dict:
    """The harness's splits (names, sizes, seeds) and label map under
    ``root``."""
    from leaf_tpu_torch.synthetic_convergence import N_CLASSES, make_split

    os.makedirs(root, exist_ok=True)
    names = {n: f"{n}_{TASK}" for n in ("train", "val", "test")}
    small = max(batch, clips // 8)
    if not test_only:
        make_split(root, names["train"], clips, seed=0, task=TASK)
        make_split(root, names["val"], small, seed=1, task=TASK)
    make_split(root, names["test"], small, seed=2, task=TASK)
    with open(os.path.join(root, "lbl_map.json"), "w") as f:
        json.dump({f"class{i}": i for i in range(N_CLASSES)}, f)
    return names


def _f32(cfg: dict) -> dict:
    cfg = json.loads(json.dumps(cfg))
    for section in ("frontend", "model"):
        cfg[section].pop("compute_dtype", None)
    return cfg


def _eval_cmds(side: str, exp_dir: str, root: str, test_csv: str) -> list:
    common = ["--exp_dir", exp_dir, "--meta_dir", root, "--test_csv_name",
              test_csv, "--metrics", TASK, "--separator", "|"]
    if side == "jax":
        return [sys.executable, "evaluate.py", *common, "--platform", "cpu"]
    return [sys.executable, "-m", "leaf_tpu_torch.evaluate", *common,
            "--device", "cpu"]


def cross(args) -> list:
    """Both evaluate CLIs on the card's checkpoint, as trained and in f32."""
    import torch

    from leaf_tpu_torch.training.checkpoint import (best_checkpoint,
                                                    load_hparams)

    names = _splits(args.root, 2560, 256, test_only=True)
    test_csv = f"{names['test']}.csv"
    src = os.path.join(args.exp, "exp")
    ckpt = best_checkpoint(src)
    cfg = load_hparams(src)
    blob = torch.load(os.path.join(ckpt, "state.pt"), map_location="cpu",
                      weights_only=True)
    with open(os.path.join(ckpt, "meta.json")) as f:
        meta = json.load(f)
    pth = os.path.join(args.root, "ref.pth")
    torch.save({"model_state_dict": blob["model"], **meta}, pth)
    rows = []
    for dtype, run_cfg in (("as_trained", cfg), ("f32", _f32(cfg))):
        work = os.path.join(args.root, dtype)
        shutil.rmtree(work, ignore_errors=True)
        port_exp, jax_exp = (os.path.join(work, s) for s in ("port", "jax"))
        shutil.copytree(src, port_exp)
        cfg_file = os.path.join(work, "hparams.json")
        for path in (os.path.join(port_exp, "hparams.json"), cfg_file):
            with open(path, "w") as f:
                json.dump(run_cfg, f, indent=2)
        _run([sys.executable, "scripts/import_torch_classifier.py", pth,
              cfg_file, jax_exp, "--platform", "cpu"],
             os.path.join(work, "jax_import.log"))
        shutil.copy(cfg_file, os.path.join(jax_exp, "hparams.json"))
        got = {}
        for side, exp_dir in (("port", port_exp), ("jax", jax_exp)):
            _run(_eval_cmds(side, exp_dir, args.root, test_csv),
                 os.path.join(work, f"{side}_evaluate.log"))
            got[side] = _results(exp_dir)
        rows.append({"step": "cross", "compute": dtype, **got,
                     "abs_diff": {k: abs(got["port"][k] - got["jax"][k])
                                  for k in KEYS}})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def _metrics(logits, labels) -> dict:
    import numpy as np

    from leaf_tpu_torch.training.metrics import (calculate_mAP,
                                                 calculate_stats, d_prime)

    preds = [(1.0 / (1.0 + np.exp(-row.astype(np.float64))))[None]
             for row in logits]
    gts = [row[None] for row in labels]
    stats = calculate_stats(np.concatenate(preds), np.concatenate(gts))
    mauc = float(np.mean([st["auc"] for st in stats]))
    return {"mAP": float(calculate_mAP(preds, gts, mode="macro")),
            "mAUC": mauc, "dprime": float(d_prime(mauc))}


def logits(args) -> list:
    """Per-clip logits of the port and of JAX, bf16 and f32, one checkpoint."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from leaf_tpu.models import Classifier as JaxClassifier
    from leaf_tpu.models import import_torch_classifier as jax_import
    from leaf_tpu_torch.data import load_audio
    from leaf_tpu_torch.models import Classifier
    from leaf_tpu_torch.training.checkpoint import (best_checkpoint,
                                                    load_hparams)

    names = _splits(args.root, 2560, 256, test_only=True)
    src = os.path.join(args.exp, "exp")
    cfg = load_hparams(src)
    sd = torch.load(os.path.join(best_checkpoint(src), "state.pt"),
                    map_location="cpu", weights_only=True)["model"]
    with open(os.path.join(args.root, f"{names['test']}.csv"),
              newline="") as f:
        rows = list(csv.DictReader(f))
    x = np.stack([load_audio(r["files"], 16000, min_duration=None)
                  for r in rows]).astype(np.float32)
    peak = np.abs(x).max(axis=1, keepdims=True)
    x = np.where(peak > 1.0, x / peak, x)       # PeakNormalization
    y = np.zeros((len(rows), 35), np.float32)
    for i, r in enumerate(rows):
        y[i, [int(c[len("class"):]) for c in r["labels"].split("|")]] = 1
    out = {}
    for dtype, run_cfg in (("bf16", cfg), ("f32", _f32(cfg))):
        model = Classifier(run_cfg, device="cpu").eval()
        model.load_state_dict(sd)
        with torch.no_grad():
            out[f"port_{dtype}"] = np.concatenate([
                model(torch.from_numpy(x[i:i + 64])).float().numpy()
                for i in range(0, len(x), 64)])
        jm = JaxClassifier(cfg=run_cfg)
        shapes = jax.eval_shape(lambda: jm.init(
            {"params": jax.random.PRNGKey(0)}, jnp.zeros((2, 16000)),
            train=False))
        v = jax_import({k: t.numpy() for k, t in sd.items()},
                       jax.tree_util.tree_map(
                           lambda a: np.zeros(a.shape, a.dtype),
                           dict(shapes)), cfg["model"]["arch"])
        apply = jax.jit(lambda v, b: jm.apply(v, b, train=False))
        out[f"jax_{dtype}"] = np.concatenate([
            np.asarray(apply(v, x[i:i + 64]), np.float32)
            for i in range(0, len(x), 64)])

    def dist(a, b):
        d = np.abs(out[a] - out[b])
        return {"max": float(d.max()), "mean": float(d.mean())}

    gaps = {"port_bf16-jax_bf16": dist("port_bf16", "jax_bf16"),
            "jax_bf16-jax_f32": dist("jax_bf16", "jax_f32"),
            "port_bf16-jax_f32": dist("port_bf16", "jax_f32"),
            "port_f32-jax_f32": dist("port_f32", "jax_f32")}
    row = {"step": "logits", "clips": len(x),
           "max_abs_logit": float(np.abs(out["jax_f32"]).max()),
           "gaps": gaps,
           "ratio_port_bf16_to_jax_bf16_gap": {
               k: gaps["port_bf16-jax_bf16"][k] / gaps["jax_bf16-jax_f32"][k]
               for k in ("max", "mean")},
           "metrics": {k: _metrics(v, y) for k, v in out.items()}}
    print(json.dumps(row), flush=True)
    return [row]


def _spread_run(side: str, seed: int, args, cfg_path: str, names,
                slots) -> dict:
    exp_dir = os.path.join(args.root, f"{side}_seed{seed}")
    shutil.rmtree(exp_dir, ignore_errors=True)
    train = ["--cfg_file", cfg_path, "--expdir", exp_dir,
             "--epochs", str(args.epochs), "--num_workers", "2",
             "--log_steps", "10", "--labels_delimiter", "|",
             "--random_seed", str(seed),
             "--save_every", str(max(1, args.epochs // 8))]
    if args.bf16:
        train.append("--bf16")
    if side == "jax":
        train = [sys.executable, "train.py", *train, "--platform", "cpu"]
    else:
        train = [sys.executable, "-m", "leaf_tpu_torch.train", *train,
                 "--device", "cpu"]
    cpus = slots.get()
    try:
        t0 = time.time()
        _run(train, exp_dir + "_train.log", cpus)
        train_s = time.time() - t0
        _run(_eval_cmds(side, exp_dir, args.root, f"{names['test']}.csv"),
             exp_dir + "_evaluate.log", cpus)
    finally:
        slots.put(cpus)
    return {"step": "spread", "side": side, "seed": seed,
            **_results(exp_dir), "train_s": round(train_s, 1)}


def spread(args) -> list:
    """Both sides' CLIs over the seeds, on one split and one cfg."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from leaf_tpu_torch.synthetic_convergence import CFG

    names = _splits(args.root, args.clips, args.batch, test_only=False)
    cfg_path = os.path.join(args.root, "cfg.yaml")
    with open(cfg_path, "w") as f:
        f.write(CFG.format(root=args.root, batch=args.batch,
                           warmup=max(1, args.epochs // 6),
                           arch=args.arch.split(":")[0],
                           depth=args.arch.split(":")[1], task=TASK,
                           train_csv=f"{names['train']}.csv",
                           val_csv=f"{names['val']}.csv",
                           test_csv=f"{names['test']}.csv"))
    jobs = [(side, s) for s in args.seeds for side in ("jax", "port")]
    slots = queue.Queue()
    for i in range(args.jobs):     # disjoint CPU sets, one per running job
        slots.put(set(range(i * args.threads, (i + 1) * args.threads)))
    with ThreadPoolExecutor(args.jobs) as pool:
        rows = list(pool.map(
            lambda j: _spread_run(j[0], j[1], args, cfg_path, names, slots),
            jobs))
    for r in rows:
        print(json.dumps(r), flush=True)
    summary = {"step": "spread_summary", "arch": args.arch,
               "clips": args.clips,
               "batch": args.batch, "epochs": args.epochs,
               "bf16": args.bf16}
    for side in ("jax", "port"):
        for k in KEYS:
            v = np.array([r[k] for r in rows if r["side"] == side])
            summary[f"{side}_{k}"] = {"mean": float(v.mean()),
                                      "min": float(v.min()),
                                      "max": float(v.max()),
                                      "std": float(v.std(ddof=1))
                                      if v.size > 1 else 0.0}
    pm = summary["port_mAP"]["mean"]
    summary["port_mean_within_jax_range"] = bool(
        summary["jax_mAP"]["min"] <= pm <= summary["jax_mAP"]["max"])
    return rows + [summary]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="step", required=True)
    c = sub.add_parser("card")
    c.add_argument("--out", required=True)
    c.add_argument("--root", default=None)
    c.add_argument("--epochs", type=int, default=100)
    c.add_argument("--clips", type=int, default=2560)
    c.add_argument("--batch", type=int, default=256)
    c.add_argument("--device", default="cuda",
                   help="the harness's device (a small --device cpu run "
                        "checks this step)")
    for step in ("cross", "logits"):
        x = sub.add_parser(step)
        x.add_argument("--exp", required=True,
                       help="the card step's --out directory")
        x.add_argument("--root", required=True)
    s = sub.add_parser("spread")
    s.add_argument("--root", required=True)
    s.add_argument("--arch", default="efficientnet:b0",
                   help="the harness's --arch")
    s.add_argument("--clips", type=int, default=280)
    s.add_argument("--batch", type=int, default=35)
    s.add_argument("--epochs", type=int, default=8)
    s.add_argument("--seeds", type=int, nargs="+",
                   default=[8881, 8882, 8883])
    s.add_argument("--bf16", action="store_true")
    s.add_argument("--jobs", type=int, default=2,
                   help="runs at a time")
    s.add_argument("--threads", type=int, default=2,
                   help="CPUs per run (runs are pinned to disjoint sets)")
    args = ap.parse_args(argv)
    if args.step == "card":
        out = [card(args)]
    elif args.step == "cross":
        out = cross(args)
    elif args.step == "logits":
        out = logits(args)
    else:
        out = spread(args)
    print(json.dumps(out[-1]), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
