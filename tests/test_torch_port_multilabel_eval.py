"""Multilabel evaluation across implementations, on the CPU: the port's
``python -m leaf_tpu_torch.evaluate --metrics multilabel`` against the
JAX ``evaluate.py`` on the same weights.

The tiny multilabel split of tests/test_torch_port_convergence.py (the
synthetic-convergence harness's ``make_split`` at 70 train clips and 35
test clips, 1–3 tone bands each, k-hot labels) and its cfg (``CFG``,
cifar_resnet-20). A port classifier takes one multilabel train step on
8 train clips; its BatchNorm statistics are then set from 16 train clips
(each layer's variance floored at a tenth of its mean, as
tests/test_torch_port_pretrained.py does), so that the eval-mode logits
are O(1) and rank the clips (a fresh net's are ~1e-8, every clip tied),
and it is saved as a port checkpoint with the run's ``hparams.json``.
The port's ``evaluate.main`` scores it; the JAX
``import_torch_classifier`` brings its ``state_dict`` across into an
orbax checkpoint, the same ``hparams.json`` beside it, and the JAX
``evaluate.main`` scores that. Their results.txt values of mAP, mAUC and
d′ agree to 1e-5 (NaN where the AUC is undefined on both sides: a class
without positives or negatives among 35 clips).
"""

import contextlib
import csv
import importlib.util
import io
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from leaf_tpu.models import Classifier as JaxClassifier
from leaf_tpu.models import import_torch_classifier as jax_import
from leaf_tpu.training import TrainState as JaxTrainState
from leaf_tpu.training import checkpoint as jax_ckpt
from leaf_tpu_torch import evaluate as port_evaluate
from leaf_tpu_torch.data import load_audio
from leaf_tpu_torch.models import Classifier
from leaf_tpu_torch.models.common import set_batch_norm_stats_
from leaf_tpu_torch.synthetic_convergence import (CFG, N_CLASSES, SR,
                                                  make_split)
from leaf_tpu_torch.training import (TrainState, make_train_step,
                                     optimization_helper)
from leaf_tpu_torch.training.checkpoint import save_checkpoint, save_hparams
from leaf_tpu_torch.training.config import parse_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
KEYS = ("mAP", "mAUC", "dprime")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    # the test runner shares the cores among its workers
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _script(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _results(exp_dir):
    with open(os.path.join(exp_dir, "results.txt"), newline="") as f:
        row = next(csv.DictReader(f))
    return {k: float(row[k]) for k in KEYS}


def _clips(root, name, n):
    """The first n clips of a split and their k-hot labels."""
    with open(os.path.join(root, f"{name}.csv"), newline="") as f:
        rows = list(csv.DictReader(f))[:n]
    x = np.stack([load_audio(r["files"], SR, min_duration=None)
                  for r in rows]).astype(np.float32)
    y = np.zeros((n, N_CLASSES), np.float32)
    for i, r in enumerate(rows):
        y[i, [int(c[len("class"):]) for c in r["labels"].split("|")]] = 1
    return torch.from_numpy(x), torch.from_numpy(y)


def test_multilabel_evaluate_matches_jax(tmp_path, monkeypatch):
    root = str(tmp_path)
    make_split(root, "train_multilabel", 70, seed=0, task="multilabel")
    make_split(root, "test_multilabel", 35, seed=2, task="multilabel")
    with open(os.path.join(root, "lbl_map.json"), "w") as f:
        json.dump({f"class{i}": i for i in range(N_CLASSES)}, f)
    cfg_path = os.path.join(root, "cfg.yaml")
    with open(cfg_path, "w") as f:
        f.write(CFG.format(root=root, batch=35, warmup=1,
                           arch="cifar_resnet", depth=20, task="multilabel",
                           train_csv="train_multilabel.csv",
                           val_csv="train_multilabel.csv",
                           test_csv="test_multilabel.csv"))
    cfg = parse_config(cfg_path)

    # the port checkpoint: one train step, then O(1) eval-mode logits
    model = Classifier(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    opt, sched, _, _ = optimization_helper(
        cfg, model.parameters(), num_tr_steps_per_epoch=2, num_epochs=1)
    state = TrainState(model, opt, sched)
    x, y = _clips(root, "train_multilabel", 16)
    loss = make_train_step("multilabel")(state, x[:8], y[:8])["loss"]
    assert math.isfinite(float(loss))
    with torch.no_grad():
        set_batch_norm_stats_(model, x)
        for bn in model.modules():
            if isinstance(bn, torch.nn.BatchNorm2d):
                bn.running_var.add_(0.1 * bn.running_var.mean())
    port_exp = os.path.join(root, "port")
    ckpt = save_checkpoint(port_exp, TrainState(model, None), epoch=1,
                           tr_loss=float(loss), tr_acc=0.0, val_acc=0.5)
    save_hparams(port_exp, cfg)
    common = ["--meta_dir", root, "--test_csv_name", "test_multilabel.csv",
              "--metrics", "multilabel", "--separator", "|"]
    with contextlib.redirect_stdout(io.StringIO()):
        assert port_evaluate.main(["--exp_dir", port_exp, "--ckpt", ckpt,
                                   *common, "--device", "cpu"]) == 0

    # the JAX side: import the state_dict, score it with evaluate.py
    jm = JaxClassifier(cfg=cfg)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((2, SR)), train=False))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                      dict(shapes))
    v = jax_import({k: t.numpy() for k, t in model.state_dict().items()},
                   template, "cifar_resnet")
    jax_exp = os.path.join(root, "jax")
    jax_ckpt.save_checkpoint(
        jax_exp, JaxTrainState.create(apply_fn=jm.apply, params=v["params"],
                                      batch_stats=v["batch_stats"],
                                      tx=optax.identity()),
        epoch=1, tr_loss=float(loss), tr_acc=0.0, val_acc=0.5)
    save_hparams(jax_exp, cfg)
    jax_eval = _script(os.path.join(REPO, "evaluate.py"), "_jax_evaluate")
    monkeypatch.setattr("sys.argv", [
        "evaluate.py", "--exp_dir", jax_exp,
        "--ckpt", os.path.join(jax_exp, "epoch_001"), *common])
    with contextlib.redirect_stdout(io.StringIO()):
        jax_eval.main(jax_eval.parse_args())

    got, ref = _results(port_exp), _results(jax_exp)
    assert 0 < got["mAP"] < 1
    for k in KEYS:
        if math.isnan(ref[k]):
            assert math.isnan(got[k]), (k, got, ref)
        else:
            assert abs(got[k] - ref[k]) <= TOL, (k, got, ref)
