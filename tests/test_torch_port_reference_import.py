"""The port's import of reference (leaf-pytorch) checkpoints,
``python -m leaf_tpu_torch.import_torch_classifier`` and
``python -m leaf_tpu_torch.convert_torch_checkpoint``, against the JAX
repo's ``scripts/import_torch_classifier.py`` and
``scripts/convert_torch_checkpoint.py`` on the CPU.

A port ``Classifier``'s ``state_dict`` is the reference layout, so the
source checkpoints are port models (efficientnet-b0 and ResNet-18 behind
a Leaf of 8 filters, 3 classes: the tiny experiment's cfg), their
frontends moved off the mel init and their BatchNorm statistics set from
one batch with each layer's variances floored at a tenth of their mean,
as tests/test_torch_port_pretrained.py does (O(1) logits; float32 noise
≤ 3e-5 of them), saved as a reference training checkpoint:
``{"model_state_dict": {"module." + key: tensor}, "epoch": 5,
"val_acc": 0.9}``.

- The port import writes ``epoch_005`` (meta as the JAX script writes it)
  and ``hparams.json``; ``load_checkpoint`` gives the source tensors
  exactly; ``evaluate`` scores the directory and ``train
  --continue_from_ckpt`` resumes from it at epoch 6.
- The JAX script on the same file, scored by the JAX model, gives the
  port's logits within LOGIT_TOL of their scale. It writes no
  ``hparams.json`` (the JAX ``evaluate.py`` needs one).
- The port convert writes the JAX convert's npz and manifest exactly.
- A missing key, a misshaped key and another arch's checkpoint raise,
  and nothing is written.
"""

import contextlib
import functools
import importlib.util
import io
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from leaf_tpu.models import Classifier as JaxClassifier
from leaf_tpu.training import checkpoint as jax_ckpt
from leaf_tpu.training import parse_config as jax_parse_config
from leaf_tpu_torch import convert_torch_checkpoint as port_convert
from leaf_tpu_torch import import_torch_classifier as port_import
from leaf_tpu_torch import train
from leaf_tpu_torch.models import Classifier
from leaf_tpu_torch.models.common import set_batch_norm_stats_
from leaf_tpu_torch.training import TrainState
from leaf_tpu_torch.training.checkpoint import load_checkpoint, load_hparams
from leaf_tpu_torch.training.config import parse_config
from tests.test_torch_port_cuda import make_tiny_exp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 16000
LOGIT_TOL = 1e-4
_RNG = np.random.RandomState(7)
CALIB = torch.from_numpy((_RNG.randn(8, T) * 0.1).astype(np.float32))
X = (_RNG.randn(2, T) * 0.1).astype(np.float32)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    # the test runner shares the cores among its workers
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_script(name, args, monkeypatch):
    monkeypatch.setattr("sys.argv", [f"{name}.py", *map(str, args)])
    with contextlib.redirect_stdout(io.StringIO()):
        _script(name).main()


def _source(cfg, seed):
    """A port classifier with a moved frontend and set BN statistics."""
    model = Classifier(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(seed)).eval()
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for p in model.features.parameters():
            p.mul_(1 + 0.05 * torch.randn(p.shape, generator=g))
        set_batch_norm_stats_(model, CALIB)
        for bn in model.modules():
            if isinstance(bn, torch.nn.BatchNorm2d):
                bn.running_var.add_(0.1 * bn.running_var.mean())
    return model


@pytest.fixture(scope="module")
def exp(tmp_path_factory):
    """The tiny experiment (data, label map, efficientnet-b0 cfg), a
    ResNet-18 cfg beside it, and per arch a reference checkpoint."""
    root = make_tiny_exp(tmp_path_factory.mktemp("ref_import"))
    text = (root / "cfg.cfg").read_text()
    (root / "resnet.cfg").write_text(
        text.replace("arch: efficientnet", "arch: resnet")
        .replace("model_depth: b0", "model_depth: 18"))
    out = {}
    for arch, cfg_name in (("efficientnet", "cfg.cfg"),
                           ("resnet", "resnet.cfg")):
        cfg_file = root / cfg_name
        src = _source(parse_config(str(cfg_file)), seed=len(out) + 1)
        pth = root / f"{arch}.pth"
        torch.save({"model_state_dict": {f"module.{k}": v for k, v in
                                         src.state_dict().items()},
                    "epoch": 5, "val_acc": 0.9}, pth)
        out[arch] = (cfg_file, pth, src)
    return root, out


def _port_import(exp, arch, name):
    root, by_arch = exp
    cfg_file, pth, _ = by_arch[arch]
    out = root / name
    assert port_import.main([str(pth), str(cfg_file), str(out),
                             "--device", "cpu"]) == 0
    return out


@functools.lru_cache(maxsize=None)
def _jax_apply(cfg_file):
    jm = JaxClassifier(cfg=jax_parse_config(cfg_file))
    return jax.jit(lambda v, x: jm.apply(v, x, train=False))


def _port_logits(path, cfg):
    model = Classifier(cfg, device="cpu")
    load_checkpoint(path, TrainState(model, None), with_opt=False)
    with torch.no_grad():
        return model.eval()(torch.from_numpy(X)).numpy(), model


@pytest.mark.parametrize("arch", ["efficientnet", "resnet"])
def test_import_gives_the_source_and_jax_logits(arch, exp, tmp_path,
                                                monkeypatch):
    cfg_file, pth, src = exp[1][arch]
    out = _port_import(exp, arch, f"port_{arch}")
    path = out / "epoch_005"
    assert sorted(os.listdir(out)) == ["epoch_005", "hparams.json"]
    meta = json.loads((path / "meta.json").read_text())
    assert meta == {"epoch": 5, "tr_loss": -1.0, "tr_acc": -1.0,
                    "val_acc": 0.9}
    cfg = parse_config(str(cfg_file))
    assert load_hparams(str(out)) == cfg
    logits, model = _port_logits(str(path), cfg)
    got, want = model.state_dict(), src.state_dict()
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k

    # the JAX script on the same file, scored by the JAX model
    jax_out = tmp_path / "jax"
    _run_script("import_torch_classifier", [pth, cfg_file, jax_out],
                monkeypatch)
    assert sorted(os.listdir(jax_out)) == ["epoch_005"]   # no hparams.json
    assert json.loads((jax_out / "epoch_005" / "meta.json").read_text()) \
        == meta
    raw, _ = jax_ckpt._restore_raw(str(jax_out / "epoch_005"))
    ref = np.asarray(_jax_apply(str(cfg_file))(
        {"params": raw["params"], "batch_stats": raw["batch_stats"]}, X))
    rel = float(np.abs(logits - ref).max() / np.abs(ref).max())
    assert rel <= LOGIT_TOL, rel
    assert np.abs(ref).max() > 1e-2   # not a vanished net


def test_imported_experiment_evaluates_and_resumes(exp, capsys):
    root, by_arch = exp
    out = _port_import(exp, "efficientnet", "port_eval")
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO,
           "OMP_NUM_THREADS": "2"}
    res = subprocess.run(
        [sys.executable, "-m", "leaf_tpu_torch.evaluate", "--exp_dir",
         str(out), "--meta_dir", str(root), "--test_csv_name", "test.csv",
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        env=env, cwd=REPO)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-2000:]
    assert "epoch_005 (val metric 0.9)" in res.stdout
    assert "Accuracy: " in res.stdout
    assert (out / "results.txt").read_text().startswith("model,acc,ckpt\n")
    # train resumes from it: a fresh optimizer, the source's epoch + 1
    assert train.main(["--cfg_file", str(by_arch["efficientnet"][0]),
                       "--expdir", str(out), "--epochs", "7",
                       "--num_workers", "1", "--device", "cpu",
                       "--continue_from_ckpt",
                       str(out / "epoch_005")]) == 0
    log = capsys.readouterr().out
    assert "at epoch 6" in log and "epoch 6: tr_loss" in log
    assert (out / "epoch_006" / "state.pt").exists()


def test_convert_writes_the_jax_npz(exp, tmp_path, monkeypatch):
    _, by_arch = exp
    pth = by_arch["efficientnet"][1]
    _run_script("convert_torch_checkpoint", [pth, tmp_path / "jax"],
                monkeypatch)
    with contextlib.redirect_stdout(io.StringIO()):
        assert port_convert.main([str(pth), str(tmp_path / "port"),
                                  "--device", "cpu"]) == 0
    for name in ("manifest.json",):
        assert ((tmp_path / "port" / name).read_text()
                == (tmp_path / "jax" / name).read_text())
    with np.load(tmp_path / "jax" / "frontend_params.npz") as a, \
            np.load(tmp_path / "port" / "frontend_params.npz") as b:
        assert a.files == b.files and len(a.files) == 7
        for k in a.files:
            assert a[k].dtype == b[k].dtype == np.float32
            assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("misfit", ["missing", "misshaped", "wrong_arch"])
def test_import_refuses_misfits(misfit, exp, tmp_path):
    root, by_arch = exp
    cfg_file, pth, _ = by_arch["efficientnet"]
    blob = torch.load(pth, weights_only=True)
    sd = blob["model_state_dict"]
    if misfit == "missing":
        del sd["module.model._blocks.3._bn1.running_var"]
        match = "Missing key"
    elif misfit == "misshaped":
        sd["module.model._fc.weight"] = sd["module.model._fc.weight"][:2]
        match = "size mismatch"
    else:
        blob = torch.load(by_arch["resnet"][1], weights_only=True)
        match = "Unexpected key"
    torch.save(blob, tmp_path / "bad.pth")
    with pytest.raises(RuntimeError, match=match):
        port_import.main([str(tmp_path / "bad.pth"), str(cfg_file),
                          str(tmp_path / "out"), "--device", "cpu"])
    assert not (tmp_path / "out").exists()
