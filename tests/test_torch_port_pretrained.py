"""Pretrained-weight interop in the port, held against the JAX package on
the CPU.

- ``training.checkpoint.load_converted_frontend`` /
  ``apply_pretrained_frontend`` on a ``frontend_params.npz`` of
  ``scripts/convert_torch_checkpoint.py``: the port's features equal the
  source's exactly; the JAX loaders on the same npz, carried into the
  port by ``load_jax_variables``, give the same weights exactly and JAX's
  logits match the port's within LOGIT_TOL of their scale;
- ``scripts/leaf_tpu_to_torch_checkpoint.py`` on a ``leaf_tpu`` orbax
  checkpoint: the port checkpoint's logits match JAX's within LOGIT_TOL,
  and ``apply_pretrained_frontend`` / ``load_pretrained_backbone`` read
  from it give exactly the weights the JAX loaders give from the orbax
  one (the head and the BatchNorm statistics kept fresh, as JAX keeps
  them);
- ``models.pretrained.load_pretrained_backbone`` on a bare
  lukemelas-named EfficientNet ``state_dict`` and a torchvision-named
  ResNet-18 one, both with ImageNet's 3-channel stem and 1000-class
  head: the stem and head stay fresh, every other tensor is the
  ``state_dict``'s, and JAX's ``import_torch_backbone`` on the same
  ``state_dict`` gives the same weights and logits (LOGIT_TOL);
- ``python -m leaf_tpu_torch.train`` with ``frontend.pretrained``: the
  frontend is loaded before the optimizer is made, f32 under ``--bf16``.

BatchNorm running statistics are set from one batch in the port
(``set_batch_norm_stats_``), with each layer's variances floored at a
tenth of their mean, as a trained net has no near-degenerate channel: the
logits compared are O(0.1–1), and float32 noise, which the random b0
amplifies to up to 1e-4 of the logits without the floor, stays ≤ 3e-5
(measured: 1.9e-6 to 2.7e-5 over these tests).
"""

import functools
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from leaf_tpu.models import Classifier as JaxClassifier
from leaf_tpu.models.torch_import import (import_torch_backbone,
                                          import_torch_classifier)
from leaf_tpu.training import checkpoint as jax_ckpt
from leaf_tpu.training.state import TrainState as JaxTrainState
from leaf_tpu_torch import train
from leaf_tpu_torch.models import Classifier, load_jax_variables
from leaf_tpu_torch.models import pretrained
from leaf_tpu_torch.models.common import set_batch_norm_stats_
from leaf_tpu_torch.training import TrainState
from leaf_tpu_torch.training import checkpoint as port_ckpt
from tests.test_torch_port_cuda import make_tiny_exp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR, T = 16000, 16000
LOGIT_TOL = 1e-4
EFFNET = {"frontend": {"name": "leaf", "default_args": False, "n_filters": 8},
          "audio_config": {"sample_rate": SR},
          "model": {"arch": "efficientnet", "model_depth": "b0",
                    "num_classes": 3, "type": "multiclass"}}
R18 = {**EFFNET, "model": {"arch": "resnet", "model_depth": 18,
                           "num_classes": 3, "type": "multiclass"}}
# BatchNorm statistics come from CALIB, logits from X (as in
# tests/test_torch_port_classifier.py)
_RNG = np.random.RandomState(3)
CALIB = torch.from_numpy((_RNG.randn(8, T) * 0.1).astype(np.float32))
X = (_RNG.randn(2, T) * 0.1).astype(np.float32)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    # the test runner shares the cores among its workers: PyTorch's
    # default of one intra-op thread per core oversubscribes them
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _with_classes(cfg, n):
    return {**cfg, "model": {**cfg["model"], "num_classes": n}}


def _port(cfg, seed, perturb_frontend=False, calibrate=False):
    """A port classifier in eval mode; its frontend moved off the
    (seed-free) mel init where asked, its BatchNorm statistics set where
    asked (for logits)."""
    model = Classifier(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(seed)).eval()
    if perturb_frontend:
        g = torch.Generator().manual_seed(seed + 100)
        with torch.no_grad():
            for p in model.features.parameters():
                p.mul_(1 + 0.05 * torch.randn(p.shape, generator=g))
    if calibrate:
        _calibrate(model)
    return model


def _calibrate(model):
    with torch.no_grad():
        set_batch_norm_stats_(model, CALIB)
        for bn in model.modules():
            if isinstance(bn, torch.nn.BatchNorm2d):
                bn.running_var.add_(0.1 * bn.running_var.mean())


def _logits(model):
    with torch.no_grad():
        return model.eval()(torch.from_numpy(X)).numpy()


@functools.lru_cache(maxsize=None)
def _jax_model(arch):
    cfg = {"efficientnet": EFFNET, "resnet": R18}[arch]
    jm = JaxClassifier(cfg=cfg)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((2, T)), train=False))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                      dict(shapes))
    apply = jax.jit(lambda v, x: jm.apply(v, x, train=False))
    return jm, template, apply


def _to_jax(model):
    """The port model's weights as JAX variables (numpy leaves)."""
    arch = model.cfg["model"]["arch"]
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    return import_torch_classifier(sd, _jax_model(arch)[1], arch)


def _from_jax(cfg, variables):
    """A port classifier holding JAX ``variables``."""
    return load_jax_variables(Classifier(cfg, device="cpu").eval(),
                              variables)


def _jax_logits(arch, variables):
    return np.asarray(_jax_model(arch)[2](variables, X))


def _assert_close(got, ref):
    rel = float(np.abs(got - ref).max() / np.abs(ref).max())
    assert rel <= LOGIT_TOL, rel
    assert np.abs(ref).max() > 1e-2   # not a vanished net


def _assert_state_equal(a, b, prefix=""):
    sa, sb = a.state_dict(), b.state_dict()
    keys = [k for k in sa if k.startswith(prefix)]
    assert keys and keys == [k for k in sb if k.startswith(prefix)]
    for k in keys:
        assert torch.equal(sa[k], sb[k]), k


def _assert_state_differs(a, b, prefix):
    sa, sb = a.state_dict(), b.state_dict()
    assert any(not torch.equal(sa[k], sb[k]) for k in sa
               if k.startswith(prefix))


def _clone(cfg, model):
    out = Classifier(cfg, device="cpu").eval()
    out.load_state_dict(model.state_dict())
    return out


# -------------------------------------------------- the converted frontend
@pytest.fixture(scope="module")
def npz_dir(tmp_path_factory):
    """frontend_params.npz of a port classifier with a moved frontend, by
    scripts/convert_torch_checkpoint.py's converter; and that classifier."""
    src = _port(EFFNET, 1, perturb_frontend=True)
    convert = _load_script("convert_torch_checkpoint")
    flat = convert.convert_frontend_state_dict(src.state_dict())
    assert sorted(flat) == ["complex_conv/kernel", "compression/alpha",
                            "compression/delta", "compression/ema/weights",
                            "compression/root", "pooling/bias",
                            "pooling/weights"]
    assert flat["pooling/weights"].shape == (8,)
    out = tmp_path_factory.mktemp("npz")
    np.savez(out / "frontend_params.npz", **flat)
    return out, src


def test_converted_frontend_equals_source_and_jax(npz_dir):
    path, src = npz_dir
    dst = _port(EFFNET, 2)
    fresh = _clone(EFFNET, dst)
    jdst = _to_jax(dst)
    assert port_ckpt.load_converted_frontend(str(path), dst) is dst
    _assert_state_equal(dst, src, "features.")
    _assert_state_equal(dst, fresh, "model.")
    jparams = jax_ckpt.load_converted_frontend(str(path), jdst["params"])
    via_jax = _from_jax(EFFNET, {**jdst, "params": jparams})
    _assert_state_equal(dst, via_jax)
    # statistics for the loaded frontend, the same in both
    _calibrate(dst)
    stats = _to_jax(dst)["batch_stats"]
    _assert_close(_logits(dst), _jax_logits(
        "efficientnet", {"params": jparams, "batch_stats": stats}))


def test_converted_frontend_into_a_leaf(npz_dir):
    path, src = npz_dir
    leaf = Classifier(EFFNET, device="cpu").features
    port_ckpt.load_converted_frontend(str(path), leaf)
    for k, v in src.features.state_dict().items():
        assert torch.equal(leaf.state_dict()[k], v), k


def test_converted_frontend_refuses_misfits(npz_dir, tmp_path):
    path, _ = npz_dir
    wide = Classifier({**EFFNET, "frontend": {**EFFNET["frontend"],
                                              "n_filters": 16}},
                      device="cpu")
    before = {k: v.clone() for k, v in wide.state_dict().items()}
    with pytest.raises(ValueError, match="shape"):
        port_ckpt.load_converted_frontend(str(path), wide)
    for k, v in wide.state_dict().items():   # nothing half-loaded
        assert torch.equal(v, before[k]), k
    with np.load(path / "frontend_params.npz") as f:
        flat = dict(f)
    flat["pooling/scale"] = flat["pooling/bias"]
    np.savez(tmp_path / "frontend_params.npz", **flat)
    with pytest.raises(KeyError, match="pooling/scale"):
        port_ckpt.load_converted_frontend(str(tmp_path), _port(EFFNET, 2))


@pytest.fixture(scope="module")
def port_checkpoint(tmp_path_factory):
    """A port checkpoint directory of a classifier with a moved frontend,
    and that classifier."""
    src = _port(EFFNET, 3, perturb_frontend=True)
    exp = tmp_path_factory.mktemp("exp")
    path = port_ckpt.save_checkpoint(str(exp), TrainState(src, None), 1,
                                     0.5, 0.5, 0.5)
    return path, src


@pytest.mark.parametrize("form", ["", "none", "npz_file", "npz_dir",
                                  "checkpoint", "missing"])
def test_apply_pretrained_frontend_dispatch(form, npz_dir, port_checkpoint,
                                            tmp_path):
    npz, npz_src = npz_dir
    ckpt, ckpt_src = port_checkpoint
    pre = {"": "", "none": "None", "npz_file": str(npz / "frontend_params.npz"),
           "npz_dir": str(npz), "checkpoint": ckpt,
           "missing": str(tmp_path / "nowhere")}[form]
    cfg = {**EFFNET, "frontend": {**EFFNET["frontend"], "pretrained": pre}}
    dst = _port(EFFNET, 2)
    fresh = _clone(EFFNET, dst)
    if form == "missing":
        with pytest.raises(FileNotFoundError, match="nowhere"):
            port_ckpt.apply_pretrained_frontend(cfg, dst)
        with pytest.raises(FileNotFoundError, match="nowhere"):
            jax_ckpt.apply_pretrained_frontend(cfg, {})
        return
    model, path = port_ckpt.apply_pretrained_frontend(cfg, dst)
    assert model is dst
    _assert_state_equal(dst, fresh, "model.")
    if form in ("", "none"):
        assert path is None
        _assert_state_equal(dst, fresh)
        return
    assert path == pre
    src = npz_src if form.startswith("npz") else ckpt_src
    _assert_state_equal(dst, src, "features.")
    if form.startswith("npz"):
        jdst = _to_jax(fresh)
        jparams, jpath = jax_ckpt.apply_pretrained_frontend(cfg,
                                                            jdst["params"])
        assert jpath == pre
        _assert_state_equal(dst, _from_jax(EFFNET, {**jdst,
                                                    "params": jparams}))


# ---------------------------------------------------- the orbax converter
@pytest.fixture(scope="module")
def orbax_pair(tmp_path_factory):
    """A leaf_tpu orbax checkpoint (with hparams.json) of a classifier
    with a moved frontend, its conversion to a port checkpoint, and the
    JAX variables saved."""
    src = _port(EFFNET, 4, perturb_frontend=True, calibrate=True)
    variables = _to_jax(src)
    jm = _jax_model("efficientnet")[0]
    state = JaxTrainState.create(apply_fn=jm.apply,
                                 params=variables["params"],
                                 batch_stats=variables["batch_stats"],
                                 tx=optax.adam(1e-3))
    jexp = tmp_path_factory.mktemp("jax_exp")
    jax_ckpt.save_hparams(str(jexp), EFFNET)
    jpath = jax_ckpt.save_checkpoint(str(jexp), state, 4, 0.9, 0.5, 0.7)
    pexp = tmp_path_factory.mktemp("port_exp")
    ppath = _load_script("leaf_tpu_to_torch_checkpoint").convert(
        jpath, str(pexp))
    return jpath, ppath, variables


def test_orbax_converter_gives_jax_logits(orbax_pair):
    jpath, ppath, variables = orbax_pair
    assert os.path.basename(ppath) == "epoch_004"
    with open(os.path.join(ppath, "meta.json")) as f:
        assert json.load(f) == {"epoch": 4, "tr_loss": 0.9, "tr_acc": 0.5,
                                "val_acc": 0.7}
    exp = os.path.dirname(ppath)
    assert port_ckpt.load_hparams(exp) == EFFNET
    assert port_ckpt.best_checkpoint(exp) == ppath
    model = Classifier(EFFNET, device="cpu")
    state, meta = port_ckpt.load_checkpoint(ppath, TrainState(model, None),
                                            with_opt=False)
    assert state.step == 0 and meta["epoch"] == 4
    _assert_state_equal(model, _from_jax(EFFNET, variables))
    _assert_close(_logits(model), _jax_logits("efficientnet", variables))


def test_checkpoint_loaders_keep_what_jax_keeps(orbax_pair):
    jpath, ppath, variables = orbax_pair
    dst = _port(EFFNET, 5)
    fresh = _clone(EFFNET, dst)
    jdst = _to_jax(dst)
    # the frontend from a checkpoint, as frontend.pretrained
    cfg = {**EFFNET, "frontend": {**EFFNET["frontend"], "pretrained": ppath}}
    port_ckpt.apply_pretrained_frontend(cfg, dst)
    jcfg = {**EFFNET, "frontend": {**EFFNET["frontend"], "pretrained": jpath}}
    jparams, _ = jax_ckpt.apply_pretrained_frontend(jcfg, jdst["params"])
    _assert_state_equal(dst, _from_jax(EFFNET, {**jdst, "params": jparams}))
    _assert_state_differs(dst, fresh, "features.")
    _assert_state_equal(dst, fresh, "model.")
    # the backbone: parameters only, the head kept fresh
    port_ckpt.load_pretrained_backbone(ppath, dst)
    jparams = jax_ckpt.load_pretrained_backbone(jpath, jparams)
    _assert_state_equal(dst, _from_jax(EFFNET, {**jdst, "params": jparams}))
    sd, sf = dst.state_dict(), fresh.state_dict()
    for k in ("model._fc.weight", "model._fc.bias",
              "model._bn0.running_mean", "model._blocks.3._bn1.running_var"):
        assert torch.equal(sd[k], sf[k]), k
    assert not torch.equal(sd["model._blocks.3._depthwise_conv.weight"],
                           sf["model._blocks.3._depthwise_conv.weight"])


# --------------------------------------------- published backbone weights
def _imagenet_state_dict(cfg, dst, stem):
    """A bare ImageNet-layout backbone state_dict (3-channel stem, 1000
    classes) whose other tensors differ from ``dst``'s; its BatchNorm
    statistics are taken with ``dst``'s frontend and stem in place, so
    they fit ``dst`` once loaded."""
    src = _port(_with_classes(cfg, 1000), 11)
    with torch.no_grad():
        src.features.load_state_dict(dst.features.state_dict())
        src.model.get_parameter(stem).copy_(dst.model.get_parameter(stem))
    _calibrate(src)
    sd = {k[len("model."):]: v.clone() for k, v in src.state_dict().items()
          if k.startswith("model.")}
    out = sd[stem].shape[0]
    sd[stem] = torch.randn((out, 3) + tuple(sd[stem].shape[2:]),
                           generator=torch.Generator().manual_seed(0))
    return sd


@pytest.mark.parametrize("arch, stem, head", [
    ("efficientnet", "_conv_stem.weight", "_fc"),
    ("resnet", "conv1.weight", "fc")])
def test_published_backbone_matches_jax_import(arch, stem, head):
    cfg = {"efficientnet": EFFNET, "resnet": R18}[arch]
    dst = _port(cfg, 12)
    fresh = _clone(cfg, dst)
    jdst = _to_jax(dst)
    sd = _imagenet_state_dict(cfg, dst, stem)
    assert pretrained.load_pretrained_backbone(None, dst, arch,
                                               state_dict=sd) is dst
    got, was = dst.state_dict(), fresh.state_dict()
    fresh_keys = {f"model.{stem}", f"model.{head}.weight",
                  f"model.{head}.bias"}
    for k, v in got.items():
        if k.startswith("features.") or k in fresh_keys:
            assert torch.equal(v, was[k]), k
        elif not k.endswith("num_batches_tracked"):
            assert torch.equal(v, sd[k[len("model."):]]), k
    v2 = import_torch_backbone({k: v.numpy() for k, v in sd.items()}, jdst,
                               arch)
    _assert_state_equal(dst, _from_jax(cfg, v2))
    _assert_close(_logits(dst), _jax_logits(arch, v2))


def test_published_backbone_from_a_file_and_by_name(tmp_path, monkeypatch):
    dst = _port(EFFNET, 12)
    sd = _imagenet_state_dict(EFFNET, dst, "_conv_stem.weight")
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}},
               tmp_path / "weights.pth")
    by_file = _clone(EFFNET, dst)
    pretrained.load_pretrained_backbone(str(tmp_path / "weights.pth"),
                                        by_file, "efficientnet")
    by_dict = _clone(EFFNET, dst)
    pretrained.load_pretrained_backbone(None, by_dict, "efficientnet",
                                        state_dict=sd)
    _assert_state_equal(by_file, by_dict)
    # a published name resolves through the cache by its file name
    torch.save(sd, tmp_path / "efficientnet-b0-355c32eb.pth")
    monkeypatch.setattr(pretrained, "_cache_dirs", lambda: [str(tmp_path)])
    by_name = _clone(EFFNET, dst)
    pretrained.load_pretrained_backbone("efficientnet-b0", by_name,
                                        "efficientnet")
    _assert_state_equal(by_name, by_dict)


def test_published_backbone_refusals(tmp_path, monkeypatch):
    dst = _port(EFFNET, 12)
    sd = _imagenet_state_dict(EFFNET, dst, "_conv_stem.weight")
    before = _clone(EFFNET, dst)
    with pytest.raises(KeyError, match="unrecognized.*made_up"):
        pretrained.load_pretrained_backbone(
            None, dst, "efficientnet",
            state_dict={**sd, "made_up.weight": torch.zeros(1)})
    partial = {k: v for k, v in sd.items()
               if k != "_blocks.3._bn1.running_var"}
    with pytest.raises(ValueError, match="unfilled.*_blocks.3._bn1"):
        pretrained.load_pretrained_backbone(None, dst, "efficientnet",
                                            state_dict=partial)
    with pytest.raises(ValueError, match="shape mismatch"):
        pretrained.load_pretrained_backbone(None, dst, "efficientnet",
                                            state_dict=sd, load_fc=True)
    _assert_state_equal(dst, before)   # nothing half-loaded
    with pytest.raises(NotImplementedError, match="densenet"):
        pretrained.load_pretrained_backbone(None, dst, "densenet",
                                            state_dict=sd)
    with pytest.raises(FileNotFoundError, match="efficientnet-b0"):
        pretrained.load_pretrained_backbone("not-a-model", dst,
                                            "efficientnet")


def test_download_failure_names_the_url(tmp_path, monkeypatch):
    calls = []

    def no_net(url, *a, **k):
        calls.append(url)
        raise OSError("network unreachable")

    monkeypatch.setattr(pretrained, "_cache_dirs",
                        lambda: [str(tmp_path / "empty")])
    monkeypatch.setattr(torch.hub, "download_url_to_file", no_net)
    with pytest.raises(FileNotFoundError,
                       match="lukemelas/EfficientNet-PyTorch.*b3"):
        pretrained.load_pretrained_backbone(
            "efficientnet-b3", _port(EFFNET, 12), "efficientnet")
    assert calls == [pretrained.EFFICIENTNET_URLS["efficientnet-b3"]]


# -------------------------------------------------------------- train CLI
@pytest.mark.parametrize("bf16", [False, True])
def test_train_cli_loads_the_frontend_first(tmp_path, monkeypatch, npz_dir,
                                            capsys, bf16):
    npz, _ = npz_dir
    root = make_tiny_exp(tmp_path)
    text = (root / "cfg.cfg").read_text().replace(
        "    n_filters: 8\n", f'    n_filters: 8\n    pretrained: "{npz}"\n')
    (root / "pre.cfg").write_text(text)
    seen = {}
    real = train.apply_pretrained_frontend

    def spy(cfg, model):
        out = real(cfg, model)
        seen["state"] = {k: v.clone() for k, v in model.state_dict().items()}
        seen["params"] = [p.dtype for p in model.parameters()]
        return out

    monkeypatch.setattr(train, "apply_pretrained_frontend", spy)
    train.main(["--cfg_file", str(root / "pre.cfg"), "--expdir",
                str(root / "exp"), "--epochs", "0", "--device", "cpu",
                *(["--bf16"] if bf16 else [])])
    assert f"loaded pretrained frontend from {npz}" in capsys.readouterr().out
    cfg = train.get_config(str(root / "pre.cfg"))
    want = Classifier(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(8881))
    port_ckpt.load_converted_frontend(str(npz), want)
    for k, v in want.state_dict().items():
        assert torch.equal(seen["state"][k], v), k
    assert set(seen["params"]) == {torch.float32}


def test_train_cli_missing_pretrained_raises(tmp_path):
    root = make_tiny_exp(tmp_path)
    text = (root / "cfg.cfg").read_text().replace(
        "    n_filters: 8\n", f'    n_filters: 8\n    pretrained: '
        f'"{tmp_path / "gone"}"\n')
    (root / "pre.cfg").write_text(text)
    with pytest.raises(FileNotFoundError, match="gone"):
        train.main(["--cfg_file", str(root / "pre.cfg"), "--expdir",
                    str(root / "exp"), "--epochs", "0", "--device", "cpu"])

