"""The rest of the model zoo (ResNet with NetVLAD, CIFAR-ResNet, DenseNet,
EfficientNet's remat) in the port, held against the JAX package on the
CPU.

JAX variables (the JAX modules' structure, drawn from a seeded numpy RNG;
the ResNet-18 classifier's from its jitted init) are carried into the
port by ``load_jax_variables``; BatchNorm running stats are set from one seeded
batch in the port (``set_batch_norm_stats_``) and carried back into the
JAX tree, so the logits compared are O(1). Tolerances, with what this
CPU measured when they were set:

- eval logits, f32: max|port − JAX| ≤ 1e-4·max|JAX| (the flagship's
  bound; measured ≤ 6e-6);
- running stats after one train-mode forward: mean to STATS_TOL of the
  layer's largest sd, var to STATS_TOL of its largest var (measured
  ≤ 1e-6);
- three ResNet-18 train steps: the backbone on an image batch at the
  bounds of tests/test_torch_port_train_step.py (loss 2e-4, stats 1e-3,
  update 3e-2); the whole classifier's losses at 2e-4 and its first
  step's gradients, the whole model at 3e-2 and each frontend leaf at
  FRONTEND_GRAD_TOL = 3e-2 (measured 1.19e-2 and ≤ 1.13e-2; its updates
  do not meet 3e-2 even JAX against JAX: see the test);
- remat / memory_efficient on against off, one train step with dropout
  and drop-connect on: loss, every gradient and every running stat
  within REMAT_TOL = 1e-6 of the leaf's norm (measured 0: the recompute
  repeats the forward's ops on the same inputs); a variant that redraws
  the masks, or updates the statistics a second time, reads far above;
- bf16 eval logits: closer to JAX bf16 than JAX bf16 is to JAX f32, as
  in tests/test_torch_port_bf16_model.py (ResNet-18 measured 0.75 of
  JAX's gap, the small DenseNet 0: the CPU convs sum in another order
  than XLA's, and a bf16 rounding that flips once spreads through the
  3×3 convs; DenseNet's are 1×1 and narrow).
"""

import copy
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from leaf_tpu.models import Classifier as JaxClassifier
from leaf_tpu.models import cifar_resnet as jcifar
from leaf_tpu.models import densenet as jdense
from leaf_tpu.models import resnet as jresnet
from leaf_tpu.models.netvlad import NetVLAD as JaxNetVLAD
from leaf_tpu.models.torch_import import import_torch_classifier
from leaf_tpu.training.optim import optimization_helper as jax_optimization
from leaf_tpu.training.state import TrainState as JaxTrainState
from leaf_tpu.training.steps import make_train_step as jax_train_step
from leaf_tpu_torch.models import (Classifier, cifar_resnet, common, densenet,
                                   efficientnet, get_classifier,
                                   load_jax_variables, resnet)
from leaf_tpu_torch.models.common import set_batch_norm_stats_
from leaf_tpu_torch.models.jax_import import _router
from leaf_tpu_torch.models.netvlad import NetVLAD
from leaf_tpu_torch.training import (TrainState, make_train_step,
                                     optimization_helper)

LOGIT_TOL, STATS_TOL, REMAT_TOL = 1e-4, 1e-3, 1e-6
LOSS_TOL, UPDATE_TOL = 2e-4, 3e-2
BF16 = torch.bfloat16
R18_CFG = {"frontend": {"name": "leaf", "default_args": True},
           "audio_config": {"sample_rate": 16000},
           "model": {"arch": "resnet", "model_depth": 18, "num_classes": 35,
                     "pool": "avgpool"}}
IMAGE = (2, 40, 101, 1)   # LEAF's (B, n_filters, frames, 1) at 1 s


def _np_tree(variables):
    return jax.tree_util.tree_map(np.asarray, dict(variables))


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def _bf16_cfg(cfg):
    return {**cfg,
            "frontend": {**cfg["frontend"], "compute_dtype": "bfloat16"},
            "model": {**cfg["model"], "compute_dtype": "bfloat16"}}


def _at(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _stats_pairs(port, jax_vars):
    """(port key, port running stat, JAX batch_stats leaf) for every
    BatchNorm statistic of ``port``."""
    route = _router(port)
    for key, t in port.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            tree, path, _ = route(key)
            assert tree == "batch_stats", key
            yield key, t.detach().float().numpy(), np.asarray(
                _at(jax_vars[tree], path))


def _stats_to_jax(port, jax_vars):
    """A copy of ``jax_vars`` holding the port's running statistics."""
    out = jax.tree_util.tree_map(np.array, jax_vars)
    route = _router(port)
    for key, t, _ in _stats_pairs(port, jax_vars):
        _, path, _ = route(key)
        _at(out["batch_stats"], path[:-1])[path[-1]] = t
    return out


def _stats_err(pairs):
    """Worst mean error / layer's max sd and var error / layer's max var."""
    pairs = list(pairs)
    worst = 0.0
    for key, got, ref in pairs:
        if key.endswith("running_var"):
            worst = max(worst, np.abs(got - ref).max() / ref.max())
        else:
            var = next(r for k, _, r in pairs
                       if k == key[:-len("mean")] + "var")
            worst = max(worst, np.abs(got - ref).max() / np.sqrt(var).max())
    return worst


# ------------------------------------------------------ the backbones

def _backbones():
    """name → (JAX module, port factory(**kw))."""
    return {
        "resnet18": (jresnet.resnet18(num_classes=5),
                     lambda **kw: resnet.resnet18(5, **kw)),
        "resnet18_vlad": (jresnet.resnet18(num_classes=5, pool="vlad"),
                          lambda **kw: resnet.resnet18(5, pool="vlad", **kw)),
        "resnext_small": (
            jresnet.ResNet(block_cls=jresnet.Bottleneck, layers=(1, 1, 1, 1),
                           groups=2, width_per_group=8, num_classes=5),
            lambda **kw: resnet.ResNet(resnet.Bottleneck, (1, 1, 1, 1),
                                       num_classes=5, groups=2,
                                       width_per_group=8, **kw)),
        "cifar_resnet20": (jcifar.resnet20(num_classes=5),
                           lambda **kw: cifar_resnet.resnet20(5, **kw)),
        "densenet_small": (
            jdense.DenseNet(block_config=(2, 2), growth_rate=4,
                            num_init_features=8, num_classes=5),
            lambda **kw: densenet.DenseNet(4, (2, 2), 8, num_classes=5, **kw)),
        "densenet_small_memory_efficient": (
            jdense.DenseNet(block_config=(2, 2), growth_rate=4,
                            num_init_features=8, num_classes=5,
                            memory_efficient=True),
            lambda **kw: densenet.DenseNet(4, (2, 2), 8, num_classes=5,
                                           memory_efficient=True, **kw)),
    }


BACKBONES = tuple(_backbones())


@pytest.fixture(scope="module")
def image():
    return np.random.RandomState(0).randn(*IMAGE).astype("float32")


def _seeded_variables(jm, x, seed: int) -> dict:
    """Variables of ``jm``'s structure drawn from a seeded numpy RNG (its
    init traced for the shapes only, not compiled): kernels
    N(0, 1/fan_in), BatchNorm scales 1 + N(0, 0.1²), biases N(0, 0.1²),
    unit running stats, NetVLAD's centroids U[0, 1)."""
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(x), train=False))
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            a = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "assign_weight":
            a = rng.randn(*shape) / np.sqrt(shape[1])
        elif name == "centroids":
            a = rng.rand(*shape)
        elif name in ("scale", "var"):
            a = 1.0 + (0.1 * rng.randn(*shape) if name == "scale" else 0.0)
            a = np.broadcast_to(a, shape)
        elif name == "mean":
            a = np.zeros(shape)
        else:
            a = 0.1 * rng.randn(*shape)
        return np.array(a, dtype=np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


@pytest.fixture(scope="module")
def backbone_runs(image):
    """name → (JAX module, its initial variables, the same holding the
    port's BN stats, the port module in eval mode holding them)."""
    out = {}
    for seed, (name, (jm, make)) in enumerate(_backbones().items()):
        v = _seeded_variables(jm, image, seed)
        port = load_jax_variables(make(device="cpu"), v).eval()
        calib = np.random.RandomState(1).randn(4, *IMAGE[1:]).astype(
            "float32")
        set_batch_norm_stats_(port, torch.from_numpy(calib))
        out[name] = (jm, v, _stats_to_jax(port, v), port)
    return out


@pytest.mark.parametrize("name", BACKBONES)
def test_backbone_eval_logits_match_jax(backbone_runs, image, name):
    jm, _, v, port = backbone_runs[name]
    ref = np.asarray(jax.jit(lambda vv, x: jm.apply(vv, x, train=False))(
        v, jnp.asarray(image)))
    with torch.no_grad():
        got = port(torch.from_numpy(image)).numpy()
    assert got.shape == ref.shape == (2, 5)
    assert np.abs(ref).max() > 1e-3, np.abs(ref).max()
    assert _rel(got, ref) < LOGIT_TOL, _rel(got, ref)


@pytest.mark.parametrize("name", BACKBONES)
def test_train_mode_running_stats_match_jax(backbone_runs, image, name):
    # one train-mode forward from the same statistics: Flax momentum 0.9
    # (torch 0.1) and the biased batch variance in both
    jm, _, v, port = backbone_runs[name]
    port = copy.deepcopy(port).train()
    _, new = jax.jit(lambda vv, x: jm.apply(vv, x, train=True,
                                            mutable=["batch_stats"]))(
        v, jnp.asarray(image))
    with torch.no_grad():
        port(torch.from_numpy(image), torch.Generator().manual_seed(0))
    pairs = list(_stats_pairs(port, _np_tree(new)))
    assert pairs and _stats_err(pairs) < STATS_TOL, _stats_err(pairs)
    # and the statistics moved: not the ones the fixture set
    _, _, _, before = backbone_runs[name]
    moved = [k for k, t in port.state_dict().items()
             if "running_mean" in k
             and not torch.equal(t, before.state_dict()[k])]
    assert len(moved) == len(pairs) // 2


@pytest.mark.parametrize("name", ["resnet18", "resnet18_vlad",
                                  "cifar_resnet20", "densenet_small"])
def test_load_refuses_partial_extra_or_misshaped(backbone_runs, name):
    _, v, _, port = backbone_runs[name]
    target = copy.deepcopy(port)
    stats_leaf = next(iter(_stats_pairs(port, v)))[0]
    _, path, _ = _router(port)(stats_leaf)
    missing = jax.tree_util.tree_map(np.array, v)
    del _at(missing["batch_stats"], path[:-1])[path[-1]]
    with pytest.raises(KeyError, match="lack"):
        load_jax_variables(target, missing)
    extra = jax.tree_util.tree_map(np.array, v)
    extra["params"]["stray"] = {"kernel": np.zeros(3, "float32")}
    with pytest.raises(KeyError, match="no port tensor"):
        load_jax_variables(target, extra)
    head = {"resnet18": "fc", "resnet18_vlad": "vlad",
            "cifar_resnet20": "linear", "densenet_small": "classifier"}[name]
    bad = jax.tree_util.tree_map(np.array, v)
    leaf = sorted(bad["params"][head])[0]
    bad["params"][head][leaf] = np.zeros(
        bad["params"][head][leaf].shape[:-1] + (7,), "float32")
    with pytest.raises(ValueError, match="shape mismatch"):
        load_jax_variables(target, bad)


# ------------------------------------------------- parameter counts

@pytest.mark.parametrize("build,count", [
    # the JAX suite's numbers (tests/test_models.py), at full width
    (lambda: resnet.resnet18(35, device="cpu"), 11_188_195),
    (lambda: resnet.resnet18(12, pool="vlad", device="cpu"), 11_284_956),
    (lambda: resnet.resnet50(7, device="cpu"), 23_516_103),
    (lambda: densenet.densenet121(35, device="cpu"), 6_983_459),
    (lambda: cifar_resnet.resnet20(35, device="cpu"), 1_077_891),
    (lambda: cifar_resnet.resnet34_custom(4, device="cpu"), 2_200_676),
], ids=["resnet18", "resnet18_vlad", "resnet50", "densenet121",
        "cifar_resnet20", "cifar_resnet34_custom"])
def test_parameter_count_matches_jax_suite(build, count):
    assert sum(p.numel() for p in build().parameters()) == count


# ------------------------------------------------------- init draws

def test_resnet_init_distributions():
    # convs: untruncated kaiming fan-out N(0, 2/(O·kH·kW)); BatchNorm
    # scale N(1, 0.02), bias 0; fc: Flax Dense (lecun-normal at ±2σ)
    m = resnet.resnet18(35, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    big = m.layer4[1].conv2.weight.detach()          # 2.36M draws
    fan_out = big.shape[0] * big[0][0].numel()
    z = big / (2.0 / fan_out) ** 0.5
    assert abs(float(z.std()) - 1.0) < 0.01 and abs(float(z.mean())) < 0.01
    assert float(z.abs().max()) > 4.0     # not truncated at 2σ
    for mod in m.modules():
        if isinstance(mod, common.Conv2d):
            w = mod.weight.detach()
            fan = w.shape[0] * w[0][0].numel()
            assert abs(float(w.std()) * (fan / 2.0) ** 0.5 - 1) < 0.1
    scales = torch.cat([b.weight.detach() for b in m.modules()
                        if isinstance(b, common.BatchNorm2d)])
    assert scales.numel() == 4800
    assert abs(float(scales.mean()) - 1.0) < 2e-3
    assert abs(float(scales.std()) - 0.02) < 2e-3
    assert all(float(b.bias.detach().abs().max()) == 0 for b in m.modules()
               if isinstance(b, common.BatchNorm2d))
    w = m.fc.weight.detach()
    assert float(w.abs().max()) * w.shape[1] ** 0.5 <= 2 / 0.87962566 + 1e-6
    assert abs(float(w.std()) * w.shape[1] ** 0.5 - 1.0) < 0.05
    assert float(m.fc.bias.detach().abs().max()) == 0


def test_zero_init_residual_zeroes_each_blocks_last_bn():
    m = resnet.resnet50(3, zero_init_residual=True, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    for block in (b for stage in (m.layer1, m.layer2, m.layer3, m.layer4)
                  for b in stage):
        assert float(block.bn3.weight.detach().abs().max()) == 0
        assert float((block.bn1.weight.detach() - 1).abs().max()) > 0
    assert float((m.bn1.weight.detach() - 1).abs().max()) > 0


def test_netvlad_init_from_drawn_centroids():
    # assign weight = 2α·c, bias = −α·‖c‖ of the centroids it drew
    # (reference models/netvlad.py:35-41), c ~ U[0, 1)
    v = NetVLAD(num_clusters=16, dim=512, alpha=100.0, device="cpu",
                generator=torch.Generator().manual_seed(3))
    c = v.centroids.detach()
    assert 0.0 <= float(c.min()) and float(c.max()) < 1.0
    assert abs(float(c.mean()) - 0.5) < 0.01
    assert abs(float(c.var()) - 1 / 12) < 3e-3
    assert torch.equal(v.conv.weight.detach()[:, :, 0, 0], 200.0 * c)
    torch.testing.assert_close(v.conv.bias.detach(), -100.0 * c.norm(dim=1))


def test_cifar_and_densenet_init_distributions():
    gen = torch.Generator().manual_seed(0)
    c = cifar_resnet.resnet20(10, device="cpu", generator=gen)
    for mod in c.modules():
        if isinstance(mod, common.BatchNorm2d):     # Flax's: ones, zeros
            assert torch.equal(mod.weight, torch.ones_like(mod.weight))
    w = c.layer3[2].conv2.weight.detach()   # kaiming fan-out, untruncated
    assert abs(float(w.std()) * (w.shape[0] * 9 / 2.0) ** 0.5 - 1) < 0.02
    lin = c.linear.weight.detach()          # fan_out = O for a Dense
    assert abs(float(lin.std()) * (10 / 2.0) ** 0.5 - 1) < 0.1
    assert float(c.linear.bias.detach().abs().max()) == 0
    d = densenet.densenet121(35, device="cpu", generator=gen)
    bound = 2 / 0.87962566 + 1e-6
    layers = [m for m in d.modules()
              if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    assert len(layers) == 121
    for m in layers:                        # lecun-normal, truncated
        w = m.weight.detach()
        assert float(w.abs().max()) * w[0].numel() ** 0.5 <= bound
    w = d.features["denseblock3"]["denselayer24"].conv2.weight.detach()
    assert abs(float(w.std()) * w[0].numel() ** 0.5 - 1) < 0.05


def test_netvlad_matches_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(4, 5, 3, 64).astype("float32")           # (B, H, W, C)
    jm = JaxNetVLAD(num_clusters=8, dim=64)
    v = _np_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    port = load_jax_variables(NetVLAD(8, 64, device="cpu"), v)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    assert got.shape == ref.shape == (4, 8 * 64)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)


# ------------------------------------------- the ResNet-18 classifier

@pytest.fixture(scope="module")
def r18():
    """(JAX classifier, its variables, a batch of 2 one-second clips)."""
    wav = (np.random.RandomState(2).randn(4, 16000) * 0.1).astype("float32")
    jm = JaxClassifier(cfg=R18_CFG)
    v = _np_tree(jax.jit(lambda k, x: jm.init({"params": k}, x,
                                              train=False))(
        jax.random.PRNGKey(0), jnp.asarray(wav)))
    return jm, v, wav


def test_resnet18_classifier_logits_match_jax(r18):
    jm, v, wav = r18
    port = load_jax_variables(Classifier(R18_CFG, device="cpu"), v).eval()
    set_batch_norm_stats_(port, torch.from_numpy(wav))
    v = import_torch_classifier(port.state_dict(), v, "resnet")
    x = (np.random.RandomState(3).randn(2, 16000) * 0.1).astype("float32")
    ref = np.asarray(jax.jit(lambda vv, xx: jm.apply(vv, xx, train=False))(
        v, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (2, 35)
    assert np.abs(ref).max() > 1e-2
    assert _rel(got, ref) < LOGIT_TOL, _rel(got, ref)


@pytest.mark.parametrize("arch,depth", [("resnet", 18), ("cifar_resnet", 20)])
def test_round_trip_through_jax_importer(r18, arch, depth):
    # the JAX package's own routers read the port's state_dict names
    if arch == "resnet":
        _, v, _ = r18
        cfg = R18_CFG
    else:
        cfg = {**R18_CFG, "model": {"arch": arch, "model_depth": depth,
                                    "num_classes": 35}}
        jm = JaxClassifier(cfg=cfg)
        v = _np_tree(jax.jit(lambda k, x: jm.init({"params": k}, x,
                                                  train=False))(
            jax.random.PRNGKey(1), jnp.zeros((1, 16000))))
    port = load_jax_variables(Classifier(cfg, device="cpu"), v)
    back = import_torch_classifier(port.state_dict(), v, arch)
    flat = jax.tree_util.tree_leaves_with_path(v)
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for (path, a), b in zip(flat, jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), a, err_msg=str(path))


def test_resnet18_bf16_eval_matches_jax_bf16(r18):
    # the flagship's bf16 bound and input (tests/test_torch_port_bf16_model
    # .py): unit BN statistics, a 440 Hz tone plus noise
    _, v, _ = r18
    rng = np.random.RandomState(0)
    t = np.arange(16000) / 16000
    wav = (0.3 * np.sin(2 * np.pi * 440 * t)[None]
           + 0.05 * rng.randn(4, 16000)).astype("float32")
    gaps = _bf16_gaps(JaxClassifier(cfg=_bf16_cfg(R18_CFG)),
                      JaxClassifier(cfg=R18_CFG), v, wav,
                      Classifier(_bf16_cfg(R18_CFG), device="cpu"))
    assert gaps[0] < gaps[1], gaps


def _bf16_gaps(jb, jf, v, x, port):
    """(port bf16 vs JAX bf16, JAX bf16 vs JAX f32), of max|JAX f32|."""
    ref_b = np.asarray(jax.jit(lambda vv, xx: jb.apply(vv, xx, train=False))(
        v, jnp.asarray(x)))
    ref_f = np.asarray(jax.jit(lambda vv, xx: jf.apply(vv, xx, train=False))(
        v, jnp.asarray(x)))
    assert ref_b.dtype == jnp.bfloat16
    port = load_jax_variables(port, v).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == BF16 and got.shape == ref_f.shape
    scale = np.abs(ref_f).max()
    port_gap = float(np.abs(got.float().numpy() - ref_b.astype(np.float32))
                     .max() / scale)
    jax_gap = float(np.abs(ref_b.astype(np.float32) - ref_f).max() / scale)
    print(f"port bf16 vs JAX bf16 {port_gap:.3e} of max|logit|, JAX bf16 "
          f"vs JAX f32 {jax_gap:.3e}: ratio {port_gap / jax_gap:.3f}")
    return port_gap, jax_gap


def test_densenet_bf16_eval_matches_jax_bf16(backbone_runs, image):
    kw = dict(block_config=(2, 2), growth_rate=4, num_init_features=8,
              num_classes=5)
    jf, v, _, _ = backbone_runs["densenet_small"]   # unit BN statistics
    gaps = _bf16_gaps(jdense.DenseNet(**kw, dtype=jnp.bfloat16), jf, v, image,
                      densenet.DenseNet(4, (2, 2), 8, num_classes=5,
                                        compute_dtype=BF16, device="cpu"))
    assert gaps[0] < gaps[1], gaps


# -------------------------------------- three ResNet-18 train steps

TRAIN_CFG = {**R18_CFG,
             "opt": {"optimizer": "Adam", "lr": 1e-3, "weight_decay": 1e-4,
                     "scheduler": "warmupcosine", "warmup_epochs": 1}}
STEPS_PER_EPOCH, EPOCHS, STEPS = 2, 10, 3


def _train_both(jm, v0, port, x, y):
    """3 steps of the JAX train step and of the port's (Adam 1e-3,
    coupled L2 1e-4, 2-step warm-up: lr 0, 5e-4, 1e-3) from the same
    variables on one batch; returns (JAX variables, JAX losses, port
    losses, the JAX first step's gradients, the port's by name)."""
    tx, _, _ = jax_optimization(TRAIN_CFG,
                                num_tr_steps_per_epoch=STEPS_PER_EPOCH,
                                num_epochs=EPOCHS)
    js = JaxTrainState.create(apply_fn=jm.apply, params=v0["params"],
                              batch_stats=v0["batch_stats"], tx=tx)
    jstep = jax_train_step(donate=False, watch_histograms=True)
    jlosses, jgrads = [], None
    for _ in range(STEPS):
        js, met = jstep(js, jnp.asarray(x), jnp.asarray(y),
                        jax.random.PRNGKey(1))
        jlosses.append(float(met["loss"]))
        jgrads = jgrads or _np_tree(met["_grads"])
    opt, sched, _, _ = optimization_helper(
        TRAIN_CFG, port.parameters(),
        num_tr_steps_per_epoch=STEPS_PER_EPOCH, num_epochs=EPOCHS)
    state = TrainState(port, opt, sched)
    step = make_train_step(watch_histograms=True)
    losses, grads = [], None
    for _ in range(STEPS):
        met = step(state, torch.from_numpy(x), torch.from_numpy(y))
        losses.append(float(met["loss"]))
        grads = grads or {k: g.detach().clone()
                          for k, g in met["_grads"].items()}
    assert state.step == STEPS and jlosses[2] < jlosses[0]
    return (_np_tree({"params": js.params, "batch_stats": js.batch_stats}),
            jlosses, losses, jgrads, grads)


def _grad_rel(port, grads, jgrads):
    """(‖g − g_JAX‖ / ‖g_JAX‖ over the whole model, the same per frontend
    leaf by name) for the port's gradients ``grads`` by parameter name."""
    route = _router(port)
    num = den = 0.0
    front = {}
    for key, g in grads.items():
        _, path, tf = route(key)
        ref = (tf or (lambda a: a))(np.asarray(_at(jgrads, path)))
        n2 = float(np.sum((g.numpy() - ref) ** 2))
        d2 = float(np.sum(ref ** 2))
        num, den = num + n2, den + d2
        if key.startswith("features."):
            front[key[len("features."):]] = (n2 / d2) ** 0.5
    assert len(front) == 7 and den > 0
    return (num / den) ** 0.5, front


def _update_rel(port, v0, vj, prefix=""):
    """‖Δport − ΔJAX‖ / ‖ΔJAX‖ over the parameters whose key starts with
    ``prefix``, Δ from the initial variables ``v0``."""
    route = _router(port)
    num = den = 0.0
    for key, p in port.named_parameters():
        if not key.startswith(prefix):
            continue
        _, path, tf = route(key)
        tf = tf or (lambda a: a)
        a0 = tf(np.asarray(_at(v0["params"], path)))
        d = p.detach().numpy() - a0
        d_ref = tf(np.asarray(_at(vj["params"], path))) - a0
        num += float(np.sum((d - d_ref) ** 2))
        den += float(np.sum(d_ref ** 2))
    assert den > 0
    return (num / den) ** 0.5


def test_resnet18_backbone_train_steps_track_jax():
    # the train step's ResNet path (BN on batch statistics and their
    # update, the backward, Adam, L2) at the flagship test's bounds, on
    # an image batch
    rng = np.random.RandomState(0)
    x = rng.randn(4, *IMAGE[1:]).astype("float32")
    y = rng.randint(0, 5, 4)
    jm = jresnet.resnet18(num_classes=5)
    v0 = _np_tree(jax.jit(lambda k, xx: jm.init({"params": k}, xx,
                                                train=False))(
        jax.random.PRNGKey(0), jnp.asarray(x)))
    port = load_jax_variables(resnet.resnet18(5, device="cpu"), v0)
    vj, jlosses, losses, _, _ = _train_both(jm, v0, port, x, y)
    for a, b in zip(losses, jlosses):
        assert abs(a - b) / abs(b) < LOSS_TOL, (losses, jlosses)
    pairs = list(_stats_pairs(port, vj))
    assert len(pairs) == 2 * 20
    assert _stats_err(pairs) < STATS_TOL, _stats_err(pairs)
    upd = _update_rel(port, v0, vj)
    print(f"backbone: update rel {upd:.3e}, stats {_stats_err(pairs):.3e}")
    assert upd < UPDATE_TOL, upd


# The whole classifier through the fused frontend op (its plain versions
# on the CPU). Leaf's features are a near-constant image (0.31-0.34), so
# after the stem's BatchNorm some relu inputs sit within f32 noise of
# zero; one that takes the other branch moves the gradient of every layer
# below by ~1 % (a float64 run found the port's f32 gradient flipped in
# layer4.0), and Adam's first steps (lr·sign(g)) turn that into update
# differences of ~0.1: JAX against itself (jit against op by op, the same
# batch) reads update 0.054, above the flagship's 3e-2. So the updates are
# printed, not bounded, and the first step's gradients are held instead:
# measured port vs JAX 1.19e-2 whole, ≤ 1.13e-2 per frontend leaf; JAX
# jit vs op by op 5.3e-4; d_bank or d_windows scaled by 1.05 reads
# 5.2e-2 on its leaf (test_resnet18_gradient_check_sees_a_scaled_backward).
R18_PORT_TRAIN_CFG = {**TRAIN_CFG, "frontend": {**TRAIN_CFG["frontend"],
                                                "use_fused_kernel": "on"}}
FRONTEND_GRAD_TOL = 3e-2


@pytest.fixture(scope="module")
def r18_train(r18):
    """(batch, JAX 3-step results, port 3-step results) of the ResNet-18
    classifier from the same variables."""
    jm, v0, _ = r18
    rng = np.random.RandomState(0)
    x = (rng.randn(4, 16000) * 0.1).astype("float32")
    y = rng.randint(0, 35, 4)
    port = load_jax_variables(Classifier(R18_PORT_TRAIN_CFG, device="cpu"),
                              v0)
    return (x, y), port, _train_both(jm, v0, port, x, y)


def test_resnet18_classifier_train_steps_track_jax(r18, r18_train):
    _, v0, _ = r18
    _, port, (vj, jlosses, losses, jgrads, grads) = r18_train
    for a, b in zip(losses, jlosses):
        assert abs(a - b) / abs(b) < LOSS_TOL, (losses, jlosses)
    whole, front = _grad_rel(port, grads, jgrads)
    print(f"classifier: first step's gradients {whole:.3e}, frontend "
          f"leaves {front}; update rel {_update_rel(port, v0, vj):.3e}, "
          f"frontend {_update_rel(port, v0, vj, 'features.'):.3e}, stats "
          f"{_stats_err(_stats_pairs(port, vj)):.3e}")
    assert whole < UPDATE_TOL, whole
    assert max(front.values()) < FRONTEND_GRAD_TOL, front


@pytest.mark.parametrize("which", [0, 1], ids=["d_bank", "d_windows"])
def test_resnet18_gradient_check_sees_a_scaled_backward(monkeypatch, r18,
                                                        r18_train, which):
    # the fused op's backward with one of its outputs 5 % too large: the
    # gradient check above must fail on that leaf
    from leaf_tpu_torch.ops import fused_frontend as ff
    _, v0, _ = r18
    (x, y), _, (_, _, _, jgrads, _) = r18_train
    plain = ff.fused_bwd_op

    def scaled(*args):
        out = list(plain(*args))
        out[which] = out[which] * 1.05
        return tuple(out)

    monkeypatch.setattr(ff, "fused_bwd_op", scaled)
    port = load_jax_variables(Classifier(R18_PORT_TRAIN_CFG, device="cpu"),
                              v0)
    opt, sched, _, _ = optimization_helper(
        TRAIN_CFG, port.parameters(),
        num_tr_steps_per_epoch=STEPS_PER_EPOCH, num_epochs=EPOCHS)
    met = make_train_step(watch_histograms=True)(
        TrainState(port, opt, sched), torch.from_numpy(x), torch.from_numpy(y))
    _, front = _grad_rel(port, met["_grads"], jgrads)
    leaf = ("_complex_conv._kernel", "_pooling.weights")[which]
    print(f"scaled {leaf}: {front[leaf]:.3e}")
    assert front[leaf] > FRONTEND_GRAD_TOL, front


# ----------------------------------------------------------- remat

def _effnet(remat):
    return efficientnet.EfficientNet(
        "efficientnet-b0", num_classes=5, dropout_rate=0.2,
        drop_connect_rate=0.2, device="cpu", remat=remat,
        generator=torch.Generator().manual_seed(0))


def _densenet_small(remat):
    return densenet.DenseNet(4, (2, 2), 8, drop_rate=0.1, num_classes=5,
                             memory_efficient=remat, device="cpu",
                             generator=torch.Generator().manual_seed(0))


def _one_step(model, x, y, sink):
    """Loss, gradients, running stats and the generator's state after
    one train-mode forward and backward, masks drawn from seed 7 (the
    generator is appended to ``sink`` first)."""
    model.train()
    gen = torch.Generator().manual_seed(7)
    sink.append(gen)
    loss = F.cross_entropy(model(x, gen).float(), y)
    loss.backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    stats = {k: t.clone() for k, t in model.state_dict().items()
             if "running" in k}
    return float(loss), grads, stats, gen.get_state()


def _remat_err(build, sink):
    """Worst ‖on − off‖ / ‖off‖ over the loss, every gradient and every
    running stat, and whether the generators ended alike."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(4, 40, 24, 1).astype("float32"))
    y = torch.from_numpy(rng.randint(0, 5, 4))
    off = _one_step(build(False), x, y, sink)
    on = _one_step(build(True), x, y, sink)
    worst = abs(on[0] - off[0]) / abs(off[0])
    for a, b in ((on[1], off[1]), (on[2], off[2])):
        assert a.keys() == b.keys()
        for k in b:
            den = float(b[k].norm())
            num = float((a[k] - b[k]).norm())
            worst = max(worst, num / den if den else num)
    return worst, torch.equal(on[3], off[3])


@pytest.mark.parametrize("build", [_effnet, _densenet_small],
                         ids=["efficientnet_remat", "densenet_memory_efficient"])
def test_remat_equals_plain(build):
    worst, same_gen = _remat_err(build, [])
    print(f"remat on vs off: worst leaf {worst:.3e} of its norm")
    assert worst <= REMAT_TOL and same_gen, worst


def _faulty_remat(module, fault: str, sink: list):
    """A faulty remat for ``module`` (efficientnet or densenet): the masks
    drawn again inside the checkpoint from the run's generator (the last
    in ``sink``), or torch's plain checkpoint (whose recompute updates
    the running stats a second time)."""
    from torch.utils.checkpoint import checkpoint

    if fault == "stats_updated_twice":
        def plain(mod, fn, *args):
            return checkpoint(fn, *args, use_reentrant=False,
                              preserve_rng_state=False)
        return plain
    if module is efficientnet:
        def redraw(mod, fn, x, rate, keep):
            return common.remat(mod, lambda x_: mod(
                x_, rate, mod.drop_connect_mask(x_, rate, sink[-1])), x)
    else:
        def redraw(mod, fn, x, keep):
            return common.remat(mod, lambda x_: mod(
                x_, mod.dropout_mask(x_, sink[-1])), x)
    return redraw


@pytest.mark.parametrize("fault", ["masks_redrawn", "stats_updated_twice"])
@pytest.mark.parametrize("module,build", [(efficientnet, _effnet),
                                          (densenet, _densenet_small)],
                         ids=["efficientnet_remat",
                              "densenet_memory_efficient"])
def test_remat_check_sees_a_faulty_remat(monkeypatch, module, build, fault):
    sink = []
    monkeypatch.setattr(module, "remat", _faulty_remat(module, fault, sink))
    worst, _ = _remat_err(build, sink)
    print(f"{fault}: worst leaf {worst:.3e} of its norm")
    assert worst > 1e3 * REMAT_TOL, worst


def test_get_classifier_honours_remat():
    opt = {"arch": "efficientnet", "model_depth": "b0", "num_classes": 3}
    assert get_classifier(opt, device="cpu").remat is False
    assert get_classifier({**opt, "remat": True}, device="cpu").remat is True


def test_train_cli_passes_remat_through(tmp_path, monkeypatch, capsys):
    from leaf_tpu_torch import train
    from tests.test_torch_port_cuda import make_tiny_exp
    root = make_tiny_exp(tmp_path)
    cfg = (root / "cfg.cfg").read_text().replace(
        "    model_depth: b0\n", "    model_depth: b0\n    remat: True\n")
    (root / "cfg.cfg").write_text(cfg)
    built = []

    def spy(*args, **kw):
        built.append(Classifier(*args, **kw))
        return built[-1]

    monkeypatch.setattr(train, "Classifier", spy)
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        assert train.main(["--cfg_file", str(root / "cfg.cfg"), "--expdir",
                           str(tmp_path / "exp"), "--epochs", "1",
                           "--num_workers", "1", "--device", "cpu"]) == 0
    finally:
        torch.set_num_threads(before)
    out = capsys.readouterr().out
    m = re.search(r"epoch 0: tr_loss (\S+) ", out)
    assert m and np.isfinite(float(m.group(1))), out[-2000:]
    assert len(built) == 1 and built[0].model.remat is True
    hp = json.loads((tmp_path / "exp" / "hparams.json").read_text())
    assert hp["model"]["remat"] is True
