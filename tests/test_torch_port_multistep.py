"""K train steps per call, watching and histograms (leaf_tpu_torch.training:
``make_train_multistep``, ``make_train_step(watch_norms=,
watch_histograms=)``, ``training.histograms``, ``TrainLogger
.log_histograms``) and the train CLI's ``--steps_per_call`` and watch
flags, on the CPU, against the JAX package.

The flagship cfg with a 16-filter frontend and 5 classes (dropout and
drop-connect off where the port is held against JAX: the RNG streams
differ), Adam with the warm-up cosine schedule; weights carried from one
seeded set through ``load_jax_variables``; batches of 4 seeded clips.

- Histograms: bucket counts and the extremes exactly equal to the JAX
  functions'; the sum to 1e-6 of Σ|x| and the sum of squares to 1e-6
  relative (other summation orders).
- Watch norms: the parameter norms to the JAX step's metrics at 1e-5
  relative (measured ≤ 2e-7); the gradient norms at the train step's
  loss bound, 2e-4 (measured ≤ 6.0e-5: the port's gradients themselves
  differ from XLA's by float noise of that size, the loss by 1.5e-5);
  and every norm to the float64 norm of the port's own tensors at 1e-6.
- K steps per call against JAX's ``make_train_multistep``: the bounds of
  tests/test_torch_port_train_step.py (loss 2e-4, BN stats 1e-3 of the
  layer's scale, the update 3e-2 of its norm, each frontend leaf 1e-2).
- On the CPU the K steps run in turn, so K per call and the train CLI's
  remainder path against all-single steps are port against port: exact.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leaf_tpu.models import Classifier as JaxClassifier
from leaf_tpu.models.torch_import import import_torch_classifier
from leaf_tpu.training import make_train_multistep as jax_multistep
from leaf_tpu.training.histograms import histogram_tree as jax_tree
from leaf_tpu.training.histograms import tensor_histogram as jax_histogram
from leaf_tpu.training.loggers import TrainLogger as JaxLogger
from leaf_tpu.training.optim import optimization_helper as jax_optimization
from leaf_tpu.training.state import TrainState as JaxTrainState
from leaf_tpu.training.steps import make_train_step as jax_train_step
from leaf_tpu_torch import train as train_cli
from leaf_tpu_torch.data import leaf_device_augment
from leaf_tpu_torch.models import Classifier, load_jax_variables
from leaf_tpu_torch.models.jax_import import _router
from leaf_tpu_torch.training import (TrainState, make_train_multistep,
                                     make_train_step, optimization_helper)
from leaf_tpu_torch.training.histograms import histogram_tree, tensor_histogram
from leaf_tpu_torch.training.loggers import TrainLogger
from tests.test_torch_port_cuda import make_tiny_exp

CFG = {"frontend": {"name": "leaf", "n_filters": 16},
       "audio_config": {"sample_rate": 16000},
       "model": {"arch": "efficientnet", "model_depth": "b0",
                 "num_classes": 5, "dropout_rate": 0.0,
                 "drop_connect_rate": 0.0},
       "opt": {"optimizer": "Adam", "lr": 1e-3, "weight_decay": 1e-4,
               "scheduler": "warmupcosine", "warmup_epochs": 1}}
STEPS_PER_EPOCH, EPOCHS, K, B = 2, 10, 3, 4
LOSS_TOL, STATS_TOL, UPDATE_TOL, FRONTEND_TOL = 2e-4, 1e-3, 3e-2, 1e-2
NORM_TOL, GRAD_NORM_TOL, MOMENT_TOL = 1e-5, 2e-4, 1e-6


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads, as tests/test_torch_port_cli.py runs its
    CLIs: the test runner shares the cores among its workers, and torch's
    default of one thread per core oversubscribes them (its many small
    ops then wait on each other's threads)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np_tree(v):
    return jax.tree_util.tree_map(np.asarray, dict(v))


@functools.lru_cache(maxsize=None)
def _classifier_route():
    """Port name → JAX path for CFG's classifier (the router dispatches on
    the backbone's type)."""
    return _router(Classifier(CFG, device="cpu"))


def _jax_name(port_name: str) -> str:
    tree, path, _ = _classifier_route()(port_name)
    return "/".join((tree,) + path)


@functools.lru_cache(maxsize=None)
def _variables():
    """JAX variables of seeded port weights (through the JAX importer)."""
    jm = JaxClassifier(cfg=CFG)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                            jnp.zeros((2, 16000)),
                                            train=False))
    template = jax.tree_util.tree_map(lambda t: np.zeros(t.shape, t.dtype),
                                      dict(shapes))
    seeded = Classifier(CFG, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    return import_torch_classifier(seeded.state_dict(), template,
                                   "efficientnet")


def _port_state(**opt_kw):
    model = load_jax_variables(Classifier(CFG, device="cpu"), _variables())
    opt, sched, _, _ = optimization_helper(
        CFG, model.parameters(), num_tr_steps_per_epoch=STEPS_PER_EPOCH,
        num_epochs=EPOCHS, **opt_kw)
    return TrainState(model, opt, sched)


def _jax_state():
    jm = JaxClassifier(cfg=CFG)
    v = _variables()
    tx, _, _ = jax_optimization(CFG, num_tr_steps_per_epoch=STEPS_PER_EPOCH,
                                num_epochs=EPOCHS)
    return JaxTrainState.create(apply_fn=jm.apply, params=v["params"],
                                batch_stats=v["batch_stats"], tx=tx)


def _batches(seed, k=K):
    rng = np.random.RandomState(seed)
    return ((rng.randn(k, B, 16000) * 0.1).astype(np.float32),
            rng.randint(0, 5, (k, B)).astype(np.int64))


# ------------------------------------------------------------ histograms

_TENSORS = {
    "normal": lambda r: r.randn(1000),
    "uniform_2d": lambda r: r.rand(37, 5),
    "constant": lambda r: np.full((4, 4), 3.7),
    "large_constant": lambda r: np.full(9, -2.5e4),
    "single": lambda r: np.array([1.5]),
    "wide": lambda r: r.randn(300) * 1e3 + 7.0,
}


def _moments_close(got, ref, abs_sum: float, name: str) -> None:
    """The sum to MOMENT_TOL of Σ|x| (it may cancel), the sum of squares
    to MOMENT_TOL relative."""
    assert abs(float(got[0]) - float(ref[0])) <= MOMENT_TOL * abs_sum, name
    np.testing.assert_allclose(float(got[1]), float(ref[1]),
                               rtol=MOMENT_TOL, err_msg=name)


@pytest.mark.parametrize("bins", [64, 7])
@pytest.mark.parametrize("name", list(_TENSORS))
def test_tensor_histogram_matches_jax(name, bins):
    a = _TENSORS[name](np.random.RandomState(len(name))).astype(np.float32)
    got = tensor_histogram(torch.from_numpy(a), bins)
    ref = [np.asarray(t) for t in jax_histogram(jnp.asarray(a), bins)]
    assert got[0].dtype == torch.int32 and got[0].shape == (bins,)
    np.testing.assert_array_equal(got[0].numpy(), ref[0])
    assert int(got[0].sum()) == a.size
    for g, r in zip(got[1:3], ref[1:3]):       # lo, hi
        assert float(g) == float(r)
    _moments_close(got[3:], ref[3:], np.abs(a).sum(), name)


def test_histogram_tree_matches_jax():
    # the frontend's parameters (PCEN's alpha, delta and root are constant
    # tensors) and some of the backbone's, by name
    model = load_jax_variables(Classifier(CFG, device="cpu"), _variables())
    params = {n: p for n, p in model.named_parameters()
              if n.startswith(("features.", "model._conv_stem.",
                               "model._bn0.", "model._blocks.0.",
                               "model._fc."))}
    got = histogram_tree(params, prefix="params/")
    flat = jax.tree_util.tree_flatten_with_path(_variables()["params"])[0]
    jax_params = {"/".join(k.key for k in path): v for path, v in flat}
    ref = jax_tree({_jax_name(n)[7:]: jax_params[_jax_name(n)[7:]]
                    for n in params}, prefix="params/")
    assert len(got) == len(ref) == len(params) > 12
    for name, p in params.items():
        counts, lo, hi, s, ssq = got["params/" + name.replace(".", "/")]
        r = [np.asarray(t) for t in ref["params/" + _jax_name(name)[7:]]]
        np.testing.assert_array_equal(counts.numpy(), r[0], err_msg=name)
        assert (float(lo), float(hi)) == (float(r[1]), float(r[2])), name
        _moments_close((s, ssq), r[3:], float(p.detach().abs().sum()),
                       name)


class _Board:
    """Records what a tensorboard writer is handed."""

    def __init__(self):
        self.calls = []

    def add_histogram_raw(self, tag, **kw):
        self.calls.append((tag, kw))


def test_log_histograms_matches_jax(tmp_path):
    loggers = {}
    for name, cls in (("jax", JaxLogger), ("port", TrainLogger)):
        logger = cls(str(tmp_path / name), use_tensorboard=False)
        logger.tb = _Board()
        loggers[name] = logger
    arrays = {n: f(np.random.RandomState(3)).astype(np.float32)
              for n, f in _TENSORS.items()}
    loggers["jax"].log_histograms(
        {n: jax_histogram(jnp.asarray(a)) for n, a in arrays.items()}, 5)
    loggers["port"].log_histograms(
        {n: tensor_histogram(torch.from_numpy(a)) for n, a in arrays.items()},
        5)
    ref, got = loggers["jax"].tb.calls, loggers["port"].tb.calls
    assert [t for t, _ in got] == [t for t, _ in ref] == list(arrays)
    for (tag, kw), (_, kw_ref) in zip(got, ref):
        assert kw["bucket_counts"] == kw_ref["bucket_counts"], tag
        assert (kw["num"], kw["global_step"]) == (kw_ref["num"], 5)
        np.testing.assert_allclose(
            [kw["min"], kw["max"]] + kw["bucket_limits"],
            [kw_ref["min"], kw_ref["max"]] + kw_ref["bucket_limits"],
            rtol=1e-12, err_msg=tag)
        # a constant tensor's edges widened relative to its value
        assert kw["max"] > kw["min"], tag
        np.testing.assert_allclose([kw["sum"], kw["sum_squares"]],
                                   [kw_ref["sum"], kw_ref["sum_squares"]],
                                   rtol=MOMENT_TOL, err_msg=tag)


# --------------------------------------------------------------- watching

def test_watch_norms_match_jax():
    x, y = _batches(1, 2)
    js = _jax_state()
    jstep = jax_train_step(donate=False, watch_norms=True,
                           watch_histograms=True)
    st = _port_state()
    step = make_train_step(watch_norms=True, watch_histograms=True)
    for i in range(2):   # lr 0 on the first step, 5e-4 on the second
        js, jm = jstep(js, jnp.asarray(x[i]), jnp.asarray(y[i]),
                       jax.random.PRNGKey(1))
        m = step(st, torch.from_numpy(x[i]), torch.from_numpy(y[i]))
        norms = sorted(k for k in jm if "norm" in k)
        assert norms == sorted(k for k in m if "norm" in k) == [
            "grad_norm", "grad_norm/features", "grad_norm/model",
            "param_norm", "param_norm/features", "param_norm/model"]
        for k in norms:
            tol = GRAD_NORM_TOL if k.startswith("grad") else NORM_TOL
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=tol,
                                       err_msg=k)
        grads = m["_grads"]
        assert list(grads) == [n for n, _ in st.model.named_parameters()]
        for n, p in st.model.named_parameters():
            assert grads[n] is p.grad
        # the norms of the port's own gradients and parameters, in float64
        for kind, tensors in (("grad", grads),
                              ("param", dict(st.model.named_parameters()))):
            for top in ("", "/features", "/model"):
                sq = sum(float((t.detach().double() ** 2).sum())
                         for n, t in tensors.items()
                         if n.startswith(top[1:]))
                np.testing.assert_allclose(float(m[f"{kind}_norm{top}"]),
                                           sq ** 0.5, rtol=1e-6)


# ------------------------------------------------------ K steps per call

def _held_to_jax(port_model, jax_state, losses, jax_losses):
    """The train-step test's comparisons of a port run with a JAX run from
    the same weights."""
    for a, b in zip(losses, jax_losses):
        assert abs(a - b) / abs(b) < LOSS_TOL, (losses, jax_losses)
    v0 = _variables()
    back = import_torch_classifier(port_model.state_dict(), v0,
                                   "efficientnet")
    num = den = 0.0
    for a, b, c in zip(jax.tree_util.tree_leaves(back["params"]),
                       jax.tree_util.tree_leaves(_np_tree(jax_state.params)),
                       jax.tree_util.tree_leaves(v0["params"])):
        num += float(np.sum(((a - c) - (b - c)) ** 2))
        den += float(np.sum((b - c) ** 2))
    assert den > 0 and (num / den) ** 0.5 < UPDATE_TOL, (num / den) ** 0.5
    ref = load_jax_variables(Classifier(CFG, device="cpu"),
                             {"params": _np_tree(jax_state.params),
                              "batch_stats": _np_tree(jax_state.batch_stats)})
    p0 = dict(load_jax_variables(Classifier(CFG, device="cpu"),
                                 v0).named_parameters())
    ref_params = dict(ref.named_parameters())
    front = {}
    for name, p in port_model.named_parameters():
        if name.startswith("features."):
            d = p.detach() - p0[name].detach()
            d_ref = ref_params[name].detach() - p0[name].detach()
            front[name] = float((d - d_ref).norm() / d_ref.norm())
    assert len(front) == 7 and max(front.values()) < FRONTEND_TOL, front
    ref_mods = dict(ref.named_modules())
    for name, mod in port_model.named_modules():
        if isinstance(mod, torch.nn.BatchNorm2d):
            r = ref_mods[name]
            sd, var = r.running_var.sqrt().max(), r.running_var.max()
            assert float((mod.running_mean - r.running_mean).abs().max()
                         / sd) < STATS_TOL, name
            assert float((mod.running_var - r.running_var).abs().max()
                         / var) < STATS_TOL, name


def test_multistep_matches_jax_multistep():
    xs, ys = _batches(2)
    js = _jax_state()
    jmulti = jax_multistep(K, donate=False)
    js, jm = jmulti(js, jnp.asarray(xs), jnp.asarray(ys.astype(np.int32)),
                    jax.random.PRNGKey(1))
    st = _port_state()
    multi = make_train_multistep(K)
    m = multi(st, torch.from_numpy(xs), torch.from_numpy(ys))
    assert st.step == int(js.step) == K
    assert int(m["correct"]) == int(jm["correct"])
    assert int(m["count"]) == int(jm["count"]) == K * B
    _held_to_jax(st.model, js, [float(m["loss"])], [float(jm["loss"])])


def test_multistep_matches_k_single_steps():
    # augment, dropout and drop-connect on: the same draws in the same
    # order from one generator
    cfg = {**CFG, "model": {**CFG["model"], "dropout_rate": 0.2,
                            "drop_connect_rate": 0.2}}
    xs, ys = _batches(3)
    runs = []
    for k in (K, 1):
        model = load_jax_variables(Classifier(cfg, device="cpu"),
                                   _variables())
        opt, sched, _, _ = optimization_helper(
            cfg, model.parameters(), num_tr_steps_per_epoch=STEPS_PER_EPOCH,
            num_epochs=EPOCHS)
        st = TrainState(model, opt, sched)
        gen = torch.Generator().manual_seed(4)
        if k == K:
            m = make_train_multistep(K, augment_fn=leaf_device_augment)(
                st, torch.from_numpy(xs), torch.from_numpy(ys), gen)
            loss = float(m["loss"])
        else:
            step = make_train_step(augment_fn=leaf_device_augment)
            ms = [step(st, torch.from_numpy(xs[i]), torch.from_numpy(ys[i]),
                       gen) for i in range(K)]
            m = {"correct": sum(int(v["correct"]) for v in ms),
                 "count": sum(int(v["count"]) for v in ms)}
            loss = float(torch.stack([v["loss"] for v in ms]).mean())
        runs.append((st, loss, int(m["correct"]), int(m["count"])))
    (a, *ma), (b, *mb) = runs
    assert a.step == b.step == K and ma == mb
    assert a.scheduler.last_epoch == b.scheduler.last_epoch == K
    for (n, p), q in zip(a.model.state_dict().items(),
                         b.model.state_dict().values()):
        torch.testing.assert_close(p, q, rtol=0, atol=0, msg=n)


def test_multistep_refuses_a_wrong_group():
    multi = make_train_multistep(2)
    with pytest.raises(ValueError, match="2 stacked batches"):
        multi(_port_state(), torch.zeros(3, B, 16000),
              torch.zeros(3, B, dtype=torch.int64))
    with pytest.raises(ValueError, match="≥ 1"):
        make_train_multistep(0)


def test_remainder_path_with_augment_and_wire():
    # the train CLI's epoch shape: K-groups, then the remainder as single
    # steps (train._group_feed), int16 wire batches and the device augment
    # against all-single steps
    rng = np.random.RandomState(5)
    batches = [((rng.randn(B, 16000) * 3000).astype(np.int16),
                rng.randint(0, 5, B).astype(np.int64)) for _ in range(5)]
    runs = []
    for k in (2, 1):
        st = _port_state()
        gen = torch.Generator().manual_seed(6)
        step = make_train_step(augment_fn=leaf_device_augment)
        multi = make_train_multistep(2, augment_fn=leaf_device_augment)
        tags, loss = [], 0.0
        for tag, payload in train_cli._group_feed(iter(batches), k):
            tags.append(tag)
            if tag == "multi":
                xs = torch.from_numpy(np.stack([b[0] for b in payload]))
                ys = torch.from_numpy(np.stack([b[1] for b in payload]))
                loss += float(multi(st, xs, ys, gen)["loss"]) * 2
            else:
                loss += float(step(st, *map(torch.from_numpy, payload),
                                   gen)["loss"])
        runs.append((tags, st, loss))
    assert runs[0][0] == ["multi", "multi", "single"]
    assert runs[1][0] == ["single"] * 5
    assert runs[0][1].step == runs[1][1].step == 5
    assert runs[0][2] == pytest.approx(runs[1][2], rel=1e-6)
    for p, q in zip(runs[0][1].model.parameters(),
                    runs[1][1].model.parameters()):
        torch.testing.assert_close(p, q, rtol=0, atol=0)


# -------------------------------------------------------------- the CLI

@pytest.fixture(scope="module")
def tiny_exp(tmp_path_factory):
    return make_tiny_exp(tmp_path_factory.mktemp("tiny"))


def _train(root, expdir, *extra):
    return train_cli.main([
        "--cfg_file", str(root / "cfg.cfg"), "--expdir", str(expdir),
        "--epochs", "1", "--num_workers", "1", "--log_steps", "2",
        "--device", "cpu", *extra])


def _epoch_line(out: str) -> str:
    return next(line for line in out.splitlines()
                if line.startswith("epoch 0: "))


def test_cli_steps_per_call(tiny_exp, tmp_path, capsys):
    # 6 steps per epoch: one group of 4, then 2 single steps (logged where
    # a call crosses a multiple of --log_steps 2); on the CPU the same
    # numbers as --steps_per_call 1
    assert _train(tiny_exp, tmp_path / "k4", "--steps_per_call", "4") == 0
    k4 = capsys.readouterr().out
    assert _train(tiny_exp, tmp_path / "k1") == 0
    k1 = capsys.readouterr().out
    assert [line.split(" rate")[0] for line in k4.splitlines()
            if " rate " in line] == ["epoch 0 step 3/6", "epoch 0 step 4/6"]
    line4, line1 = _epoch_line(k4), _epoch_line(k1)
    assert line4.split(" (")[0] == line1.split(" (")[0]   # losses, acc
    assert line4.split("kernels ")[1] == line1.split("kernels ")[1]
    assert os.path.exists(tmp_path / "k4" / "epoch_000" / "state.pt")


def test_cli_watch_histograms(tiny_exp, tmp_path, capsys, monkeypatch):
    scalars, hists = [], []
    monkeypatch.setattr(TrainLogger, "log_scalars",
                        lambda self, s, step: scalars.append((step, s)))
    monkeypatch.setattr(TrainLogger, "log_histograms",
                        lambda self, h, step: hists.append((step, h)))
    assert _train(tiny_exp, tmp_path / "w", "--watch_histograms",
                  "--steps_per_call", "4") == 0
    out = capsys.readouterr().out
    assert "--steps_per_call forced to 1" in out
    watched = [(step, s) for step, s in scalars if "watch/grad_norm" in s]
    assert [step for step, _ in watched] == [0, 2, 4] == [
        step for step, _ in hists]
    assert set(watched[0][1]) == {
        f"watch/{k}_norm{t}" for k in ("grad", "param")
        for t in ("", "/features", "/model")}
    model = Classifier(train_cli.get_config(str(tiny_exp / "cfg.cfg")),
                       device="cpu")
    names = [n.replace(".", "/") for n, _ in model.named_parameters()]
    _, h = hists[0]
    assert sorted(h) == sorted([f"params/{n}" for n in names]
                               + [f"grads/{n}" for n in names])
    for name, p in model.named_parameters():
        assert int(h["grads/" + name.replace(".", "/")][0].sum()) == \
            p.numel()
