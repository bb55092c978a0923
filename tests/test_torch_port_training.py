"""The port's training slice held against the JAX package, piece by piece.

Same inputs, made with numpy from a seed, go through the JAX function and
its port on the CPU:

- frontend parameter gradients (Gabor bank through its constraint, lowpass
  windows, PCEN and its EMA, the whole Leaf 'off'): rel-norm 1e-5 for the
  single functions (tests/test_ops.py's gradient tolerance) and 1e-4 for
  the whole Leaf (test_ops.py:151-169);
- an MBConv block in train mode (output, updated batch_stats, parameter
  gradients) vs ``apply(..., train=True, mutable=["batch_stats"])``:
  atol/rtol 1e-5 on values, rel-norm 1e-4 on gradients;
- optimizer, schedules, losses, eval step and batch padding: equal to the
  JAX package's up to float32 rounding (optax and the JAX schedules run in
  float32: rtol 1e-5 on lr values, 2e-6 on parameters);
- drop-connect, dropout, the device augment and mixup draw from torch
  generators, whose numbers differ from jax.random's: held by their
  distributions on large seeded batches (frequencies within 5 binomial
  standard deviations, ranges exact).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from leaf_tpu.data import device_augment as jaug
from leaf_tpu.frontend import Leaf as JaxLeaf
from leaf_tpu.frontend import impulse_responses as jir
from leaf_tpu.frontend import postprocessing as jpost
from leaf_tpu.frontend.convolution import gabor_constraint as jconstraint
from leaf_tpu.models import efficientnet as jeff
from leaf_tpu.training import optim as joptim
from leaf_tpu.training import steps as jsteps
from leaf_tpu.training.state import TrainState as JaxTrainState
from leaf_tpu_torch.data import leaf_device_augment, peak_normalize
from leaf_tpu_torch.frontend import Leaf
from leaf_tpu_torch.frontend import impulse_responses, postprocessing
from leaf_tpu_torch.frontend.convolution import GaborConv1d, gabor_constraint
from leaf_tpu_torch.frontend.pooling import GaussianLowPass
from leaf_tpu_torch.models import efficientnet as eff
from leaf_tpu_torch.models import load_jax_variables
from leaf_tpu_torch.models.common import (BatchNorm2d, apply_keep, dropout,
                                          keep_mask)
from leaf_tpu_torch.models.jax_import import _block_route, _frontend_route
from leaf_tpu_torch.training import (ReduceLROnPlateau, TrainState,
                                     bce_logits_loss, cross_entropy_loss,
                                     make_eval_step, make_train_step, mixup,
                                     optimization_helper,
                                     pad_batch_to_multiple, step_schedule,
                                     warmup_cosine_schedule,
                                     waveform_from_wire)

K = 401


def _np_tree(variables):
    return jax.tree_util.tree_map(np.asarray, dict(variables))


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _within_binomial(hits: int, n: int, p: float) -> bool:
    return abs(hits - n * p) <= 5 * np.sqrt(n * p * (1 - p))


def _assert_grads(module, jax_grads, route, tol):
    """Every parameter's .grad vs the JAX gradient tree (through the
    port's JAX layout map), rel-norm < tol."""
    names = [n for n, _ in module.named_parameters()]
    assert len(names) == len(jax.tree_util.tree_leaves(jax_grads)), names
    for name, p in module.named_parameters():
        tree, path, transform = route(name)
        ref = jax_grads[tree]
        for k in path:
            ref = ref[k]
        ref = np.asarray(ref)
        if transform is not None:
            ref = transform(ref)
        got = p.grad.numpy().reshape(ref.shape)
        assert _rel(got, ref) < tol, (name, _rel(got, ref))


# ------------------------------------------------------------ frontend

class TestFrontendGradients:
    def test_gabor_bank_through_constraint(self):
        conv = GaborConv1d(80, K, device="cpu")
        kernel = conv._kernel.detach().numpy()
        r = np.random.RandomState(0).randn(K, 80).astype("float32")

        def jloss(k):
            re, im = jir.gabor_filters_real_imag(jconstraint(k, K), K)
            return jnp.sum(jnp.asarray(r) * jnp.concatenate([re, im], 0).T)

        ref = jax.grad(jloss)(jnp.asarray(kernel))
        (_t(r) * conv.emit_filters()).sum().backward()
        assert _rel(conv._kernel.grad.numpy(), ref) < 1e-5

    def test_mel_init_puts_no_parameter_on_a_clip_bound(self):
        # jnp.clip passes half the gradient where a value equals a bound,
        # torch.clamp all of it; the flagship's init has no such tie (nor
        # the lowpass width 0.4 in [2/401, 0.5], nor PCEN's α 0.96 ≤ 1,
        # root 2 ≥ 1 or EMA weight 0.04 in [0, 1])
        k = Leaf(device="cpu")._complex_conv._kernel.detach()
        sq = torch.sqrt(2.0 * torch.log(torch.tensor(2.0)))
        bounds = {0: (0.0, float(np.float32(np.pi))),
                  1: (float(4.0 * sq / np.pi), float(K * sq / np.pi))}
        for col, (lo, hi) in bounds.items():
            assert bool((k[:, col] > lo).all() and (k[:, col] < hi).all())
        np.testing.assert_array_equal(gabor_constraint(k, K).numpy(),
                                      k.numpy())

    def test_lowpass_windows(self):
        rng = np.random.RandomState(2)
        w = rng.uniform(0.05, 0.6, 40).astype("float32")  # some above 0.5
        r = rng.randn(40, K).astype("float32")
        ref = jax.grad(lambda s: jnp.sum(jnp.asarray(r)
                                         * jir.gaussian_lowpass(s, K)))(
            jnp.asarray(w))
        pool = GaussianLowPass(40, K, strides=160, device="cpu")
        with torch.no_grad():
            pool.weights.copy_(_t(w).reshape(1, 1, 40, 1))
        (_t(r) * pool.emit_windows()[0]).sum().backward()
        assert _rel(pool.weights.grad.numpy().reshape(-1), ref) < 1e-5

    def test_pcen(self):
        rng = np.random.RandomState(3)
        x = (rng.rand(2, 100, 40) + 1e-3).astype("float32")
        r = rng.randn(2, 100, 40).astype("float32")
        jm = jpost.PCENLayer(in_channels=40, floor=1e-12)
        v = _np_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
        p = v["params"]
        p["alpha"] = rng.uniform(0.8, 1.1, 40).astype("float32")
        p["root"] = rng.uniform(0.9, 3.0, 40).astype("float32")
        p["ema"]["weights"] = rng.uniform(0.01, 0.2, 40).astype("float32")

        def jloss(params, xx):
            return jnp.sum(jnp.asarray(r) * jm.apply({"params": params}, xx))

        gp, gx = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
        pm = postprocessing.PCENLayer(40, floor=1e-12, device="cpu")
        with torch.no_grad():
            for name in ("alpha", "delta", "root"):
                getattr(pm, name).copy_(_t(p[name]))
            pm.ema._weights.copy_(_t(p["ema"]["weights"]))
        xt = _t(x).requires_grad_()
        (_t(r) * pm(xt)).sum().backward()
        assert _rel(xt.grad.numpy(), gx) < 1e-5
        for name in ("alpha", "delta", "root"):
            assert _rel(getattr(pm, name).grad.numpy(), gp[name]) < 1e-5, name
        assert _rel(pm.ema._weights.grad.numpy(), gp["ema"]["weights"]) < 1e-5

    def test_ema_matmul(self):
        rng = np.random.RandomState(4)
        x = rng.rand(2, 100, 8).astype("float32")
        w = rng.uniform(0.01, 0.5, 8).astype("float32")
        r = rng.randn(2, 100, 8).astype("float32")
        gx, gw = jax.grad(lambda a, b: jnp.sum(jnp.asarray(r)
                                               * jpost.ema_matmul(a, b)),
                          argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
        xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
        (_t(r) * postprocessing.ema_matmul(xt, wt)).sum().backward()
        assert _rel(xt.grad.numpy(), gx) < 1e-5
        assert _rel(wt.grad.numpy(), gw) < 1e-5

    def test_leaf_off(self):
        x = (np.random.RandomState(5).randn(2, 16000) * 0.1).astype("float32")
        jm = JaxLeaf(use_fused_kernel="off")
        v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
        ref = jax.grad(lambda p: jnp.mean(jm.apply(p, jnp.asarray(x)) ** 2))(v)
        pm = load_jax_variables(Leaf(use_fused_kernel="off", device="cpu"),
                                _np_tree(v))
        torch.mean(pm(_t(x)) ** 2).backward()
        _assert_grads(pm, ref, _frontend_route, 1e-4)


# -------------------------------------------------------------- models

def test_batch_norm_keeps_flax_running_variance():
    rng = np.random.RandomState(6)
    x = _t(rng.randn(8, 3, 5, 7) * 2.0 + 1.0)
    bn = BatchNorm2d(3, eps=1e-3, momentum=0.01)
    out = bn(x)
    var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
    torch.testing.assert_close(bn.running_mean, 0.01 * mean)
    torch.testing.assert_close(bn.running_var, 0.99 + 0.01 * var)
    ref = (x - mean[:, None, None]) / torch.sqrt(var[:, None, None] + 1e-3)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    assert set(bn.state_dict()) == set(torch.nn.BatchNorm2d(3).state_dict())


@pytest.mark.parametrize("stride,out_f", [(1, 16), (2, 24)])
def test_mbconv_train_mode_matches_jax(stride, out_f):
    """One narrow MBConv (expand, depthwise, SE; identity skip at stride 1)
    in train mode: output, updated batch_stats, every parameter gradient."""
    ba = jeff.BlockArgs(num_repeat=1, kernel_size=3, stride=stride,
                        expand_ratio=6, input_filters=16, output_filters=out_f,
                        se_ratio=0.25)
    rng = np.random.RandomState(7)
    x = rng.randn(4, 9, 12, 16).astype("float32")
    jm = jeff.MBConvBlock(block_args=ba, bn_momentum=0.99, bn_epsilon=1e-3)
    v = _np_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 2.0, a.shape).astype("float32"),
        v["batch_stats"])
    out_shape = jax.eval_shape(lambda: jm.apply(v, jnp.asarray(x),
                                                train=False)).shape
    r = rng.randn(*out_shape).astype("float32")

    def jloss(params):
        out, mut = jm.apply({"params": params,
                             "batch_stats": v["batch_stats"]},
                            jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
        return jnp.sum(jnp.asarray(r) * out), (out, mut["batch_stats"])

    (_, (ref, stats)), grads = jax.value_and_grad(jloss, has_aux=True)(
        v["params"])
    pm = load_jax_variables(
        eff.MBConvBlock(eff.BlockArgs(**ba.__dict__), 0.99, 1e-3), v).train()
    got = pm(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    (_t(r) * got).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)
    for name in ("_bn0", "_bn1", "_bn2"):
        bn, js = getattr(pm, name), stats[name[1:]]
        np.testing.assert_allclose(bn.running_mean.numpy(), js["mean"],
                                   atol=1e-6, rtol=1e-5)
        np.testing.assert_allclose(bn.running_var.numpy(), js["var"],
                                   atol=1e-6, rtol=1e-5)
    _assert_grads(pm, {"params": grads}, _block_route, 1e-4)


def test_efficientnet_train_mode_rates(monkeypatch):
    """Drop-connect only on identity-skip blocks at rate·idx/n; neither
    drop-connect nor dropout in eval mode."""
    m = eff.EfficientNet(num_classes=5, dropout_rate=0.5,
                         drop_connect_rate=0.4, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    seen = []

    def spy(shape, rate, x, generator=None):
        # the block draws its drop-connect mask before its branch, so
        # that a remat recompute can reuse it
        seen.append(rate)
        return keep_mask(shape, rate, x, generator)

    monkeypatch.setattr(eff, "keep_mask", spy)
    x = torch.randn(2, 40, 100, 1)
    out = m.train()(x, torch.Generator().manual_seed(1))
    assert out.shape == (2, 5) and bool(torch.isfinite(out).all())
    n = len(m._blocks)
    skip = [i for i, b in enumerate(m._blocks)
            if b.block_args.stride == 1
            and b.block_args.input_filters == b.block_args.output_filters]
    assert seen == pytest.approx([0.4 * i / n for i in skip if i])
    seen.clear()
    with torch.no_grad():
        a, b = m.eval()(x), m(x)
    assert not seen and torch.equal(a, b)


def test_drop_connect_distribution():
    # an MBConv block's stochastic depth, as the block draws its mask
    # (``MBConvBlock.drop_connect_mask``): one Bernoulli(0.8) per row,
    # kept rows scaled by 1/0.8
    ba = eff.BlockArgs(num_repeat=1, kernel_size=3, stride=1, expand_ratio=1,
                       input_filters=2, output_filters=2, se_ratio=None)
    block = eff.MBConvBlock(ba, 0.99, 1e-3, device="cpu").train()
    x = torch.ones(20000, 2, 3, 1)
    g = torch.Generator().manual_seed(8)
    keep = block.drop_connect_mask(x, 0.2, g)
    assert block.eval().drop_connect_mask(x, 0.2, g) is None
    out = apply_keep(x, keep, 0.2)
    per_sample = out.reshape(20000, -1)
    assert bool((per_sample == per_sample[:, :1]).all())  # whole rows
    vals = per_sample[:, 0]
    assert set(vals.unique().tolist()) <= {0.0, 1.25}
    assert _within_binomial(int((vals > 0).sum()), 20000, 0.8)


def test_dropout_distribution():
    x = torch.ones(200, 1000)
    out = dropout(x, 0.2, torch.Generator().manual_seed(9))
    assert set(out.unique().tolist()) <= {0.0, 1.25}
    assert _within_binomial(int((out > 0).sum()), x.numel(), 0.8)
    assert torch.equal(dropout(x, 1.0), torch.zeros_like(x))


# ----------------------------------------------------------------- data

def test_peak_normalize_equals_jax():
    rng = np.random.RandomState(10)
    x = (rng.randn(16, 500) * rng.uniform(0.1, 3.0, (16, 1))).astype("float32")
    np.testing.assert_array_equal(
        peak_normalize(_t(x)).numpy(),
        np.asarray(jaug.peak_normalize(jnp.asarray(x))))


def test_device_augment_distribution():
    # constant rows: a row keeps std 0 unless noise was added (std = amp),
    # and its value is c·gain
    n, t, c = 20000, 256, 0.25
    x = torch.full((n, t), c)
    out = leaf_device_augment(torch.Generator().manual_seed(11), x)
    assert out.shape == x.shape and out.dtype == x.dtype
    std = out.std(dim=1)
    noisy = std > 0
    assert _within_binomial(int(noisy.sum()), n, 0.5)
    assert 0.0008 < float(std[noisy].min())
    assert float(std[noisy].max()) < 0.018
    ratio = out[~noisy, 0] / c
    gained = (ratio - 1).abs() > 1e-6
    assert _within_binomial(int(gained.sum()), int((~noisy).sum()), 0.25)
    db = 20 * torch.log10(ratio[gained].double())
    assert -18 - 1e-4 <= float(db.min()) and float(db.max()) <= 6 + 1e-4
    assert float(db.min()) < -17 and float(db.max()) > 5  # the whole range
    loud = leaf_device_augment(None, torch.full((4, 64), 5.0))
    assert float(loud.abs().max()) <= 1.0  # peak-normalised


# ------------------------------------------------------------- training

def test_mixup_distribution_and_form():
    b, alpha = 20000, 0.4
    x = torch.arange(b, dtype=torch.float32)[:, None].repeat(1, 3)
    y = torch.arange(b)
    g = torch.Generator().manual_seed(12)
    mixed, y_a, y_b, lam = mixup(g, x, y, alpha, "multiclass")
    assert torch.equal(y_a, y) and sorted(y_b.tolist()) == list(range(b))
    torch.testing.assert_close(
        mixed, lam[:, None] * x + (1 - lam[:, None]) * x[y_b])
    assert 0.0 <= float(lam.min()) and float(lam.max()) <= 1.0
    # Beta(α, α): mean 1/2, variance 1/(4(2α+1))
    var = 1 / (4 * (2 * alpha + 1))
    assert abs(float(lam.mean()) - 0.5) < 5 * np.sqrt(var / b)
    assert abs(float(lam.var()) - var) < 0.05 * var
    targets = torch.nn.functional.one_hot(y[:8], 8).float()
    mx, my, _, _ = mixup(g, x[:8], targets, alpha, "multilabel")
    lam8 = my.max(dim=1).values  # one-hot rows: the larger weight ≥ 1/2
    assert torch.allclose(my.sum(1), torch.ones(8))
    assert bool((lam8 >= 0.5 - 1e-6).all())


def test_schedules_equal_jax():
    steps = range(50)
    for ours, theirs in (
            (warmup_cosine_schedule(1e-3, 10, 40),
             joptim.warmup_cosine_schedule(1e-3, 10, 40)),
            (step_schedule(0.1, 2, 0.5, 7), joptim.step_schedule(0.1, 2, 0.5, 7))):
        np.testing.assert_allclose([ours(s) for s in steps],
                                   [float(theirs(s)) for s in steps],
                                   rtol=1e-5, atol=1e-12)  # JAX: float32 cos


@pytest.mark.parametrize("sched", ["warmupcosine", "step"])
def test_lr_per_batch_equals_jax_schedule(sched):
    cfg = {"opt": {"optimizer": "Adam", "lr": 1e-3, "scheduler": sched,
                   "warmup_epochs": 2, "step_size": 1, "gamma": 0.5}}
    p = torch.nn.Parameter(torch.zeros(3))
    opt, scheduler, controller, name = optimization_helper(
        cfg, [p], num_tr_steps_per_epoch=5, num_epochs=8)
    assert name == sched and controller is None
    lrs = []
    for _ in range(50):
        lrs.append(opt.param_groups[0]["lr"])
        opt.step()
        scheduler.step()
    ref = (joptim.warmup_cosine_schedule(1e-3, 10, 40) if sched ==
           "warmupcosine" else joptim.step_schedule(1e-3, 1, 0.5, 5))
    assert lrs[0] == 0.0 or sched == "step"
    np.testing.assert_allclose(lrs, [float(ref(s)) for s in range(50)],
                               rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("name", ["Adam", "SGD"])
def test_optimizer_equals_optax(name):
    """Coupled L2 + Adam (or Nesterov SGD) + the per-batch schedule: six
    updates from the same gradients give the same parameters."""
    cfg = {"opt": {"optimizer": name, "lr": 1e-2, "weight_decay": 1e-2,
                   "scheduler": "warmupcosine", "warmup_epochs": 1}}
    rng = np.random.RandomState(13)
    p0 = {"a": rng.randn(4, 3).astype("float32"),
          "b": rng.randn(5).astype("float32")}
    grads = [{k: rng.randn(*v.shape).astype("float32") for k, v in p0.items()}
             for _ in range(6)]
    tx, _, _ = joptim.optimization_helper(cfg, num_tr_steps_per_epoch=2,
                                          num_epochs=4)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    state = tx.init(jp)
    for g in grads:
        upd, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state,
                               jp)
        jp = optax.apply_updates(jp, upd)
    params = {k: torch.nn.Parameter(_t(v)) for k, v in p0.items()}
    opt, sched, _, _ = optimization_helper(cfg, params.values(),
                                           num_tr_steps_per_epoch=2,
                                           num_epochs=4)
    for g in grads:
        for k, p in params.items():
            p.grad = _t(g[k])
        opt.step()
        sched.step()
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   rtol=2e-6, atol=2e-7)


def test_reduce_on_plateau_equals_jax():
    ours, theirs = ReduceLROnPlateau(0.1, patience=2), joptim.ReduceLROnPlateau(
        0.1, patience=2)
    metrics = [0.5, 0.6, 0.6, 0.6, 0.6, 0.7, 0.7, 0.7, 0.7, 0.7, 0.7, 0.7]
    assert [ours.step(m) for m in metrics] == [theirs.step(m) for m in metrics]
    assert ours.state_dict() == theirs.state_dict()
    cfg = {"opt": {"optimizer": "SGD", "scheduler": "reduce", "gamma": 0.5}}
    opt, sched, controller, _ = optimization_helper(
        cfg, [torch.nn.Parameter(torch.zeros(1))])
    assert sched is None and controller.factor == 0.5
    with pytest.raises(ValueError, match="Unsupported"):
        optimization_helper({"opt": {"optimizer": "Lion"}},
                            [torch.nn.Parameter(torch.zeros(1))])


def test_losses_and_wire_equal_jax():
    rng = np.random.RandomState(14)
    logits = rng.randn(6, 5).astype("float32")
    labels = rng.randint(0, 5, 6)
    targets = rng.rand(6, 5).astype("float32")
    np.testing.assert_allclose(
        float(cross_entropy_loss(_t(logits), torch.from_numpy(labels))),
        float(jsteps.cross_entropy_loss(jnp.asarray(logits),
                                        jnp.asarray(labels))), rtol=1e-6)
    np.testing.assert_allclose(
        float(bce_logits_loss(_t(logits), _t(targets))),
        float(jsteps.bce_logits_loss(jnp.asarray(logits),
                                     jnp.asarray(targets))), rtol=1e-6)
    pcm = rng.randint(-32768, 32767, (3, 50)).astype(np.int16)
    np.testing.assert_array_equal(
        waveform_from_wire(torch.from_numpy(pcm)).numpy(),
        np.asarray(jsteps.waveform_from_wire(jnp.asarray(pcm))))
    x = rng.randn(5, 4).astype("float32")
    for got, ref in zip(pad_batch_to_multiple(x, labels[:5], 4),
                        jsteps.pad_batch_to_multiple(x, labels[:5], 4)):
        np.testing.assert_array_equal(got, ref)


class _Linear(torch.nn.Module):
    """A classifier stand-in with the port's forward(x, generator)."""

    def __init__(self, t, c):
        super().__init__()
        self.fc = torch.nn.Linear(t, c)

    def forward(self, x, generator=None):
        return self.fc(x)


@pytest.mark.parametrize("model_type", ["multiclass", "multilabel"])
def test_eval_step_equals_jax(model_type):
    from flax import linen as fnn
    rng = np.random.RandomState(15)
    x = rng.randn(6, 10).astype("float32")
    w = np.array([1, 1, 1, 1, 0, 0], np.float32)
    y = (rng.randint(0, 4, 6) if model_type == "multiclass"
         else rng.randint(0, 2, (6, 4)).astype("float32"))
    model = _Linear(10, 4)
    jm = fnn.Dense(4)
    params = {"kernel": model.fc.weight.detach().numpy().T,
              "bias": model.fc.bias.detach().numpy()}
    js = JaxTrainState.create(
        apply_fn=lambda v, xx, train: jm.apply({"params": v["params"]}, xx),
        params=params, batch_stats={}, tx=optax.sgd(0.1))
    ref = jsteps.make_eval_step(model_type)(js, jnp.asarray(x), jnp.asarray(y),
                                            jnp.asarray(w))
    got = make_eval_step(model_type)(
        TrainState(model, torch.optim.SGD(model.parameters(), 0.1)), _t(x),
        torch.from_numpy(y), _t(w))
    for k in ("loss", "correct", "count", "outputs"):
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("model_type,alpha", [("multiclass", None),
                                              ("multiclass", 0.4),
                                              ("multilabel", 0.4)])
def test_train_step_paths(model_type, alpha):
    torch.manual_seed(0)
    model = _Linear(10, 4)
    opt = torch.optim.Adam(model.parameters(), 1e-2)
    state = TrainState(model, opt)
    x = torch.randn(8, 10)
    y = (torch.randint(0, 4, (8,)) if model_type == "multiclass"
         else torch.randint(0, 2, (8, 4)).float())
    step = make_train_step(model_type, alpha,
                           augment_fn=lambda g, xx: xx * 1.0)
    before = model.fc.weight.detach().clone()
    m = step(state, x, y, torch.Generator().manual_seed(1))
    assert state.step == 1 and model.training
    assert not torch.equal(model.fc.weight, before)
    assert bool(torch.isfinite(m["loss"])) and int(m["count"]) == 8
    assert m["correct"].dtype == torch.int32
    if model_type == "multilabel":
        assert int(m["correct"]) == 0
