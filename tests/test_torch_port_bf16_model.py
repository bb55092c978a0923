"""bf16 compute through the whole model (LEAF + EfficientNet-b0), held
against the JAX package's bf16 path on the CPU; the fused op and Leaf
are in tests/test_torch_port_bf16.py.

One seeded JAX init of the flagship (unit BatchNorm statistics) and one
batch of 4 clips (a 440 Hz tone plus noise) serve the comparisons. The
eval logits are held against JAX's own distance between its bf16 and f32
runs: the port's bf16 must sit closer to JAX's bf16 than JAX's bf16 sits
to JAX's f32 (a ratio ≥ 1 means a rounding point differs; measured 0.33
on this CPU when the test was written, 6.6e-3 of max|logit| against
2.0e-2). The train steps' tolerances stand beside their test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leaf_tpu.models import Classifier as JaxClassifier
from leaf_tpu.training.optim import optimization_helper as jax_optimization
from leaf_tpu.training.state import TrainState as JaxTrainState
from leaf_tpu.training.steps import make_train_step as jax_train_step
from leaf_tpu_torch.frontend import Leaf
from leaf_tpu_torch.models import Classifier, load_jax_variables
from leaf_tpu_torch.models import common
from leaf_tpu_torch.models import efficientnet as eff
from leaf_tpu_torch.serving import ServingModel
from leaf_tpu_torch.training import (TrainState, make_train_step,
                                     optimization_helper)

BF16 = torch.bfloat16
CFG = {"frontend": {"name": "leaf", "default_args": True},
       "audio_config": {"sample_rate": 16000},
       "model": {"arch": "efficientnet", "model_depth": "b0",
                 "num_classes": 35}}


def _bf16_cfg(cfg):
    return {**cfg,
            "frontend": {**cfg["frontend"], "compute_dtype": "bfloat16"},
            "model": {**cfg["model"], "compute_dtype": "bfloat16"}}


def _np_tree(variables):
    return jax.tree_util.tree_map(np.asarray, dict(variables))


def _to_np(t):
    return t.detach().float().numpy()


# ------------------------------------------------------- the dtype policy

def test_bf16_dtype_policy():
    """Output dtypes through b0 + Leaf under bf16, one train step: the
    frontend's features f32; each conv's f32 sums straight into its
    BatchNorm (XLA keeps them there, see ``common.Conv2d``); BatchNorm
    out bf16 with f32 running stats; the squeeze-excite dense layers,
    the gate and the fc in bf16; the logits bf16. Parameters, gradients
    and Adam's state stay f32."""
    cfg = {**_bf16_cfg(CFG), "opt": {"optimizer": "Adam", "lr": 1e-3,
                                     "weight_decay": 1e-4,
                                     "scheduler": "warmupcosine",
                                     "warmup_epochs": 1}}
    model = Classifier(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    seen = {}

    def record(kind):
        def hook(mod, inputs, out):
            seen.setdefault(kind, set()).add(out.dtype)
            if kind == "bn":
                seen.setdefault("bn in", set()).add(inputs[0].dtype)
        return hook

    kinds = ((Leaf, "frontend"), (common.BatchNorm2d, "bn"),
             (common.Conv2d, "conv"), (eff.EfficientNet, "logits"))
    for m in model.modules():
        for cls, kind in kinds:
            if isinstance(m, cls):
                m.register_forward_hook(record(kind))
    dense = eff._dense

    def dense_spy(x, w, b):
        out = dense(x, w, b)
        seen.setdefault("dense", set()).add(out.dtype)
        return out

    opt, sched, _, _ = optimization_helper(cfg, model.parameters(),
                                           num_tr_steps_per_epoch=2,
                                           num_epochs=2)
    state = TrainState(model, opt, sched)
    x = torch.from_numpy((np.random.RandomState(3).randn(2, 16000) * 0.1)
                         .astype("float32"))
    eff._dense = dense_spy
    try:
        metrics = make_train_step()(state, x, torch.tensor([1, 2]))
    finally:
        eff._dense = dense
    assert seen == {"frontend": {torch.float32}, "conv": {torch.float32},
                    "bn in": {torch.float32}, "bn": {BF16},
                    "dense": {BF16}, "logits": {BF16}}, seen
    assert metrics["loss"].dtype == BF16
    for m in model.modules():
        if isinstance(m, common.BatchNorm2d):
            assert m.running_mean.dtype == m.running_var.dtype == torch.float32
    for p in model.parameters():
        assert p.dtype == p.grad.dtype == torch.float32
    moments = [t for s in opt.state.values() for t in s.values()
               if torch.is_tensor(t) and t.numel() > 1]
    assert moments and all(t.dtype == torch.float32 for t in moments)


# ------------------------------------------------------- the classifier

@pytest.fixture(scope="module")
def flagship():
    """A seeded JAX init of the flagship (unit BN statistics) and a batch
    of 4 clips: a 440 Hz tone plus noise."""
    rng = np.random.RandomState(0)
    t = np.arange(16000) / 16000
    wav = (0.3 * np.sin(2 * np.pi * 440 * t)[None]
           + 0.05 * rng.randn(4, 16000)).astype("float32")
    jm = JaxClassifier(cfg=CFG)
    v = _np_tree(jax.jit(lambda k, xx: jm.init({"params": k}, xx,
                                               train=False))(
        jax.random.PRNGKey(0), jnp.asarray(wav)))
    return wav, v


def test_classifier_bf16_eval_matches_jax_bf16(flagship):
    wav, v = flagship
    jb, jf = JaxClassifier(cfg=_bf16_cfg(CFG)), JaxClassifier(cfg=CFG)
    ref_b = np.asarray(jax.jit(lambda vv, xx: jb.apply(vv, xx, train=False))(
        v, jnp.asarray(wav)))
    ref_f = np.asarray(jax.jit(lambda vv, xx: jf.apply(vv, xx, train=False))(
        v, jnp.asarray(wav)))
    assert ref_b.dtype == jnp.bfloat16
    port = load_jax_variables(Classifier(_bf16_cfg(CFG), device="cpu"),
                              v).eval()
    with torch.no_grad():
        got = port(torch.from_numpy(wav))
    assert got.dtype == BF16 and got.shape == (4, 35)
    scale = np.abs(ref_f).max()
    port_gap = float(np.abs(_to_np(got) - ref_b.astype(np.float32)).max()
                     / scale)
    jax_gap = float(np.abs(ref_b.astype(np.float32) - ref_f).max() / scale)
    msg = (f"port bf16 vs JAX bf16 {port_gap:.3e} of max|logit|, JAX bf16 "
           f"vs JAX f32 {jax_gap:.3e}: ratio {port_gap / jax_gap:.3f}")
    print(msg)
    assert port_gap < jax_gap, msg


def test_serving_bf16_returns_f32(flagship):
    wav, v = flagship
    server = ServingModel(_bf16_cfg(CFG), jax_variables=v, device="cpu",
                          batch_sizes=(8,))
    out = server(wav[:3])
    assert out.dtype == np.float32 and out.shape == (3, 35)
    with torch.no_grad():
        want = server.model(torch.from_numpy(np.pad(wav[:3],
                                                    ((0, 5), (0, 0)))))
    np.testing.assert_array_equal(out, _to_np(want)[:3])


# ------------------------------------------------------- the train step

TRAIN_CFG = {**CFG,
             "model": {**CFG["model"], "dropout_rate": 0.0,
                       "drop_connect_rate": 0.0},
             "opt": {"optimizer": "Adam", "lr": 1e-3, "weight_decay": 1e-4,
                     "scheduler": "warmupcosine", "warmup_epochs": 1}}
STEPS_PER_EPOCH, EPOCHS, STEPS = 2, 10, 3
LABELS = np.array([3, 7, 3, 11])


def _bf16_steps(v0, x, y, steps=STEPS):
    cfg = _bf16_cfg(TRAIN_CFG)
    model = load_jax_variables(Classifier(cfg, device="cpu"), v0)
    opt, sched, _, _ = optimization_helper(
        cfg, model.parameters(), num_tr_steps_per_epoch=STEPS_PER_EPOCH,
        num_epochs=EPOCHS)
    state = TrainState(model, opt, sched)
    step = make_train_step()
    losses = [float(step(state, torch.from_numpy(x), torch.from_numpy(y))
                    ["loss"]) for _ in range(steps)]
    return model, losses


@pytest.fixture(scope="module")
def jax_steps(flagship):
    """JAX's make_train_step in bf16 for three steps from the flagship
    init: (losses, final variables)."""
    wav, v0 = flagship
    cfg = _bf16_cfg(TRAIN_CFG)
    jm = JaxClassifier(cfg=cfg)
    tx, _, _ = jax_optimization(cfg, num_tr_steps_per_epoch=STEPS_PER_EPOCH,
                                num_epochs=EPOCHS)
    js = JaxTrainState.create(apply_fn=jm.apply, params=v0["params"],
                              batch_stats=v0["batch_stats"], tx=tx)
    jstep = jax_train_step(donate=False)
    losses = []
    for _ in range(STEPS):
        js, met = jstep(js, jnp.asarray(wav), jnp.asarray(LABELS),
                        jax.random.PRNGKey(1))
        losses.append(float(met["loss"]))
    return losses, _np_tree({"params": js.params,
                             "batch_stats": js.batch_stats})


def _stats_gap(model, ref) -> float:
    """Largest BatchNorm running-stat difference, mean over the layer's
    largest sd and var over its largest var."""
    gap, mods = 0.0, dict(ref.named_modules())
    for name, m in model.named_modules():
        if isinstance(m, common.BatchNorm2d):
            r = mods[name]
            sd, var = r.running_var.sqrt().max(), r.running_var.max()
            gap = max(gap, float((m.running_mean - r.running_mean).abs().max()
                                 / sd),
                      float((m.running_var - r.running_var).abs().max() / var))
    return gap


def _frontend_gaps(model, ref, p0) -> dict:
    """‖Δmodel − Δref‖ / ‖Δref‖ per frontend leaf, Δ from ``p0``."""
    p0, ref = dict(p0.named_parameters()), dict(ref.named_parameters())
    out = {}
    for name, p in model.named_parameters():
        if name.startswith("features."):
            d = p.detach() - p0[name].detach()
            d_ref = ref[name].detach() - p0[name].detach()
            out[name] = float((d - d_ref).norm() / d_ref.norm())
    assert len(out) == 7, sorted(out)
    return out


# three bf16 train steps, port vs JAX: the third loss (after two updates)
# relative, the BatchNorm running stats of each layer's scale, each
# frontend leaf's update ‖Δport − Δjax‖ / ‖Δjax‖. Measured on this CPU:
# 3.9e-2, 1.97e-2, 0.39–0.71 per leaf (Adam's first updates are
# lr·sign(g) on entries at rounding level, so any two runs part quickly;
# batch-statistics BatchNorm at init on 4 clips amplifies rounding).
# Before any update moves the weights the losses are equal.
TRAIN_LOSS_TOL, TRAIN_STATS_TOL, TRAIN_FRONTEND_TOL = 0.1, 5e-2, 0.9


def test_bf16_train_steps_track_jax(flagship, jax_steps):
    """Three bf16 train steps (augment, dropout, drop-connect off; lr 0,
    5e-4, 1e-3) of the port and of JAX's ``make_train_step`` from one
    init, at the tolerances above."""
    wav, v0 = flagship
    cfg = _bf16_cfg(TRAIN_CFG)
    port, losses = _bf16_steps(v0, wav, LABELS)
    jlosses, vj = jax_steps

    def as_port(v):
        return load_jax_variables(Classifier(cfg, device="cpu"), v)

    ref = as_port(vj)
    loss_gap = abs(losses[2] - jlosses[2]) / jlosses[2]
    stats_gap = _stats_gap(port, ref)
    front = _frontend_gaps(port, ref, as_port(v0))
    print(f"losses {losses} vs JAX {jlosses}: third {loss_gap:.3e}; BN "
          f"stats {stats_gap:.3e}; frontend leaves {front}")
    assert losses[:2] == jlosses[:2], (losses, jlosses)
    assert loss_gap < TRAIN_LOSS_TOL, (losses, jlosses)
    assert stats_gap < TRAIN_STATS_TOL, stats_gap
    assert max(front.values()) < TRAIN_FRONTEND_TOL, front


@pytest.mark.slow
def test_hundred_bf16_steps_bounded_divergence():
    """The port's bf16 against its f32 over 100 Adam + warm-up cosine
    steps on 4 batches of 8 tone clips, cycled (augment, dropout,
    drop-connect off): the bounds of the JAX package's
    tests/test_efficientnet_parity.py::test_hundred_steps_bf16_bounded_divergence."""
    rng = np.random.RandomState(123)
    t = np.arange(16000, dtype=np.float32) / 16000.0
    labels = (np.arange(32) % 35).astype(np.int64)
    waves = 0.2 * np.sin(2 * np.pi * (300.0 + 100.0 * labels)[:, None]
                         * t[None, :])
    waves = (waves + 0.02 * rng.randn(32, 16000)).astype(np.float32)
    curves = {}
    for tag, cfg in (("f32", TRAIN_CFG), ("bf16", _bf16_cfg(TRAIN_CFG))):
        model = Classifier(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(0))
        opt, sched, _, _ = optimization_helper(
            cfg, model.parameters(), num_tr_steps_per_epoch=6,
            num_epochs=100 // 6)
        state = TrainState(model, opt, sched)
        step = make_train_step()
        curves[tag] = np.array([float(step(
            state, torch.from_numpy(waves[lo:lo + 8]),
            torch.from_numpy(labels[lo:lo + 8]))["loss"])
            for lo in ((i % 4) * 8 for i in range(100))])
    f, b = curves["f32"], curves["bf16"]
    assert abs(b[0] - f[0]) < 0.05, (b[0], f[0])
    assert float(np.median(np.abs(b - f) / np.maximum(np.abs(f), 0.1))) < 0.25
    assert (abs(b[-10:].mean() - f[-10:].mean())
            / max(f[-10:].mean(), 0.1)) < 0.25
    assert b[-1] < 0.5 * b[0]
