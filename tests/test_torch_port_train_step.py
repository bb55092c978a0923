"""The training slice as a whole: the port's train step tracks the JAX
package's ``make_train_step`` on the flagship classifier.

The flagship cfg (LEAF + EfficientNet-b0, 35 classes) with augment, mixup,
dropout and drop-connect off; one JAX init (jitted) carried into the port
by ``load_jax_variables``; Adam, lr 1e-3, coupled L2 1e-4, warm-up cosine
with a 2-step warm-up (lr 0, 5e-4, 1e-3 on steps 0, 1, 2); 3 steps of both
on one seeded batch of 4 one-second clips. The port's frontend runs the
fused op ('on': the residual-saving forward and the backward, as plain
versions on the CPU); the JAX one its XLA path.

Tolerances, with what this CPU measured when they were set:

- per-step loss, relative: 2e-4 (measured ≤ 6.9e-5);
- BN running stats: mean to 1e-3 of the layer's largest sd, var to 1e-3
  of its largest var (measured 2.5e-5 and 6.8e-5);
- the parameter update Δ = p₃ − p₀, ‖Δport − Δjax‖ / ‖Δjax‖: 3e-2
  (measured 9.4e-3). Adam's first updates are lr·sign(g) wherever a
  gradient entry sits at float-noise level, and many do: a quarter of the
  measured difference is in the BN biases just before another BN (their
  gradient is zero in exact arithmetic), the rest is spread thinly.
  That whole-model norm cannot see the frontend: its ~320 entries are
  under 1e-4 of the ~4M parameters;
- so each frontend leaf (``features.*``: the Gabor kernel, the lowpass
  windows and bias, PCEN's alpha/delta/root and EMA weights, the only
  leaves the fused op's backward reaches) on its own, 1e-2 (measured
  ≤ 1.2e-3; a zeroed d_bank reads 1.25 on the Gabor kernel, a zeroed
  d_windows 1.46 on the windows, a d_bank scaled by 1.01 reads 9.1e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leaf_tpu.models import Classifier as JaxClassifier
from leaf_tpu.models.torch_import import import_torch_classifier
from leaf_tpu.training.optim import optimization_helper as jax_optimization
from leaf_tpu.training.state import TrainState as JaxTrainState
from leaf_tpu.training.steps import make_train_step as jax_train_step
from leaf_tpu_torch.models import Classifier, load_jax_variables
from leaf_tpu_torch.ops import fused_frontend
from leaf_tpu_torch.training import (TrainState, make_train_step,
                                     optimization_helper)

CFG = {"frontend": {"name": "leaf", "default_args": True},
       "audio_config": {"sample_rate": 16000},
       "model": {"arch": "efficientnet", "model_depth": "b0",
                 "num_classes": 35, "dropout_rate": 0.0,
                 "drop_connect_rate": 0.0},
       "opt": {"optimizer": "Adam", "lr": 1e-3, "weight_decay": 1e-4,
               "scheduler": "warmupcosine", "warmup_epochs": 1}}
STEPS_PER_EPOCH, EPOCHS, STEPS = 2, 10, 3
LOSS_TOL, STATS_TOL, UPDATE_TOL, FRONTEND_TOL = 2e-4, 1e-3, 3e-2, 1e-2


def _np_tree(variables):
    return jax.tree_util.tree_map(np.asarray, dict(variables))


def _port_run(variables, x, y, fused):
    cfg = {**CFG, "frontend": {**CFG["frontend"], "use_fused_kernel": fused}}
    model = load_jax_variables(Classifier(cfg, device="cpu"), variables)
    opt, sched, _, _ = optimization_helper(
        cfg, model.parameters(), num_tr_steps_per_epoch=STEPS_PER_EPOCH,
        num_epochs=EPOCHS)
    state = TrainState(model, opt, sched)
    step = make_train_step()
    losses = [float(step(state, torch.from_numpy(x), torch.from_numpy(y))
                    ["loss"]) for _ in range(STEPS)]
    assert state.step == STEPS
    return model, losses


@pytest.fixture(scope="module")
def runs():
    """(initial variables, JAX final variables and losses, port model and
    losses)."""
    rng = np.random.RandomState(0)
    x = (rng.randn(4, 16000) * 0.1).astype("float32")
    y = rng.randint(0, 35, 4)
    jm = JaxClassifier(cfg=CFG)
    v0 = _np_tree(jax.jit(lambda k, xx: jm.init({"params": k}, xx,
                                                train=False))(
        jax.random.PRNGKey(0), jnp.asarray(x)))
    tx, _, _ = jax_optimization(CFG, num_tr_steps_per_epoch=STEPS_PER_EPOCH,
                                num_epochs=EPOCHS)
    js = JaxTrainState.create(apply_fn=jm.apply, params=v0["params"],
                              batch_stats=v0["batch_stats"], tx=tx)
    jstep = jax_train_step(donate=False)
    jlosses = []
    for _ in range(STEPS):
        js, met = jstep(js, jnp.asarray(x), jnp.asarray(y),
                        jax.random.PRNGKey(1))
        jlosses.append(float(met["loss"]))
    vj = _np_tree({"params": js.params, "batch_stats": js.batch_stats})
    port, losses = _port_run(v0, x, y, "on")
    return {"v0": v0, "x": x, "y": y, "jax": (vj, jlosses),
            "port": (port, losses)}


def test_losses_track_jax(runs):
    _, jlosses = runs["jax"]
    _, losses = runs["port"]
    assert jlosses[2] < jlosses[0]  # the steps with lr > 0 moved the loss
    for a, b in zip(losses, jlosses):
        assert abs(a - b) / abs(b) < LOSS_TOL, (losses, jlosses)


def test_batch_stats_track_jax(runs):
    vj, _ = runs["jax"]
    port, _ = runs["port"]
    back = import_torch_classifier(port.state_dict(), runs["v0"],
                                   "efficientnet")["batch_stats"]

    def layers(tree):
        if "mean" in tree:
            yield tree
            return
        for k in sorted(tree):
            yield from layers(tree[k])

    pairs = list(zip(layers(back), layers(vj["batch_stats"])))
    assert len(pairs) == 49
    for got, ref in pairs:
        sd, var = np.sqrt(ref["var"]).max(), ref["var"].max()
        assert np.abs(got["mean"] - ref["mean"]).max() / sd < STATS_TOL
        assert np.abs(got["var"] - ref["var"]).max() / var < STATS_TOL


def test_parameter_update_tracks_jax(runs):
    vj, _ = runs["jax"]
    port, _ = runs["port"]
    back = import_torch_classifier(port.state_dict(), runs["v0"],
                                   "efficientnet")["params"]
    num = den = 0.0
    for a, b, c in zip(jax.tree_util.tree_leaves(back),
                       jax.tree_util.tree_leaves(vj["params"]),
                       jax.tree_util.tree_leaves(runs["v0"]["params"])):
        num += float(np.sum(((a - c) - (b - c)) ** 2))
        den += float(np.sum((b - c) ** 2))
    assert den > 0 and (num / den) ** 0.5 < UPDATE_TOL, (num / den) ** 0.5


def _frontend_update_rel(model, ref, p0) -> dict:
    """‖Δmodel − Δref‖ / ‖Δref‖ for each frontend leaf, Δ from ``p0``."""
    p0 = {k: v.detach() for k, v in p0.named_parameters()}
    ref = dict(ref.named_parameters())
    out = {}
    for name, p in model.named_parameters():
        if name.startswith("features."):
            d, d_ref = p.detach() - p0[name], ref[name].detach() - p0[name]
            out[name] = float((d - d_ref).norm() / d_ref.norm())
    assert len(out) == 7, sorted(out)
    return out


@pytest.fixture(scope="module")
def port_models(runs):
    """The port's initial weights and the JAX run's final ones, as port
    models on the CPU."""
    def port_model(v):
        return load_jax_variables(Classifier(CFG, device="cpu"), v)
    return port_model(runs["v0"]), port_model(runs["jax"][0])


def test_frontend_update_tracks_jax(runs, port_models):
    port, _ = runs["port"]
    rel = _frontend_update_rel(port, port_models[1], port_models[0])
    assert max(rel.values()) < FRONTEND_TOL, rel


@pytest.mark.parametrize("fault", ["d_bank", "d_windows"])
def test_frontend_check_sees_a_zeroed_gradient(runs, port_models,
                                               monkeypatch, fault):
    # the per-leaf check above fails when the fused backward drops one of
    # its two gradients, though the losses could pass
    plain = fused_frontend.fused_backward_reference
    zeroed = 0 if fault == "d_bank" else 1

    def faulty(*args):
        grads = list(plain(*args))
        grads[zeroed] = torch.zeros_like(grads[zeroed])
        return tuple(grads)

    monkeypatch.setattr(fused_frontend, "fused_backward_reference", faulty)
    bad, _ = _port_run(runs["v0"], runs["x"], runs["y"], "on")
    rel = _frontend_update_rel(bad, port_models[1], port_models[0])
    worst = max(rel, key=rel.get)
    print(f"{fault} zeroed, frontend update rel per leaf: {rel}")
    assert rel[worst] > 1.0, rel
    assert worst == ("features._complex_conv._kernel" if fault == "d_bank"
                     else "features._pooling.weights"), rel


def test_fused_and_plain_frontend_train_alike(runs, port_models):
    # the op's autograd.Function (saving forward + backward) vs autograd
    # through the plain torch ops, same weights and batch, on the CPU
    port, losses_on = runs["port"]
    off, losses_off = _port_run(runs["v0"], runs["x"], runs["y"], "off")
    np.testing.assert_allclose(losses_on, losses_off, rtol=1e-5)
    rel = _frontend_update_rel(port, off, port_models[0])
    assert max(rel.values()) < 1e-5, rel
