"""The multilabel train step (BCE on k-hot labels) of the port held against
the JAX package's ``make_train_step("multilabel")`` on the CPU, in f32 and
in bf16 compute.

The recipe is the synthetic-convergence harness's multilabel cfg
(``leaf_tpu_torch/synthetic_convergence.py`` ``CFG``: ``type:
multilabel``, Adam, warm-up cosine, ``mixup: False``) on a small flagship
(a 16-filter Leaf and EfficientNet-b0 with 35 classes, as the harness
has), dropout, drop-connect and the augment off (the RNG streams differ).
Both steps start from one set of seeded port weights carried into JAX by
its importer and take three steps on the same seeded batches of 4 clips
with 1–3 labels each (lr 0, 5e-4, 1e-3).

Bounds, f32: those of tests/test_torch_port_train_step.py and the
K-step test (tests/test_torch_port_multistep.py): every loss to 2e-4
relative, the BatchNorm running stats to 1e-3 of each layer's scale, the
update p3 − p0 to 3e-2 of its norm, each frontend leaf's update to 1e-2;
the first step's gradients (whole model, and each frontend leaf) to the
same 3e-2 and 1e-2 of their norms (measured 4.3e-4 and 8.6e-4).
bf16: every loss to 2e-4 (the port forms the loss at optax's rounding
points: measured equal), the running stats to 5e-2 of each layer's
scale (tests/test_torch_port_bf16_model.py's bound). The gradients and
updates in bf16 are dominated by rounding (JAX's own bf16 first-step
gradient is 1.5 of its norm away from its f32 one here: batch-statistics
BatchNorm on 4 clips amplifies it, and Adam's first updates are lr·sign(g)),
so they are held as tests/test_torch_port_bf16_model.py holds bf16
logits: the port's bf16 must sit closer to JAX's bf16 than JAX's bf16
sits to JAX's f32 (ratio < 1), for the whole model and for the frontend's
7 leaves together. Leaf by leaf the ratio is printed, not held: the PCEN
EMA weights' bf16 gradient is rounding alone (its ratio read 0.78 and
1.01 with 4 and 2 intra-op threads, the port against itself moving as
much).
"""

import functools

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
from leaf_tpu_torch.training import (TrainState, make_train_step,
                                     optimization_helper)

N_CLASSES, B, STEPS = 35, 4, 3
CFG = {"frontend": {"name": "leaf", "n_filters": 16},
       "audio_config": {"sample_rate": 16000, "mixup": False},
       "model": {"arch": "efficientnet", "model_depth": "b0",
                 "num_classes": N_CLASSES, "pool": "avgpool",
                 "type": "multilabel", "dropout_rate": 0.0,
                 "drop_connect_rate": 0.0},
       "opt": {"optimizer": "Adam", "lr": 1e-3, "weight_decay": 1e-4,
               "scheduler": "warmupcosine", "warmup_epochs": 1}}
STEPS_PER_EPOCH, EPOCHS = 2, 10
BOUNDS = {
    # first two losses, third loss, BN stats, update, frontend leaf update,
    # first-step gradient (model), first-step gradient (frontend leaf)
    "f32": dict(loss=2e-4, loss3=2e-4, stats=1e-3, update=3e-2,
                front=1e-2, grad=3e-2, grad_front=1e-2),
    "bf16": dict(loss=2e-4, loss3=2e-4, stats=5e-2),
}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _cfg(dtype: str) -> dict:
    if dtype == "f32":
        return CFG
    return {**CFG,
            "frontend": {**CFG["frontend"], "compute_dtype": "bfloat16"},
            "model": {**CFG["model"], "compute_dtype": "bfloat16"}}


def _np_tree(v):
    return jax.tree_util.tree_map(np.asarray, dict(v))


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


def _batch():
    """4 seeded clips, each with 1–3 of the 35 labels (k-hot float32)."""
    rng = np.random.RandomState(31)
    x = (rng.randn(B, 16000) * 0.1).astype(np.float32)
    y = np.zeros((B, N_CLASSES), np.float32)
    for i in range(B):
        y[i, rng.choice(N_CLASSES, rng.randint(1, 4), replace=False)] = 1.0
    return x, y


@functools.lru_cache(maxsize=None)
def _port_run(dtype):
    cfg = _cfg(dtype)
    x, y = _batch()
    model = load_jax_variables(Classifier(cfg, device="cpu"), _variables())
    opt, sched, _, _ = optimization_helper(
        cfg, model.parameters(), num_tr_steps_per_epoch=STEPS_PER_EPOCH,
        num_epochs=EPOCHS)
    state = TrainState(model, opt, sched)
    step = make_train_step("multilabel")
    losses, grads = [], None
    for _ in range(STEPS):
        losses.append(float(step(state, torch.from_numpy(x),
                                 torch.from_numpy(y))["loss"]))
        if grads is None:
            # the step leaves the first step's gradients in .grad
            grads = {k: p.grad.detach().clone()
                     for k, p in model.named_parameters()
                     if p.grad is not None}
    return model, losses, grads


@functools.lru_cache(maxsize=None)
def _jax_run(dtype):
    cfg = _cfg(dtype)
    x, y = _batch()
    jm = JaxClassifier(cfg=cfg)
    v = _variables()
    tx, _, _ = jax_optimization(cfg, num_tr_steps_per_epoch=STEPS_PER_EPOCH,
                                num_epochs=EPOCHS)
    js = JaxTrainState.create(apply_fn=jm.apply, params=v["params"],
                              batch_stats=v["batch_stats"], tx=tx)

    # watch_histograms stashes the step's gradients in metrics["_grads"]
    jstep = jax_train_step("multilabel", donate=False, watch_histograms=True)
    losses, grads = [], None
    for _ in range(STEPS):
        js, met = jstep(js, jnp.asarray(x), jnp.asarray(y),
                        jax.random.PRNGKey(1))
        losses.append(float(met["loss"]))
        if grads is None:
            grads = _np_tree(met["_grads"])
    return js, losses, grads


def _as_port(cfg, params, batch_stats):
    return load_jax_variables(Classifier(cfg, device="cpu"),
                              {"params": _np_tree(params),
                               "batch_stats": _np_tree(batch_stats)})


def _rel(a: dict, b: dict, keys) -> float:
    num = sum(float((a[k].float() - b[k].float()).norm() ** 2) for k in keys)
    den = sum(float(b[k].float().norm() ** 2) for k in keys)
    return (num / den) ** 0.5


def _deltas(dtype):
    """(first-step gradients, updates p3 − p0) of the port's and of JAX's
    run, by port parameter name; the port's model and JAX's state."""
    cfg, v0 = _cfg(dtype), _variables()
    port, _, grads = _port_run(dtype)
    js, _, jgrads = _jax_run(dtype)
    ref = dict(_as_port(cfg, js.params, js.batch_stats).named_parameters())
    p0 = dict(_as_port(cfg, v0["params"], v0["batch_stats"])
              .named_parameters())
    jgrad = {k: v.detach() for k, v in
             _as_port(cfg, jgrads, v0["batch_stats"]).named_parameters()}
    upd = {k: p.detach() - p0[k].detach() for k, p in port.named_parameters()}
    jupd = {k: ref[k].detach() - p0[k].detach() for k in upd}
    return grads, jgrad, upd, jupd


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_multilabel_train_steps_track_jax(dtype):
    """Three multilabel train steps of the port and of JAX from one set of
    weights on the same k-hot batch, at the bounds of the module
    docstring."""
    cfg, tol = _cfg(dtype), BOUNDS[dtype]
    port, losses, _ = _port_run(dtype)
    js, jlosses, _ = _jax_run(dtype)
    grads, jgrad, upd, jupd = _deltas(dtype)
    front = [k for k in grads if k.startswith("features.")]
    assert len(front) == 7, front
    loss_gap = [abs(a - b) / abs(b) for a, b in zip(losses, jlosses)]
    stats, ref_mods = 0.0, dict(_as_port(cfg, js.params, js.batch_stats)
                                .named_modules())
    for name, m in port.named_modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            r = ref_mods[name]
            stats = max(stats, float(
                (m.running_mean - r.running_mean).abs().max()
                / r.running_var.sqrt().max()), float(
                (m.running_var - r.running_var).abs().max()
                / r.running_var.max()))
    gaps = {"gradient": {"model": _rel(grads, jgrad, grads),
                         **{k: _rel(grads, jgrad, [k]) for k in front}},
            "update": {"model": _rel(upd, jupd, upd),
                       **{k: _rel(upd, jupd, [k]) for k in front}}}
    print(f"{dtype}: losses {losses} vs JAX {jlosses} (rel {loss_gap}); "
          f"BN stats {stats:.3e}; port vs JAX {gaps}")
    assert max(loss_gap[:2]) < tol["loss"], (losses, jlosses)
    assert loss_gap[2] < tol["loss3"], (losses, jlosses)
    assert stats < tol["stats"], stats
    if dtype == "f32":
        for what, whole, leaf in (("gradient", tol["grad"], tol["grad_front"]),
                                  ("update", tol["update"], tol["front"])):
            assert gaps[what]["model"] < whole, (what, gaps[what])
            assert max(gaps[what][k] for k in front) < leaf, (what,
                                                              gaps[what])
        return
    # bf16: against JAX's own bf16-vs-f32 distance
    _, jgrad32, _, jupd32 = _deltas("f32")
    port_g, port_u = grads, upd
    for what, port_d, mine, theirs in (("gradient", port_g, jgrad, jgrad32),
                                       ("update", port_u, jupd, jupd32)):
        ratio = {name: _rel(port_d, mine, keys) / _rel(mine, theirs, keys)
                 for name, keys in (("model", list(mine)),
                                    ("frontend", front))}
        leaves = {k: _rel(port_d, mine, [k]) / _rel(mine, theirs, [k])
                  for k in front}
        print(f"bf16 {what}: port-vs-JAX over JAX bf16-vs-f32 {ratio}, "
              f"by frontend leaf {leaves}")
        assert max(ratio.values()) < 1.0, (what, ratio)
