"""Checkpoints, the schedule rewind and BN recalibration of the port
(leaf_tpu_torch.training.{checkpoint,state,bn_recalibrate}) against the
JAX package.

- A save/load round trip is bit-exact: parameters, BatchNorm buffers,
  Adam moments and steps, the scheduler and the step counter; one more
  step from each copy gives bit-equal parameters.
- ``latest_checkpoint`` / ``best_checkpoint`` follow the JAX rules
  (tests/test_preemption.py).
- ``rewind_steps``: the same gradients through both packages'
  ``optimization_helper``, a rewind by n, one more gradient: the updates
  and the lr agree to 1e-5 relative (float32 Adam on both sides; the
  updates differ in their last bits).
- ``recalibrate_batch_stats``: the same weights (``load_jax_variables``)
  and batches, dropout and drop-connect off so that no RNG enters; the
  running stats agree to STATS_TOL = 1e-3 of each layer's scale, the
  tolerance chip_smoke.py holds the train step's stats to.
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import tree_util
from torch import nn

from leaf_tpu.models import Classifier as JaxClassifier
from leaf_tpu.models.torch_import import import_torch_classifier
from leaf_tpu.training import checkpoint as jckpt
from leaf_tpu.training.bn_recalibrate import (
    recalibrate_batch_stats as jax_recalibrate)
from leaf_tpu.training.optim import optimization_helper as jax_optimization
from leaf_tpu.training.optim import warmup_cosine_schedule
from leaf_tpu.training.state import TrainState as JaxTrainState
from leaf_tpu.training.state import rewind_steps as jax_rewind
from leaf_tpu_torch.models import Classifier, load_jax_variables
from leaf_tpu_torch.models.common import BatchNorm2d
from leaf_tpu_torch.training import (TrainState, optimization_helper,
                                     rewind_steps)
from leaf_tpu_torch.training import checkpoint as ckpt
from leaf_tpu_torch.training.bn_recalibrate import recalibrate_batch_stats

OPT = {"optimizer": "Adam", "lr": 1e-3, "weight_decay": 1e-4,
       "scheduler": "warmupcosine", "warmup_epochs": 1}
STEPS_PER_EPOCH, EPOCHS = 4, 3
STATS_TOL = 1e-3


class _Tiny(nn.Module):
    def __init__(self, seed):
        super().__init__()
        torch.manual_seed(seed)
        self.conv = nn.Conv2d(1, 4, 3)
        self.bn = BatchNorm2d(4, momentum=0.01)
        self.fc = nn.Linear(4, 3)

    def forward(self, x):
        return self.fc(self.bn(self.conv(x)).mean(dim=(2, 3)))


def _tiny_state(seed):
    model = _Tiny(seed)
    opt, sched, _, _ = optimization_helper(
        {"opt": OPT}, model.parameters(),
        num_tr_steps_per_epoch=STEPS_PER_EPOCH, num_epochs=EPOCHS)
    return TrainState(model, opt, sched)


def _step(state, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(5, 1, 6, 6, generator=g)
    state.optimizer.zero_grad()
    state.model(x).square().mean().backward()
    state.apply_gradients()


def test_round_trip_is_bit_exact(tmp_path):
    a = _tiny_state(0)
    for i in range(3):
        _step(a, i)
    path = ckpt.save_checkpoint(str(tmp_path), a, 2, 0.5, 0.25, 0.75,
                                scheduler_state={"lr": 1e-3})
    b, meta = ckpt.load_checkpoint(path, _tiny_state(1))
    assert meta == {"epoch": 2, "tr_loss": 0.5, "tr_acc": 0.25,
                    "val_acc": 0.75, "scheduler": {"lr": 1e-3}}
    assert b.step == a.step == 3
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert list(sa) == list(sb)
    for k in sa:          # parameters and BN buffers
        assert torch.equal(sa[k], sb[k]), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    for i, st in oa["state"].items():
        for k, v in st.items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)
    assert a.scheduler.state_dict() == b.scheduler.state_dict()
    _step(a, 9)
    _step(b, 9)
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(pa, pb)


def test_load_without_optimizer_restores_model_and_step(tmp_path):
    a = _tiny_state(0)
    _step(a, 0)
    path = ckpt.save_checkpoint(str(tmp_path), a, 0, 1.0, 0.0, 0.5)
    b, _ = ckpt.load_checkpoint(path, TrainState(_Tiny(1), None),
                                with_opt=False)
    assert b.step == 1
    for (k, va), vb in zip(a.model.state_dict().items(),
                           b.model.state_dict().values()):
        assert torch.equal(va, vb), k


def _mkckpt(root, name, meta):
    d = root / name
    d.mkdir()
    (d / "meta.json").write_text(json.dumps(meta))


@pytest.mark.parametrize("pkg", [ckpt, jckpt], ids=["port", "jax"])
def test_best_checkpoint_never_returns_preempt_save(pkg, tmp_path):
    _mkckpt(tmp_path, "epoch_000_preempt", {"epoch": -1, "val_acc": -1.0})
    assert pkg.best_checkpoint(str(tmp_path)) is None
    _mkckpt(tmp_path, "epoch_000", {"epoch": 0, "val_acc": 0.3})
    assert pkg.best_checkpoint(str(tmp_path)).endswith("epoch_000")
    _mkckpt(tmp_path, "epoch_001", {"epoch": 1, "val_acc": 0.2})
    _mkckpt(tmp_path, "epoch_002", {"epoch": 2, "val_acc": 0.9})
    (tmp_path / "epoch_003").mkdir()        # no meta.json: ignored
    assert pkg.best_checkpoint(str(tmp_path)).endswith("epoch_002")


@pytest.mark.parametrize("pkg", [ckpt, jckpt], ids=["port", "jax"])
def test_latest_prefers_completed_epoch_over_preempt(pkg, tmp_path):
    assert pkg.latest_checkpoint(str(tmp_path / "missing")) is None
    for name, epoch in (("epoch_005", 5), ("epoch_006_preempt", 5),
                        ("epoch_006", 6)):
        _mkckpt(tmp_path, name, {"epoch": epoch})
    assert pkg.latest_checkpoint(str(tmp_path)).endswith("epoch_006")
    shutil.rmtree(tmp_path / "epoch_006")
    assert pkg.latest_checkpoint(str(tmp_path)).endswith("epoch_006_preempt")


def test_hparams_round_trip(tmp_path):
    cfg = {"opt": {"lr": "1e-3"}, "data": {"test": None, "in_memory": True}}
    ckpt.save_hparams(str(tmp_path / "exp"), cfg)
    assert ckpt.load_hparams(str(tmp_path / "exp")) == cfg
    assert jckpt.load_hparams(str(tmp_path / "exp")) == cfg


@pytest.mark.parametrize("optimizer", ["Adam", "SGD"])
@pytest.mark.parametrize("n", [2, 5, 100])
def test_rewind_steps_matches_jax(optimizer, n):
    cfg = {"opt": {**OPT, "optimizer": optimizer}}
    rng = np.random.RandomState(0)
    w0 = rng.randn(6).astype(np.float32)
    grads = [rng.randn(6).astype(np.float32) for _ in range(8)]

    tx, _, _ = jax_optimization(cfg, num_tr_steps_per_epoch=STEPS_PER_EPOCH,
                                num_epochs=EPOCHS)
    js = JaxTrainState.create(apply_fn=None, params={"w": jnp.asarray(w0)},
                              batch_stats={}, tx=tx)
    w = nn.Parameter(torch.from_numpy(w0.copy()))
    opt, sched, _, _ = optimization_helper(
        cfg, [w], num_tr_steps_per_epoch=STEPS_PER_EPOCH, num_epochs=EPOCHS)
    ps = TrainState(nn.ParameterList([w]), opt, sched)

    def port_apply(g):
        w.grad = torch.from_numpy(g)
        ps.apply_gradients()

    for g in grads[:7]:
        js = js.apply_gradients(grads={"w": jnp.asarray(g)})
        port_apply(g)
    js = jax_rewind(js, n)
    assert rewind_steps(ps, n) is ps
    want_step = max(7 - n, 0)
    assert ps.step == int(js.step) == want_step
    counts = [int(leaf) for path, leaf in
              tree_util.tree_flatten_with_path(js.opt_state)[0]
              if isinstance(path[-1], tree_util.GetAttrKey)
              and path[-1].name == "count"]
    assert counts and set(counts) == {want_step}
    lr = warmup_cosine_schedule(1e-3, STEPS_PER_EPOCH,
                                STEPS_PER_EPOCH * EPOCHS)(want_step)
    assert abs(opt.param_groups[0]["lr"] - float(lr)) <= 1e-5 * float(lr) \
        or (lr == 0 and opt.param_groups[0]["lr"] == 0)
    jw, pw = np.asarray(js.params["w"]), w.detach().numpy().copy()
    js = js.apply_gradients(grads={"w": jnp.asarray(grads[7])})
    port_apply(grads[7])
    d_jax = np.asarray(js.params["w"]) - jw
    d_port = w.detach().numpy() - pw
    # lr(0) = 0 under the warm-up: a rewind to step 0 updates nothing
    assert (np.linalg.norm(d_jax) > 0) == (want_step > 0)
    np.testing.assert_allclose(d_port, d_jax, rtol=1e-5,
                               atol=1e-5 * np.abs(d_jax).max())


TINY_CFG = {"frontend": {"name": "leaf", "default_args": False,
                         "n_filters": 8},
            "audio_config": {"sample_rate": 16000},
            "model": {"arch": "efficientnet", "model_depth": "b0",
                      "num_classes": 3, "dropout_rate": 0.0,
                      "drop_connect_rate": 0.0}}


def _bn_layers(tree):
    if "mean" in tree:
        yield tree
        return
    for k in sorted(tree):
        yield from _bn_layers(tree[k])


def test_recalibrated_stats_match_jax():
    rng = np.random.RandomState(0)
    batches = [(rng.randn(4, 4000) * 0.1).astype(np.float32)
               for _ in range(3)]
    jm = JaxClassifier(cfg=TINY_CFG)
    v0 = jax.tree_util.tree_map(np.asarray, dict(jax.jit(
        lambda k, x: jm.init({"params": k}, x, train=False))(
        jax.random.PRNGKey(0), jnp.asarray(batches[0]))))
    js = JaxTrainState.create(apply_fn=jm.apply, params=v0["params"],
                              batch_stats=v0["batch_stats"],
                              tx=optax.identity())
    want = jax_recalibrate(js, batches, jax.random.PRNGKey(1))
    want = jax.tree_util.tree_map(np.asarray, want.batch_stats)

    model = load_jax_variables(Classifier(TINY_CFG, device="cpu"), v0)
    model.eval()
    params0 = {k: v.clone() for k, v in model.named_parameters()}
    state = recalibrate_batch_stats(
        TrainState(model, None), [(torch.from_numpy(x), None)
                                  for x in batches], None)
    assert not model.training        # the mode is restored
    for k, v in model.named_parameters():
        assert torch.equal(v, params0[k]), k   # parameters frozen
    got = import_torch_classifier(state.model.state_dict(), v0,
                                  "efficientnet")["batch_stats"]
    pairs = list(zip(_bn_layers(got), _bn_layers(want)))
    assert len(pairs) == 49
    moved = 0
    for g, w, w0 in zip(_bn_layers(got), _bn_layers(want),
                        _bn_layers(v0["batch_stats"])):
        sd, var = np.sqrt(w["var"]).max(), w["var"].max()
        assert np.abs(g["mean"] - w["mean"]).max() / sd < STATS_TOL
        assert np.abs(g["var"] - w["var"]).max() / var < STATS_TOL
        moved += not np.allclose(w["var"], w0["var"])
    assert moved == 49   # three passes moved every layer's stats
