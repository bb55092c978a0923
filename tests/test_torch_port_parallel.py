"""Data parallelism (``leaf_tpu_torch.parallel`` and the CLIs' DP flags)
against the JAX package's ``leaf_tpu.parallel`` on the CPU.

The JAX reference runs in this process on the root conftest's 8-device
fake mesh. The port runs as 2 gloo ranks, processes started by
``tests/torch_parallel_worker.py`` (torch.multiprocessing spawn, a
FileStore under tmp_path); one module-scoped job runs every world-2 task
and the tests read its results. Each rank process gets a time limit and
is killed at it.

Tolerances, each with its source:

- the world-2 data-parallel step against the JAX GSPMD step
  (tests/test_parallel.py::TestDataParallelMath's bounds): loss rtol
  5e-4, the parameter update per leaf 3e-2 of its norm, ``correct``
  equal;
- the world-2 shard step against ``make_shard_map_train_step`` on
  repeated data (tests/test_parallel.py::TestShardMapStep's bounds): loss
  rtol 5e-4, parameters per leaf 3e-2 of their norm, ``count`` equal,
  and, as for the step above, the update per leaf 3e-2 of JAX's (the
  parameters' bound alone would pass a skipped or doubled update, which
  the update bound fails);
- the CLI's validation at one device against the JAX CLI's val_loss
  (the mean of the batches' mean losses): rtol 5e-4;
- global BatchNorm at world 2 against one process's BatchNorm on the
  joined batch: 1e-5 (of each output's largest entry; the running stats
  of the layer's scale). A per-replica BatchNorm in its place misses it
  by orders of magnitude (the halves differ in scale);
- with one rank every collective is a sum of one term: the step is
  bit-equal to the single-device step.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from leaf_tpu.models import Classifier as JaxClassifier
from leaf_tpu.models.torch_import import import_torch_classifier
from leaf_tpu.parallel import (loader_batch_size as jax_loader_batch_size,
                               make_mesh as jax_make_mesh,
                               shard_batch as jax_shard_batch,
                               shard_params as jax_shard_params)
from leaf_tpu.parallel.mesh import (
    local_batch_slice as jax_local_batch_slice)
from leaf_tpu.parallel.shard_step import (
    make_shard_map_train_step as jax_shard_map_step)
from leaf_tpu.training import TrainState as JaxTrainState
from leaf_tpu.training import make_train_step as jax_train_step
from leaf_tpu.training import optimization_helper as jax_optimization
from leaf_tpu_torch import parallel as P
from leaf_tpu_torch.data.loader import ShardedSampler
from leaf_tpu_torch.training import optimization_helper
from tests.torch_parallel_worker import REPO, run_world

CFG = {  # tests/test_parallel.py::TestDataParallelMath's cfg
    "frontend": {"name": "leaf", "default_args": False, "n_filters": 40},
    "audio_config": {"sample_rate": 16000},
    "model": {"arch": "cifar_resnet", "model_depth": 20,
              "num_classes": 5, "type": "multiclass"},
    "opt": {"optimizer": "SGD", "lr": 1e-2, "momentum": 0.0,
            "nesterov": False, "weight_decay": 0.0,
            "scheduler": "step", "step_size": 100, "gamma": 0.1,
            "batch_size": 16},
}
LOSS_RTOL, UPDATE_TOL, PARAM_TOL, BN_TOL = 5e-4, 3e-2, 3e-2, 1e-5
STATS_TOL = 1e-4   # port vs JAX running stats, of the layer's scale


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, dict(tree))


def _jax_state(v0):
    jm = JaxClassifier(cfg=CFG)
    tx, _, _ = jax_optimization(CFG, num_tr_steps_per_epoch=10)
    return JaxTrainState.create(apply_fn=jm.apply, params=v0["params"],
                                batch_stats=v0["batch_stats"], tx=tx)


def _on_mesh(mesh, state):
    return state.replace(params=jax_shard_params(mesh, state.params),
                         batch_stats=jax_shard_params(mesh,
                                                      state.batch_stats),
                         opt_state=jax_shard_params(mesh, state.opt_state))


@pytest.fixture(scope="module")
def jax_v0():
    """The JAX variables of CFG's classifier, as numpy."""
    jm = JaxClassifier(cfg=CFG)
    return _np_tree(jax.jit(lambda k, xx: jm.init({"params": k}, xx,
                                                  train=False))(
        jax.random.PRNGKey(0), jnp.zeros((16, 4000), jnp.float32)))


@pytest.fixture(scope="module")
def world2(tmp_path_factory, jax_v0):
    """The JAX references and the port's world-2 results."""
    tmp = tmp_path_factory.mktemp("world2")
    rng = np.random.RandomState(0)
    x = (rng.randn(16, 4000) * 0.1).astype("float32")
    x[8:] *= 3.0    # the two halves differ: per-replica statistics would too
    y = (np.arange(16) % 5).astype("int32")
    x1 = (rng.randn(2, 4000) * 0.1).astype("float32")
    x_rep, y_rep = np.tile(x1, (8, 1)), np.tile(np.arange(2, dtype="int32"), 8)
    v0 = jax_v0
    bn_x = (rng.randn(8, 4, 5, 6) * 2 + 1).astype("float32")
    bn_x[3:] = bn_x[3:] * 0.5 - 2.0     # rank 1's 5 rows: another scale
    job = {"tasks": ["bn", "dp_step", "shard_step", "mesh"], "cfg": CFG,
           "v0": v0, "x": x, "y": y.astype("int64"), "x_rep": x_rep,
           "y_rep": y_rep.astype("int64"), "bn_x": bn_x,
           "bn_dy": rng.randn(8, 4, 5, 6).astype("float32"),
           "bn_w": rng.rand(4).astype("float32") + 0.5,
           "bn_b": rng.randn(4).astype("float32"), "bn_split": [0, 3, 8]}
    ranks = run_world(tmp, job)

    mesh = jax_make_mesh()
    step = jax_train_step("multiclass", donate=False)
    with mesh:
        s8, m8 = step(_on_mesh(mesh, _jax_state(v0)),
                      jax_shard_batch(mesh, jnp.asarray(x)),
                      jax_shard_batch(mesh, jnp.asarray(y)),
                      jax.random.PRNGKey(2))
        s_sm, m_sm = jax_shard_map_step(mesh, "multiclass")(
            _on_mesh(mesh, _jax_state(v0)),
            jax_shard_batch(mesh, jnp.asarray(x_rep)),
            jax_shard_batch(mesh, jnp.asarray(y_rep)),
            jax.random.PRNGKey(2))
    return {"job": job, "ranks": ranks, "v0": v0,
            "gspmd": (_np_tree({"params": s8.params,
                                "batch_stats": s8.batch_stats}),
                      {k: float(v) for k, v in m8.items()}),
            "shard_map": (_np_tree({"params": s_sm.params,
                                    "batch_stats": s_sm.batch_stats}),
                          {k: float(v) for k, v in m_sm.items()})}


def _to_jax(sd, v0):
    return import_torch_classifier({k: np.asarray(v) for k, v in sd.items()},
                                   v0, "cifar_resnet")


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


# ------------------------------------------------------ batch semantics

@pytest.mark.parametrize("args", [
    (4, 8, 1, "per_device"), (32, 8, 1, "global"), (4, 8, 2, "per_device"),
    (32, 8, 2, "global"), (256, 1, 1, "per_device"), (256, 1, 1, "global"),
    (3, 8, 1, "global"), (3, 1, 2, "per_device"), (4, 8, 1, "percore")])
def test_loader_batch_size_matches_jax(args):
    # tests/test_parallel.py::TestBatchSemantics' cases, errors included
    try:
        want = jax_loader_batch_size(*args)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            P.loader_batch_size(*args)
        assert str(got.value) == str(e)
        return
    assert P.loader_batch_size(*args) == want


def test_loader_batch_size_defaults_to_the_world():
    # no process group: one process
    assert P.loader_batch_size(4, 1) == jax_loader_batch_size(4, 1, 1)


@pytest.mark.parametrize("n,index,count", [(16, 0, 2), (16, 1, 2),
                                           (32, 3, 4), (8, 0, 1)])
def test_local_batch_slice_matches_jax(n, index, count):
    assert (P.local_batch_slice(n, index, count)
            == jax_local_batch_slice(n, index, count))


@pytest.mark.parametrize("length,world", [(24, 2), (23, 2), (1024, 8),
                                          (13, 4)])
def test_sharded_sampler_gives_every_rank_as_many_batches(length, world):
    # train shards are padded: every rank runs as many steps, so none
    # waits alone on a collective; val shards are not: each clip once
    train = [len(ShardedSampler(length, world, r)) for r in range(world)]
    assert len(set(train)) == 1
    val = [list(ShardedSampler(length, world, r, shuffle=False, pad=False))
           for r in range(world)]
    assert sorted(sum(val, [])) == list(range(length))
    assert [len(v) for v in val] == [len(ShardedSampler(
        length, world, r, shuffle=False, pad=False)) for r in range(world)]


@pytest.mark.parametrize("n_dev,scale", [(1, False), (4, False), (4, True),
                                         (8, True)])
@pytest.mark.parametrize("scheduler", ["reduce", "step"])
def test_optimization_helper_scales_lr_as_jax(n_dev, scale, scheduler):
    cfg = {**CFG, "opt": {**CFG["opt"], "scheduler": scheduler}}
    jtx, jplateau, _ = jax_optimization(cfg, num_devices=n_dev,
                                        num_tr_steps_per_epoch=10,
                                        per_device_lr_scaling=scale)
    p = torch.nn.Parameter(torch.ones(3))
    opt, _, plateau, _ = optimization_helper(
        cfg, [p], num_tr_steps_per_epoch=10, num_devices=n_dev,
        per_device_lr_scaling=scale)
    # one SGD update of a unit gradient is −lr
    g = {"w": jnp.ones(3)}
    upd, _ = jtx.update(g, jtx.init({"w": jnp.ones(3)}), {"w": jnp.ones(3)})
    p.grad = torch.ones(3)
    opt.step()
    np.testing.assert_allclose(1.0 - p.detach().numpy(),
                               -np.asarray(upd["w"]), rtol=1e-6)
    if scheduler == "reduce":
        assert plateau.lr == pytest.approx(jplateau.lr)


# ----------------------------------------------------- one-process world

@pytest.fixture
def world1(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_make_mesh_shapes_and_indivisible_raise(world1):
    mesh = P.make_mesh()
    assert mesh.mesh_dim_names == ("data",) and tuple(mesh.mesh.shape) == (1,)
    with pytest.raises(ValueError, match="not divisible by model_parallel"):
        P.make_mesh(model_parallel=2)
    with pytest.raises(ValueError, match="needs 2 processes"):
        P.make_mesh(2)


def _small_state(remat=False):
    from leaf_tpu_torch.models import Classifier
    from leaf_tpu_torch.training import TrainState
    cfg = {**CFG, "frontend": {**CFG["frontend"], "n_filters": 8},
           "opt": {"optimizer": "Adam", "lr": 1e-3, "weight_decay": 1e-4,
                   "scheduler": "warmupcosine", "warmup_epochs": 1}}
    if remat:   # b0 under common.remat: the recompute syncs again
        cfg["model"] = {"arch": "efficientnet", "model_depth": "b0",
                        "num_classes": 5, "remat": True}
    model = Classifier(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    opt, sched, _, _ = optimization_helper(
        cfg, model.parameters(), num_tr_steps_per_epoch=2, num_epochs=4)
    return TrainState(model, opt, sched)


@pytest.mark.parametrize("kind", ["gspmd", "shard_map", "gspmd_remat"])
def test_world_of_one_is_the_single_device_step(world1, kind):
    # the collectives run (a sum of one term each): the loss, the counts,
    # every parameter and buffer are bit-equal to the plain step's (b0
    # with remat and dropout: the generators start equal)
    from leaf_tpu_torch.training import make_train_step
    rng = np.random.RandomState(1)
    x = torch.from_numpy((rng.randn(6, 4000) * 0.1).astype("float32"))
    y = torch.from_numpy(rng.randint(0, 5, 6))
    remat = kind.endswith("remat")
    a, b = _small_state(remat), _small_state(remat)
    ga, gb = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    plain = make_train_step()
    dp = (P.make_shard_map_train_step(P.make_mesh()) if kind == "shard_map"
          else make_train_step(process_group=world1))
    for _ in range(3):
        ma = plain(a, x, y, None if kind == "shard_map" else ga)
        mb = dp(b, x, y, None if kind == "shard_map" else gb)
        for key in ("loss", "correct", "count"):
            assert torch.equal(ma[key], mb[key]), key
    assert b.step == 3
    for (name, t), u in zip(a.model.state_dict().items(),
                            b.model.state_dict().values()):
        assert torch.equal(t, u), name


def test_multistep_over_gloo_runs_its_steps_on_the_cpu(world1):
    # on the CPU K data-parallel steps per call run one after another
    # (bit-equal to K single steps); on the card gloo raises, naming NCCL
    # (tests/test_torch_port_cuda.py)
    from leaf_tpu_torch.training import (make_train_multistep,
                                         make_train_step)
    rng = np.random.RandomState(2)
    xs = torch.from_numpy((rng.randn(2, 4, 4000) * 0.1).astype("float32"))
    ys = torch.from_numpy(rng.randint(0, 5, (2, 4)))
    a, b = _small_state(), _small_state()
    got = make_train_multistep(2, process_group=world1)(a, xs, ys)
    step = make_train_step(process_group=world1)
    ref = [step(b, xs[i], ys[i]) for i in range(2)]
    assert torch.equal(got["loss"], torch.stack([m["loss"]
                                                 for m in ref]).mean())
    for t, u in zip(a.model.state_dict().values(),
                    b.model.state_dict().values()):
        assert torch.equal(t, u)


# ----------------------------------------------------------- world of 2

def test_mesh_and_collectives_at_world_2(world2):
    for r, res in enumerate(world2["ranks"]):
        m = res["mesh"]
        assert m["mesh1"] == (("data",), (2,))
        assert m["mesh2"] == (("data", "model"), (1, 2))
        assert "not divisible by model_parallel=3" in m["indivisible"]
        assert all(m["placements"])
        xs, ys, stacked = m["shard_batch"]
        want = np.arange(24).reshape(8, 3)[r * 4:(r + 1) * 4]
        np.testing.assert_array_equal(xs, want)
        np.testing.assert_array_equal(ys, np.arange(8)[r * 4:(r + 1) * 4])
        assert stacked == (2, 4, 5)
        assert m["disagree"] == 1.0 and m["agree"] == 0.0
        np.testing.assert_array_equal(m["after"], np.zeros((2, 3)))
        rows = np.concatenate([np.zeros((2, 2)), np.ones((3, 2))])
        np.testing.assert_array_equal(m["gathered"], rows)
        np.testing.assert_array_equal(m["gathered_host"], rows)
        assert m["any_one"] is True and m["any_none"] is False
        assert m["mean"] == 0.5
        assert m["local_slice"] == jax_local_batch_slice(16, r, 2)


def _bn_reference(job):
    from leaf_tpu_torch.models.common import BatchNorm2d
    bn = BatchNorm2d(4, momentum=0.1)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(job["bn_w"]))
        bn.bias.copy_(torch.from_numpy(job["bn_b"]))
    x = torch.from_numpy(job["bn_x"]).requires_grad_()
    y = bn(x)
    y.backward(torch.from_numpy(job["bn_dy"]))
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(),
            "dw": bn.weight.grad.numpy(), "db": bn.bias.grad.numpy(),
            "mean": bn.running_mean.numpy(), "var": bn.running_var.numpy()}


def _bn_errors(ranks, ref, key):
    """Worst error / scale of each quantity of the world-2 layer ``key``
    ('sync' or 'local') against the joined-batch layer."""
    got = [r["bn"][key] for r in ranks]
    joined = {k: np.concatenate([g[k] for g in got]) for k in ("y", "dx")}
    summed = {k: sum(g[k] for g in got) for k in ("dw", "db")}
    err = {}
    for k in ("y", "dx"):
        err[k] = np.abs(joined[k] - ref[k]).max() / np.abs(ref[k]).max()
    for k in ("dw", "db"):
        err[k] = np.abs(summed[k] - ref[k]).max() / np.abs(ref[k]).max()
    for k in ("mean", "var"):   # every rank holds the same running stats
        err[k] = max(np.abs(g[k] - ref[k]).max() for g in got) / (
            np.abs(ref[k]).max())
    return err


def test_global_batch_norm_equals_the_joined_batch(world2):
    ref = _bn_reference(world2["job"])
    err = _bn_errors(world2["ranks"], ref, "sync")
    assert max(err.values()) < BN_TOL, err


def test_per_replica_batch_norm_fails_the_check(world2):
    # the check sees the fault: per-replica statistics in place of the
    # global ones miss the joined batch's running stats by far more
    ref = _bn_reference(world2["job"])
    err = _bn_errors(world2["ranks"], ref, "local")
    assert err["var"] > 1e3 * BN_TOL and err["y"] > 1e3 * BN_TOL, err


def _update_errors(params, params_jax, params0, scale=1.0):
    """Per leaf, (error, bound): the port's update p − p0 (times
    ``scale``: a planted fault) against JAX's, relative to JAX's, bound
    UPDATE_TOL; a leaf JAX leaves in place reads the port's largest move,
    bound 1e-7."""
    errs = {}
    for (path, a), b, c in zip(_leaves(params),
                               jax.tree_util.tree_leaves(params_jax),
                               jax.tree_util.tree_leaves(params0)):
        upd_port, upd_jax = scale * (a - c), np.asarray(b) - c
        denom = np.linalg.norm(upd_jax)
        errs[jax.tree_util.keystr(path)] = (
            (float(np.abs(upd_port - upd_jax).max()), 1e-7) if denom < 1e-12
            else (float(np.linalg.norm(upd_port - upd_jax) / denom),
                  UPDATE_TOL))
    return errs


def _assert_updates_match(params, params_jax, params0):
    for path, (err, tol) in _update_errors(params, params_jax,
                                           params0).items():
        assert err < tol, (path, err, tol)


def test_dp_step_matches_the_jax_gspmd_step(world2):
    vj, mj = world2["gspmd"]
    v0 = world2["v0"]
    for res in world2["ranks"]:
        got = res["dp_step"]["global"]
        m = got["metrics"]
        np.testing.assert_allclose(m["loss"], mj["loss"], rtol=LOSS_RTOL)
        assert int(m["correct"]) == int(mj["correct"])
        assert int(m["count"]) == 16
        back = _to_jax(got["sd"], v0)
        _assert_updates_match(back["params"], vj["params"], v0["params"])
    # the replicas agree bit for bit
    a, b = (r["dp_step"]["global"]["sd"] for r in world2["ranks"])
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def _bn_layers(tree):
    if "mean" in tree:
        yield tree
        return
    for k in sorted(tree):
        yield from _bn_layers(tree[k])


def _running_stat_error(sd, ref_stats, v0):
    """The worst running-stat error over the layers: the mean's against
    the layer's largest sd, the variance's against its largest var."""
    back = _to_jax(sd, v0)["batch_stats"]
    worst = 0.0
    for got, want in zip(_bn_layers(back), _bn_layers(ref_stats)):
        var = np.asarray(want["var"])
        worst = max(worst,
                    np.abs(got["mean"] - want["mean"]).max()
                    / np.sqrt(var).max(),
                    np.abs(got["var"] - var).max() / var.max())
    return float(worst)


def test_dp_step_running_stats_are_the_global_batch_s(world2):
    # the running stats the GSPMD step keeps (global-batch statistics);
    # the same step with per-replica BatchNorm swapped in fails this
    vj, _ = world2["gspmd"]
    res = world2["ranks"][0]["dp_step"]
    good = _running_stat_error(res["global"]["sd"], vj["batch_stats"],
                               world2["v0"])
    bad = _running_stat_error(res["per_replica"]["sd"], vj["batch_stats"],
                              world2["v0"])
    assert good < STATS_TOL, good
    assert bad > 10 * STATS_TOL, bad


def test_shard_step_matches_jax_shard_map_step(world2):
    vj, mj = world2["shard_map"]
    for res in world2["ranks"]:
        got = res["shard_step"]
        assert got["step"] == 1
        np.testing.assert_allclose(got["metrics"]["loss"], mj["loss"],
                                   rtol=LOSS_RTOL)
        assert int(got["metrics"]["count"]) == int(mj["count"]) == 16
        assert int(got["metrics"]["correct"]) == int(mj["correct"])
        back = _to_jax(got["sd"], world2["v0"])
        for (path, a), b in zip(_leaves(back["params"]),
                                jax.tree_util.tree_leaves(vj["params"])):
            b = np.asarray(b)
            rel = np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12)
            assert rel < PARAM_TOL, (jax.tree_util.keystr(path), rel)
        # the update itself: one SGD step moves each leaf by far less than
        # PARAM_TOL of its norm, so the check above alone would pass a step
        # that skipped the update or summed the ranks' gradients
        _assert_updates_match(back["params"], vj["params"],
                              world2["v0"]["params"])
        for (path, a), b in zip(_leaves(back["batch_stats"]),
                                jax.tree_util.tree_leaves(vj["batch_stats"])):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4,
                                       atol=1e-5)


@pytest.mark.parametrize("scale", [0.0, 2.0])
def test_update_check_sees_a_skipped_or_summed_update(world2, scale):
    # the shard step's update, planted as skipped (0×) or as the sum of
    # the two ranks' gradients (2×; the ranks' gradients are equal on
    # repeated data), fails the update check both step tests hold
    vj, _ = world2["shard_map"]
    back = _to_jax(world2["ranks"][0]["shard_step"]["sd"], world2["v0"])
    errs = _update_errors(back["params"], vj["params"],
                          world2["v0"]["params"], scale=scale)
    moved = [e for e, tol in errs.values() if tol == UPDATE_TOL]
    assert moved and min(moved) > 10 * UPDATE_TOL, errs


def test_validate_val_loss_is_the_jax_cli_s(jax_v0):
    # one device, a ragged val set (batches of 4 and 2): the JAX CLI's
    # val_loss, the sum of the batches' mean losses over the number of
    # batches (train.py's validation), and its val_acc
    from leaf_tpu.training import make_eval_step as jax_eval_step
    from leaf_tpu_torch.train import validate
    from leaf_tpu_torch.training import make_eval_step
    from tests.torch_parallel_worker import _cifar_state
    rng = np.random.RandomState(3)
    batches = [((rng.randn(n, 4000) * s).astype("float32"),
                rng.randint(0, 5, n).astype("int64"))
               for n, s in ((4, 0.1), (2, 3.0))]
    state = _cifar_state({"cfg": CFG, "v0": jax_v0})
    val_loss, val_acc = validate(
        state, batches, make_eval_step("multiclass"),
        lambda b: tuple(torch.from_numpy(a) for a in b), multiclass=True)

    jstate, jstep = _jax_state(jax_v0), jax.jit(jax_eval_step("multiclass"))
    ms = [jstep(jstate, jnp.asarray(x), jnp.asarray(y.astype("int32")))
          for x, y in batches]
    want_loss = sum(float(m["loss"]) for m in ms) / len(batches)
    want_acc = sum(int(m["correct"]) for m in ms) / 6
    np.testing.assert_allclose(val_loss, want_loss, rtol=LOSS_RTOL)
    assert val_acc == want_acc
    # the mean over clips is another number here: the check tells them
    # apart
    per_clip = sum(float(m["loss"]) * int(m["count"]) for m in ms) / 6
    assert abs(per_clip - want_loss) > 10 * LOSS_RTOL * abs(want_loss)


# ------------------------------------------------------------- the CLIs

def test_cli_data_parallel_flags_need_a_launcher(tmp_path):
    from leaf_tpu_torch import evaluate, train
    with pytest.raises(RuntimeError, match="--nproc_per_node 2 -m "
                       "leaf_tpu_torch.evaluate"):
        evaluate.main(["--exp_dir", str(tmp_path), "--meta_dir",
                       str(tmp_path), "--test_csv_name", "t.csv",
                       "--device", "cpu", "--n_devices", "2"])
    with pytest.raises(RuntimeError, match="--nproc_per_node 4 -m "
                       "leaf_tpu_torch.train"):
        train.main(["--cfg_file", "x.cfg", "--expdir", str(tmp_path),
                    "--device", "cpu", "--n_devices", "4"])
    assert not dist.is_initialized()


# -------------------------------------- 2-rank CLI runs (marked slow) ---
# Each starts two CLI processes (a minute of CPU each on this box), the
# counterparts of tests/test_multihost_train.py, which the root conftest
# marks slow as a file.

def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _plain_env():
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"}
    for k in ("XLA_FLAGS", "RANK", "WORLD_SIZE", "LOCAL_RANK",
              "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    return env


def _cli_env(rank, world, port):
    return {**_plain_env(), "RANK": str(rank), "WORLD_SIZE": str(world),
            "LOCAL_RANK": str(rank), "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(port)}


def _start_ranks(module, argv, tmp_path, tag, world=2):
    """``world`` processes of ``python -m module argv`` with the variables
    torchrun sets; (processes, their output files)."""
    port = _free_port()
    procs, logs = [], []
    for r in range(world):
        log = open(tmp_path / f"{tag}_rank{r}.log", "w")
        logs.append(tmp_path / f"{tag}_rank{r}.log")
        procs.append(subprocess.Popen(
            [sys.executable, "-u", "-m", module, *argv], cwd=REPO,
            env=_cli_env(r, world, port), stdout=log,
            stderr=subprocess.STDOUT))
        log.close()
    return procs, logs


def _wait_ranks(procs, logs, timeout=600):
    try:
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:     # a rank stuck in a collective: kill them all
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = [log.read_text() for log in logs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


def _train_argv(root, expdir, epochs, *extra):
    return ["--cfg_file", str(root / "cfg.cfg"), "--expdir", str(expdir),
            "--epochs", str(epochs), "--num_workers", "1", "--log_steps",
            "1", "--device", "cpu", "--n_devices", "2", *extra]


def _tiny_exp(tmp_path, mode="multiclass"):
    from tests.test_torch_port_cuda import make_tiny_exp
    root = make_tiny_exp(tmp_path)
    cfg = root / "cfg.cfg"
    cfg.write_text(cfg.read_text().replace(
        "scheduler: warmupcosine", "scheduler: reduce").replace(
        "type: multiclass", f"type: {mode}"))
    return root


_EPOCH = r"epoch (\d+): .*val_loss (\S+) {metric} (\S+) "
_RANK1 = r"epoch (\d+) \[rank 1\]: val_loss (\S+) {metric} (\S+)"


def _agreeing_epochs(outs, metric="val_acc"):
    import re
    rank0 = re.findall(_EPOCH.format(metric=metric), outs[0])
    rank1 = re.findall(_RANK1.format(metric=metric), outs[1])
    assert rank0 and rank0 == rank1, (outs[0][-2000:], outs[1][-2000:])
    return rank0


@pytest.mark.slow
def test_train_cli_two_ranks_end_to_end(tmp_path):
    # torchrun (standalone) starts the two ranks: per-rank loader shards,
    # rank-0 checkpoints with the single-device state_dict keys, equal
    # val metrics on both ranks; the checkpoint loads in the one-device
    # evaluate and in the 2-rank evaluate, which report the same accuracy
    import re

    from leaf_tpu_torch.models import Classifier
    root = _tiny_exp(tmp_path)
    expdir = tmp_path / "exp"
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "leaf_tpu_torch.train",
         *_train_argv(root, expdir, 2)], cwd=REPO, timeout=600,
        env=_plain_env(),
        capture_output=True, text=True)
    out = res.stdout + res.stderr
    assert res.returncode == 0, out[-4000:]
    assert "devices: 2 |" in out and "batch/step: 8 (per_device)" in out
    # 24 clips over 2 ranks, 4 per rank and step: 3 steps an epoch
    assert re.search(r"train batches/epoch: 3 \|", out), out[-3000:]
    assert len(_agreeing_epochs([out, out])) == 2
    assert sorted(d for d in os.listdir(expdir)
                  if d.startswith("epoch_")) == ["epoch_000", "epoch_001"]
    blob = torch.load(expdir / "epoch_001" / "state.pt", weights_only=True)
    import json
    cfg = json.loads((expdir / "hparams.json").read_text())
    keys = Classifier(cfg, device="cpu").state_dict().keys()
    assert list(blob["model"]) == list(keys)
    shapes = jax.eval_shape(
        lambda: JaxClassifier(cfg=cfg).init(
            {"params": jax.random.PRNGKey(0)},
            jnp.zeros((1, 4000)), train=False))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                   dict(shapes))
    back = import_torch_classifier(
        {k: v.numpy() for k, v in blob["model"].items()}, zeros,
        "efficientnet")
    assert jax.tree_util.tree_structure(back["params"]) == \
        jax.tree_util.tree_structure(zeros["params"])
    eval_argv = ["--exp_dir", str(expdir), "--meta_dir", str(root),
                 "--test_csv_name", "test.csv", "--device", "cpu"]
    one = subprocess.run([sys.executable, "-m", "leaf_tpu_torch.evaluate",
                          *eval_argv], cwd=REPO, env=_plain_env(),
                         capture_output=True, text=True, timeout=300)
    assert one.returncode == 0, one.stdout[-3000:] + one.stderr[-2000:]
    acc = re.search(r"Accuracy: (\S+)", one.stdout).group(1)
    os.remove(expdir / "results.txt")
    procs, logs = _start_ranks("leaf_tpu_torch.evaluate",
                               eval_argv + ["--n_devices", "2"], tmp_path,
                               "eval")
    outs = _wait_ranks(procs, logs, 300)
    assert f"Accuracy: {acc}" in outs[0], outs[0][-2000:]
    assert f"rank 1: Accuracy: {acc}" in outs[1], outs[1][-2000:]
    assert (expdir / "results.txt").exists()


@pytest.mark.slow
def test_train_cli_two_ranks_resume_from_latest(tmp_path):
    root = _tiny_exp(tmp_path)
    expdir = tmp_path / "exp"
    _wait_ranks(*_start_ranks("leaf_tpu_torch.train",
                              _train_argv(root, expdir, 1), tmp_path, "a"))
    outs = _wait_ranks(*_start_ranks(
        "leaf_tpu_torch.train", _train_argv(root, expdir, 2,
                                            "--continue_from_ckpt", "latest"),
        tmp_path, "b"))
    assert "resumed from" in outs[0] and "at epoch 1" in outs[0], \
        outs[0][-3000:]
    assert [e[0] for e in _agreeing_epochs(outs)] == ["1"]


@pytest.mark.slow
def test_train_cli_sigterm_on_one_rank_stops_both(tmp_path):
    # SIGTERM reaches rank 1 only: the ranks agree at the next log step,
    # both stop at the same step, rank 0 writes the preempt checkpoint
    import signal
    import time
    root = _tiny_exp(tmp_path)
    expdir = tmp_path / "exp"
    procs, logs = _start_ranks("leaf_tpu_torch.train",
                               _train_argv(root, expdir, 50), tmp_path, "p")
    deadline = time.time() + 300
    while " step 1/" not in logs[0].read_text():
        assert time.time() < deadline and procs[0].poll() is None, \
            logs[0].read_text()[-3000:]
        time.sleep(0.2)
    procs[1].send_signal(signal.SIGTERM)
    outs = _wait_ranks(procs, logs, 300)
    assert "SIGTERM: checkpointed mid-epoch" in outs[0], outs[0][-3000:]
    preempt = [d for d in os.listdir(expdir) if d.endswith("_preempt")]
    assert len(preempt) == 1, os.listdir(expdir)
    meta = (expdir / preempt[0] / "meta.json").read_text()
    assert '"val_acc": -1.0' in meta


@pytest.mark.slow
def test_train_cli_two_ranks_multilabel_gathers_val_outputs(tmp_path):
    root = _tiny_exp(tmp_path, "multilabel")
    outs = _wait_ranks(*_start_ranks(
        "leaf_tpu_torch.train", _train_argv(root, tmp_path / "exp", 1),
        tmp_path, "ml"))
    (epoch, _, m_ap), = _agreeing_epochs(outs, "val_mAP")
    assert 0.0 <= float(m_ap) <= 1.0


@pytest.mark.slow
def test_dryrun_multichip_two_ranks(capsys):
    from leaf_tpu_torch.dryrun import dryrun_multichip
    line = dryrun_multichip(2, device="cpu")
    assert "dryrun_multichip(2): ok" in line
    assert "bit-identical" in capsys.readouterr().out


def test_dryrun_on_the_card_needs_a_card_per_rank():
    # the dry run defaults to the card: with fewer cards than ranks (none
    # here) it raises, naming the CPU option
    from leaf_tpu_torch.dryrun import dryrun_multichip
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_multichip(torch.cuda.device_count() + 1)


def test_entry_returns_the_flagship_forward():
    from leaf_tpu_torch.dryrun import entry
    fn, args = entry(device="cpu")
    out = fn(*args)
    assert out.shape == (8, 35) and bool(torch.isfinite(out).all())
