"""World-of-N gloo jobs for tests/test_torch_port_parallel.py.

Imports no JAX: each rank is a process started by torch.multiprocessing
(spawn), joined through a FileStore. Run as

    python -m tests.torch_parallel_worker <job.pkl> <out_dir> <world>

where job.pkl (written by the test, unpickled here) names the tasks and
holds their inputs; every rank writes ``<out_dir>/rank<r>.pkl`` with its
results (numpy arrays and numbers). ``run_world`` does all of it from a
test. The ranks run on ``job["device"]`` (default the CPU; 'cuda:0' puts
both on one card, still over gloo).
"""

import os
import pickle
import subprocess
import sys
from contextlib import contextmanager

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOB_TIMEOUT = 300


def run_world(tmp_path, job, world=2):
    """Run ``job``'s tasks on ``world`` gloo ranks (a process, killed with
    its ranks at JOB_TIMEOUT s); every rank's results."""
    job_path = tmp_path / "job.pkl"
    with open(job_path, "wb") as f:
        pickle.dump(job, f)
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "tests.torch_parallel_worker", str(job_path),
         str(tmp_path), str(world)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=JOB_TIMEOUT)
    finally:
        if proc.poll() is None:     # the ranks are its children
            os.killpg(proc.pid, 9)
            proc.wait()
    assert proc.returncode == 0, out[-4000:]
    results = []
    for r in range(world):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def _np(sd):
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def _device(job):
    return torch.device(job.get("device", "cpu"))


def _cifar_state(job):
    """The job's model (weights from JAX variables ``v0`` or a
    ``state_dict``) with its optimizer and schedule."""
    from leaf_tpu_torch.models import Classifier, load_jax_variables
    from leaf_tpu_torch.training import TrainState, optimization_helper
    cfg = job["cfg"]
    model = Classifier(cfg, device=_device(job))
    if "v0" in job:
        load_jax_variables(model, job["v0"])
    else:
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in job["state_dict"].items()})
    opt, sched, _, _ = optimization_helper(cfg, model.parameters(),
                                           num_tr_steps_per_epoch=10,
                                           num_epochs=2)
    return TrainState(model, opt, sched)


def _metrics(m):
    return {k: float(v) for k, v in m.items()}


@contextmanager
def _per_replica_batch_norm():
    """The data-parallel step with its global-batch BatchNorm swapped for
    per-replica statistics: the fault the running-stat check must see."""
    from leaf_tpu_torch.parallel import sync_batch_norm as sbn
    real = sbn.sync_batch_norm

    @contextmanager
    def off(model, group):
        yield

    sbn.sync_batch_norm = off
    try:
        yield
    finally:
        sbn.sync_batch_norm = real


def task_bn(job, r, world, group):
    """Global BatchNorm forward and backward on this rank's rows (ragged
    split), and the per-replica layer's running stats beside it."""
    from leaf_tpu_torch.models.common import BatchNorm2d
    from leaf_tpu_torch.parallel.sync_batch_norm import sync_batch_norm
    lo, hi = job["bn_split"][r], job["bn_split"][r + 1]
    out = {}
    for sync in (True, False):
        bn = BatchNorm2d(job["bn_x"].shape[1], momentum=0.1)
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(job["bn_w"]))
            bn.bias.copy_(torch.from_numpy(job["bn_b"]))
        x = torch.from_numpy(job["bn_x"][lo:hi]).requires_grad_()
        with sync_batch_norm(bn, group if sync else None):
            y = bn(x)
            y.backward(torch.from_numpy(job["bn_dy"][lo:hi]))
        key = "sync" if sync else "local"
        out[key] = {"y": y.detach().numpy(), "dx": x.grad.numpy(),
                    "dw": bn.weight.grad.numpy(), "db": bn.bias.grad.numpy(),
                    "mean": bn.running_mean.numpy(),
                    "var": bn.running_var.numpy()}
    return out


def task_dp_step(job, r, world, group):
    """One data-parallel step (global BatchNorm) of the CIFAR-ResNet cfg
    on this rank's rows, and the same with per-replica BatchNorm."""
    from leaf_tpu_torch.ops.fused_frontend import (launch_counts,
                                                   reset_launch_counts)
    from leaf_tpu_torch.training import make_train_step
    x, y = job["x"], job["y"]
    per = x.shape[0] // world
    sl = slice(r * per, (r + 1) * per)
    out = {}
    for tag in ("global", "per_replica"):
        st = _cifar_state(job)
        if tag == "global":
            step = make_train_step(process_group=group)
        else:
            with _per_replica_batch_norm():
                step = make_train_step(process_group=group)
        reset_launch_counts()
        m = step(st, torch.from_numpy(x[sl]).to(_device(job)),
                 torch.from_numpy(y[sl]).to(_device(job)))
        out[tag] = {"metrics": _metrics(m), "sd": _np(st.model.state_dict()),
                    "launches": launch_counts()}
    return out


def task_shard_step(job, r, world, group):
    """One per-replica step (``make_shard_map_train_step``) on this rank's
    rows of the repeated batch."""
    from leaf_tpu_torch.parallel import make_mesh, make_shard_map_train_step
    x, y = job["x_rep"], job["y_rep"]
    per = x.shape[0] // world
    sl = slice(r * per, (r + 1) * per)
    st = _cifar_state(job)
    step = make_shard_map_train_step(make_mesh(), "multiclass")
    m = step(st, torch.from_numpy(x[sl]), torch.from_numpy(y[sl]),
             torch.Generator().manual_seed(2))
    return {"metrics": _metrics(m), "sd": _np(st.model.state_dict()),
            "step": st.step}


def task_mesh(job, r, world, group):
    """Mesh shapes, layouts, shard_batch / shard_params and the loop's
    collectives."""
    from torch.distributed.tensor import Replicate, Shard

    from leaf_tpu_torch import parallel as P
    out = {}
    mesh = P.make_mesh()
    out["mesh1"] = (mesh.mesh_dim_names, tuple(mesh.mesh.shape))
    mesh2 = P.make_mesh(model_parallel=world)
    out["mesh2"] = (mesh2.mesh_dim_names, tuple(mesh2.mesh.shape))
    try:
        P.make_mesh(model_parallel=world + 1)
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    out["placements"] = (P.batch_sharding(mesh) == (Shard(0),),
                         P.stacked_batch_sharding(mesh) == (Shard(1),),
                         P.replicated_sharding(mesh) == (Replicate(),),
                         P.batch_sharding(mesh2) == (Shard(0), Replicate()))
    batch = (np.arange(4 * world * 3).reshape(4 * world, 3),
             {"y": torch.arange(4 * world)})
    xs, ys = P.shard_batch(mesh, batch)
    stacked = P.shard_batch(mesh, torch.zeros(2, 4 * world, 5), stacked=True)
    out["shard_batch"] = (xs, ys["y"].numpy(), tuple(stacked.shape))
    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight.fill_(float(r))      # the replicas disagree
        lin.bias.fill_(1.0)
    out["disagree"] = P.shard_params(mesh, lin)
    out["agree"] = P.shard_params(mesh, lin)
    out["after"] = lin.weight.detach().numpy()
    rows = torch.full((r + 2, 2), float(r))
    out["gathered"] = P.all_gather_rows(rows).numpy()
    out["gathered_host"] = P.all_gather_rows(rows, P.host_group()).numpy()
    out["any_one"] = P.any_rank(r == 1)
    out["any_none"] = P.any_rank(False)
    out["mean"] = P.all_reduce_mean_(torch.tensor([float(r)])).item()
    out["local_slice"] = P.local_batch_slice(8 * world)
    return out


TASKS = {"bn": task_bn, "dp_step": task_dp_step,
         "shard_step": task_shard_step, "mesh": task_mesh}


def _rank_main(r, world, store, job_path, out_dir):
    torch.set_num_threads(2)
    # the card tests' fixture turns TF32 off in the test process
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=r, world_size=world)
    try:
        with open(job_path, "rb") as f:
            job = pickle.load(f)
        out = {name: TASKS[name](job, r, world, dist.group.WORLD)
               for name in job["tasks"]}
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def main(job_path: str, out_dir: str, world: int) -> None:
    store = os.path.join(out_dir, "store")
    mp.start_processes(_rank_main, args=(world, store, job_path, out_dir),
                       nprocs=world, start_method="spawn")


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]))
