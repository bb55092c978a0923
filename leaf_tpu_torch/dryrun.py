"""Entry points for compile and multi-device checks (the port's
``__graft_entry__``).

``entry()`` — the flagship forward (LEAF + EfficientNet-b0, the SCv2
recipe) at B=8 as a function of its parameters, buffers and waveforms.

``dryrun_multichip(n)`` — n data-parallel ranks (one process each:
NCCL, one card per rank; ``device="cpu"``: gloo on the CPU) run the JAX
``dryrun_multichip``'s program: one global-BatchNorm step and one per-replica step of the
CIFAR-ResNet-20 smoke cfg, a 20-step loss trend on tones, a checkpoint
save → restore → step that is bit-identical, the flagship b0 (dropout 0)
with both steps from one pre-step state on data repeated on every rank
(losses within 1e-3), and a K = 2 multistep.

    python -m leaf_tpu_torch.dryrun 2                # 2 cards
    python -m leaf_tpu_torch.dryrun 2 --device cpu   # 2 gloo ranks
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

FLAGSHIP_CFG = {
    "frontend": {"name": "leaf", "default_args": True},
    "audio_config": {"sample_rate": 16000},
    "model": {"arch": "efficientnet", "model_depth": "b0",
              "num_classes": 35, "type": "multiclass"},
    "opt": {"optimizer": "Adam", "lr": 1e-3, "weight_decay": 1e-4,
            "scheduler": "warmupcosine", "warmup_epochs": 10,
            "batch_size": 256},
}
CLIP = 4000          # 0.25 s clips
PER_RANK = 2         # clips per rank and step
AGREE_RTOL = 1e-3    # the two steps' flagship losses (identical shards)


def entry(device=None):
    """(fn, example_args): fn(params, buffers, waveforms) → logits of the
    flagship classifier in eval mode, at B=8 (on the card unless
    ``device`` names another)."""
    from leaf_tpu_torch.models import Classifier
    model = Classifier(FLAGSHIP_CFG, device=device,
                       generator=torch.Generator().manual_seed(0)).eval()
    dev = next(model.parameters()).device
    x = torch.zeros((8, 16000), device=dev)

    def fn(params, buffers, waveforms):
        with torch.no_grad():
            return torch.func.functional_call(model, (params, buffers),
                                              (waveforms,))

    return fn, (dict(model.named_parameters()), dict(model.named_buffers()),
                x)


def _state(cfg, n, seed):
    from leaf_tpu_torch.models import Classifier
    from leaf_tpu_torch.training import TrainState, optimization_helper
    on_card = torch.distributed.get_backend() == "nccl"
    device = torch.device("cuda", torch.cuda.current_device()) if (
        on_card) else torch.device("cpu")
    model = Classifier(cfg, device=device,
                       generator=torch.Generator().manual_seed(seed))
    # capturable on the card: the K-step call is a CUDA graph there
    opt, sched, _, _ = optimization_helper(
        cfg, model.parameters(), num_tr_steps_per_epoch=10, num_epochs=2,
        capturable=on_card, num_devices=n)
    return TrainState(model, opt, sched)


def _smoke_cfg(arch, depth, classes, n, **model):
    return {"frontend": {"name": "leaf", "default_args": False,
                         "n_filters": 40},
            "audio_config": {"sample_rate": 16000},
            "model": {"arch": arch, "model_depth": depth,
                      "num_classes": classes, "type": "multiclass", **model},
            "opt": {"optimizer": "Adam", "lr": 1e-3, "weight_decay": 1e-4,
                    "scheduler": "warmupcosine", "warmup_epochs": 1,
                    "batch_size": PER_RANK * n}}


def _program(rank: int, n: int, ckdir: str) -> str:
    """The dry run on this rank; returns its report line (rank 0's)."""
    import leaf_tpu_torch.parallel as P
    from leaf_tpu_torch.training import make_train_multistep, make_train_step
    from leaf_tpu_torch.training.checkpoint import (load_checkpoint,
                                                    save_checkpoint)
    group = P.data_group()
    mesh = P.make_mesh(n)
    batch = PER_RANK * n
    cfg = _smoke_cfg("cifar_resnet", 20, 8, n)
    state = _state(cfg, n, 0)
    dev = next(state.model.parameters()).device
    if P.shard_params(mesh, state.model) != 0.0:
        raise AssertionError("the ranks built different weights")

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    step = make_train_step("multiclass", process_group=group)
    x = P.shard_batch(mesh, np.random.RandomState(0).randn(batch, CLIP)
                      .astype("float32") * 0.1)
    y = P.shard_batch(mesh, np.arange(batch) % 8)
    gen = torch.Generator(device=dev).manual_seed(1 + rank)
    loss = float(step(state, put(x), put(y), gen)["loss"])
    if not (state.step == 1 and np.isfinite(loss) and loss < 1e4):
        raise AssertionError(f"bad global-BatchNorm step: loss {loss}")
    sm_step = P.make_shard_map_train_step(mesh, "multiclass")
    loss_sm = float(sm_step(state, put(x), put(y),
                            torch.Generator(device=dev).manual_seed(2))
                    ["loss"])
    if not (state.step == 2 and np.isfinite(loss_sm) and loss_sm < 1e4):
        raise AssertionError(f"bad per-replica step: loss {loss_sm}")

    # the loss trend over 20 steps on learnable per-class tones
    rng = np.random.RandomState(7)
    t = np.arange(CLIP, dtype=np.float32) / 16000.0
    lbl = np.arange(batch) % 8

    def tones():
        ph = rng.rand(batch, 1).astype("float32")
        f0 = (300.0 + 120.0 * lbl)[:, None].astype("float32")
        wav = 0.3 * np.sin(2 * np.pi * (f0 * t[None] + ph))
        wav += 0.02 * rng.randn(batch, CLIP).astype("float32")
        return put(P.shard_batch(mesh, wav.astype("float32")))

    y_t = put(P.shard_batch(mesh, lbl))
    losses = [float(step(state, tones(), y_t, gen)["loss"])
              for _ in range(20)]
    first5, last5 = np.mean(losses[:5]), np.mean(losses[-5:])
    if not last5 < first5:
        raise AssertionError(f"the loss did not fall over 20 steps: "
                             f"{losses}")

    # checkpoint: save, restore on every rank, and one step of each
    path = save_checkpoint(ckdir, state, 0, losses[-1], 0.0, 0.0)
    restored, _ = load_checkpoint(path, _state(cfg, n, 1))
    if P.shard_params(mesh, restored.model) != 0.0:
        raise AssertionError("the ranks restored different weights")
    for (name, a), b in zip(state.model.state_dict().items(),
                            restored.model.state_dict().values()):
        if not torch.equal(a, b):
            raise AssertionError(f"restored {name} differs from the saved")
    xn = tones()
    m_cont = step(state, xn, y_t, torch.Generator(dev).manual_seed(999))
    m_rest = step(restored, xn, y_t, torch.Generator(dev).manual_seed(999))
    if not torch.equal(m_cont["loss"], m_rest["loss"]):
        raise AssertionError(f"the restored run's step differs: "
                             f"{float(m_cont['loss'])} vs "
                             f"{float(m_rest['loss'])}")

    # the flagship b0 (dropout and drop-connect 0): both steps from one
    # pre-step state on the same rows on every rank, where per-replica
    # statistics equal the global ones
    fcfg = _smoke_cfg("efficientnet", "b0", 35, n, dropout_rate=0.0,
                      drop_connect_rate=0.0)
    x1 = put(np.random.RandomState(1).randn(PER_RANK, CLIP)
             .astype("float32") * 0.1)
    y1 = put(np.arange(PER_RANK))
    f_g, f_s = _state(fcfg, n, 3), _state(fcfg, n, 3)
    loss_g = float(step(f_g, x1, y1)["loss"])
    loss_s = float(P.make_shard_map_train_step(mesh, "multiclass")(
        f_s, x1, y1)["loss"])
    rel = abs(loss_g - loss_s) / (abs(loss_g) + 1e-12)
    if not rel < AGREE_RTOL:
        raise AssertionError(f"flagship global vs per-replica loss from "
                             f"one state: {loss_g} vs {loss_s} (rel {rel})")

    # K = 2 steps per call (dropout and drop-connect on)
    scfg = _smoke_cfg("efficientnet", "b0", 35, n)
    s_state = _state(scfg, n, 5)
    multi = make_train_multistep(2, "multiclass", process_group=group)
    rng2 = np.random.RandomState(2)
    xs = put(P.shard_batch(mesh, rng2.randn(2, batch, CLIP)
                           .astype("float32") * 0.1, stacked=True))
    ys = put(P.shard_batch(mesh, np.tile(np.arange(batch) % 35, (2, 1)),
                           stacked=True))
    loss_multi = float(multi(s_state, xs, ys, gen)["loss"])
    if not (s_state.step == 2 and np.isfinite(loss_multi)):
        raise AssertionError(f"bad K=2 multistep: {loss_multi}")
    return (f"dryrun_multichip({n}): ok, smoke global-BN loss {loss:.4f}, "
            f"per-replica loss {loss_sm:.4f}, 20-step trend {first5:.4f} -> "
            f"{last5:.4f}, checkpoint save/restore/step bit-identical, "
            f"flagship b0 global {loss_g:.4f} == per-replica {loss_s:.4f} "
            f"(rel {rel:.1e}), multistep(k=2) loss {loss_multi:.4f}, "
            f"mesh {tuple(mesh.mesh.shape)}")


def _rank_main(rank: int, n: int, store: str, ckdir: str, device: str,
               out: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(max(1, (os.cpu_count() or 2) // (2 * n)))
    kw = {}
    if device == "cuda":
        torch.cuda.set_device(rank)
        kw["device_id"] = torch.device("cuda", rank)
        # the restored run's step must equal the continued one bit for bit
        torch.backends.cudnn.deterministic = True
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            store=dist.FileStore(store, n), rank=rank,
                            world_size=n, **kw)
    try:
        line = _program(rank, n, ckdir)
        if rank == 0:
            with open(out, "w") as f:
                f.write(line)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device: str = "cuda") -> str:
    """The dry run on ``n_devices`` ranks (processes): NCCL with one card
    per rank, or gloo ranks with ``device="cpu"``. Prints and returns rank
    0's report line; raises if any rank failed, or if there are fewer
    cards than ranks."""
    import torch.multiprocessing as mp
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', not {device!r}")
    if device == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise RuntimeError(
                f"dryrun_multichip({n_devices}) runs one rank per CUDA "
                f"device and finds {have}; pass device='cpu' (--device "
                f"cpu) for {n_devices} gloo ranks on the CPU")
    with tempfile.TemporaryDirectory(prefix="leaf_dryrun_") as tmp:
        out = os.path.join(tmp, "report.txt")
        mp.start_processes(_rank_main,
                           args=(n_devices, os.path.join(tmp, "store"),
                                 os.path.join(tmp, "ckpt"), device, out),
                           nprocs=n_devices, start_method="spawn")
        with open(out) as f:
            line = f.read()
    print(line, flush=True)
    return line


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="the data-parallel dry run")
    ap.add_argument("n_devices", type=int, nargs="?", default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args()
    dryrun_multichip(a.n_devices, a.device)
