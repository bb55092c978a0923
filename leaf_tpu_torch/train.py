"""Train a LEAF + CNN classifier on a CUDA card (or the CPU) — the port of
the JAX package's ``train.py``, with its flags, epoch loop and files.

One process drives one device. Each step is the port's train step
(``leaf_tpu_torch.training.make_train_step``: wire decode, on-device
augment, forward, loss, backward through the fused frontend kernels,
Adam, per-batch schedule). Epoch metrics accumulate on the device and
are read once per epoch. Kept as in the JAX ``train.py``:

- ``--continue_from_ckpt latest`` resumes from the newest checkpoint;
- a checkpoint on the last epoch, on a better val metric, and every
  ``--save_every`` epochs (``epoch_NNN/``, ``hparams.json``);
- ``--bn_recalibrate N`` re-estimates the BatchNorm running stats from N
  train batches before each validation;
- ``--wire_dtype auto`` ships int16 PCM when the host pipeline is
  crop/pad only; ``--host_aug`` / ``--high_aug`` move augments to the host;
- ``--use_packed_dataset`` reads msgpack shards (``PackedDataset``; the
  cfg's ``batch_size`` then counts shards, and the waveforms ship as
  float32), from ``--gcs_bucket_name``'s bucket where one is named;
- ``frontend.pretrained`` in the cfg loads a pretrained LEAF frontend
  (``apply_pretrained_frontend``) into the model before training;
- the val set split over the ranks (each clip scored once) and its
  metrics reduced over them;
- SIGTERM: finish the step, save ``epoch_NNN_preempt`` with the schedule
  clock rewound to the epoch start and meta epoch e−1, exit 0;
- ``--steps_per_call K`` feeds K-stacked batches to
  ``make_train_multistep`` (one CUDA graph of K steps on the card), the
  epoch's remainder of < K batches to the single step. Only K
  consecutive batches of one shape are stacked, and a group whose shape
  the captured graph was not made for runs as K single steps: packed
  shards give a smaller batch where a shard is short;
- ``--wandb_watch_model`` logs the step's gradient and parameter norms and
  ``--watch_histograms`` also their histograms, at log steps (both force
  K = 1: they are per-step);
- data parallelism: one process per device, started by ``torchrun``
  (``--n_devices N`` must equal its world size; ``--multihost`` joins the
  process group too, also from the JAX CLI's LEAF_COORDINATOR /
  LEAF_NUM_PROCESSES / LEAF_PROCESS_ID). NCCL on the card, gloo with
  ``--device cpu``. Each rank reads its shard of the train manifest
  (``--batch_mode``: the cfg batch per device or in all); the step takes
  BatchNorm statistics over the global batch and reduces the gradients
  and metrics over the ranks (``make_train_step(process_group=...)``);
  rank 0 writes the checkpoints and logs; SIGTERM stops every rank at the
  same step (agreed at log steps); validation splits the val set over
  the ranks and reduces its sums (multilabel: gathers the outputs), so
  every rank feeds the same metric to the plateau controller.

The epoch line ends with the fused frontend kernels' launch counts since
the process started (``kernels {"fwd": .., "fwd_save": .., "bwd": ..,
"fwd_bf16": .., "fwd_save_bf16": .., "bwd_bf16": ..}``: the primal
forward, the residual-saving forward and the backward, in f32 and in
bf16), so a run shows that its steps went through the kernels. Under
``--steps_per_call K`` the launches of the graph's replays are added to
them (a replay does not pass through the counting wrappers).
``--bf16`` sets ``compute_dtype: bfloat16`` in the cfg's ``frontend`` and
``model`` sections (saved so in ``hparams.json``), as the JAX
``train.py`` does: bf16 compute with f32 parameters. Its ex/s is the
train loop's alone (read before validation), where the JAX CLI's
includes validation.

Example (flagship SpeechCommands recipe):

    python -m leaf_tpu_torch.train \\
        --cfg_file cfgs/speechcommands/efficientnet-b0-leaf-default.cfg \\
        --expdir ./exp_scv2_b0 --epochs 100 --random_seed 8881

    # 8 cards, 256 clips per card and step:
    python -m torch.distributed.run --nproc_per_node 8 \\
        -m leaf_tpu_torch.train --n_devices 8 --cfg_file ... --expdir ...
"""

from __future__ import annotations

import argparse
import json
import os
import random
import signal
import time

import numpy as np
import torch

from leaf_tpu_torch.data import (PackedDataset, RawWaveformDataset,
                                 pinned_placer, prefetch_to_device,
                                 setup_dataloaders)
from leaf_tpu_torch.data import transforms as T
from leaf_tpu_torch.data.device_augment import (leaf_device_augment,
                                                peak_normalize)
from leaf_tpu_torch.models import Classifier
from leaf_tpu_torch.ops.fused_frontend import launch_counts
from leaf_tpu_torch.parallel import (all_gather_rows, all_reduce_sum_,
                                     any_rank, data_group, host_group,
                                     join_world, loader_batch_size,
                                     make_mesh, shard_params,
                                     shutdown_distributed)
from leaf_tpu_torch.training import (TrainState, get_config, make_eval_step,
                                     make_train_multistep, make_train_step,
                                     optimization_helper, rewind_steps,
                                     set_group_lr, waveform_from_wire)
from leaf_tpu_torch.training.bn_recalibrate import recalibrate_batch_stats
from leaf_tpu_torch.training.checkpoint import (apply_pretrained_frontend,
                                                latest_checkpoint,
                                                load_checkpoint,
                                                save_checkpoint, save_hparams)
from leaf_tpu_torch.training.histograms import histogram_tree
from leaf_tpu_torch.training.loggers import (RateTracker, TrainLogger,
                                             profile_trace)
from leaf_tpu_torch.training.metrics import calculate_mAP

_DROPPED = ("train.py's --platform and --compilation_cache_dir are dropped: "
            "--device picks the device, and nothing is compiled ahead of the "
            "run.")
_RANK_SEED = 7919   # rank r's step generator: seed + 1 + r·_RANK_SEED


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, epilog=_DROPPED,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cfg_file", type=str, required=True)
    p.add_argument("--expdir", type=str, required=True)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on (default cuda; 'cpu' "
                        "runs the kernels' plain versions)")
    p.add_argument("--host_aug", action="store_true",
                   help="run ALL augments on the host "
                        "(leaf_supervised_transforms) instead of the "
                        "default host-crop + on-device augment split")
    p.add_argument("--high_aug", action="store_true",
                   help="use the heavier get_raw_transforms_v2 pipeline "
                        "(background-noise SNR mixing + time masking)")
    p.add_argument("--use_packed_dataset", action="store_true",
                   help="the manifests list msgpack shards (python -m "
                        "leaf_tpu_torch.pack_dataset); batch_size counts "
                        "shards")
    p.add_argument("--cropped_read", action="store_true")
    p.add_argument("--gcs_bucket_name", type=str, default=None,
                   help="read the packed shards from this GCS bucket "
                        "(needs google-cloud-storage)")
    p.add_argument("--continue_from_ckpt", type=str, default=None)
    p.add_argument("--random_seed", type=int, default=8881)
    p.add_argument("--log_steps", type=int, default=50)
    p.add_argument("--save_every", type=int, default=1,
                   help="checkpoint every N epochs (default 1). The last "
                        "epoch always saves; epochs that improve the val "
                        "metric always save.")
    p.add_argument("--n_devices", type=int, default=None,
                   help="devices (= processes) of a data-parallel run; "
                        "must equal torchrun's world size (default: it)")
    p.add_argument("--batch_mode", choices=("per_device", "global"),
                   default="per_device",
                   help="batch semantics of the cfg batch_size; the same "
                        "on one device")
    p.add_argument("--labels_delimiter", type=str, default=",")
    p.add_argument("--no_wandb", action="store_true", default=True)
    p.add_argument("--wandb_project", type=str, default=None)
    p.add_argument("--wandb_group", type=str, default=None)
    p.add_argument("--wandb_tags", type=str, default=None)
    p.add_argument("--wandb_watch_model", "--watch_model",
                   dest="watch_model", action="store_true",
                   help="log global and per-child gradient/parameter L2 "
                        "norms at log steps (forces --steps_per_call 1)")
    p.add_argument("--watch_histograms", action="store_true",
                   help="also log on-device parameter/gradient histograms "
                        "at log steps (implies --wandb_watch_model)")
    p.add_argument("--wire_dtype", choices=("auto", "float32", "int16"),
                   default="auto",
                   help="host→device waveform format. 'int16' ships raw "
                        "PCM (4× less copying, decoded on the device, "
                        "bit-identical for 16-bit sources); 'auto' picks "
                        "int16 whenever the host pipeline is "
                        "scale-equivariant (crop/pad only)")
    p.add_argument("--bf16", action="store_true",
                   help="run the model in bfloat16 compute (fp32 params)")
    p.add_argument("--steps_per_call", type=int, default=1,
                   help="K train steps per call: on the card one CUDA graph "
                        "of K steps (make_train_multistep), replayed; the "
                        "epoch's remainder runs as single steps")
    p.add_argument("--bn_recalibrate", type=int, default=0, metavar="N",
                   help="before each validation pass, re-estimate the "
                        "BatchNorm running statistics from N train batches "
                        "with frozen parameters (cycling the loader if the "
                        "epoch is shorter); 0 = off")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace of 5 steps "
                        "(trace.json) here before training")
    p.add_argument("--multihost", action="store_true",
                   help="join the process group the launcher describes "
                        "(torchrun, or LEAF_COORDINATOR/LEAF_NUM_PROCESSES/"
                        "LEAF_PROCESS_ID)")
    return p.parse_args(argv)


def train(args) -> float:
    rank, world, device = join_world("leaf_tpu_torch.train", args.device,
                                     args.n_devices, args.multihost)
    try:
        return _train(args, rank, world, device)
    finally:
        shutdown_distributed()


def _train(args, rank: int, world: int, device: torch.device) -> float:
    np.random.seed(args.random_seed)
    random.seed(args.random_seed)
    cfg = get_config(args.cfg_file)
    if args.bf16:
        # frontend + backbone compute in bfloat16 (f32 params, PCEN and
        # contraction sums), saved so in hparams.json for evaluate
        cfg["frontend"]["compute_dtype"] = "bfloat16"
        cfg["model"]["compute_dtype"] = "bfloat16"
    mode = cfg["model"]["type"]
    multiclass = mode == "multiclass"
    ac = cfg["audio_config"]
    sr = int(ac["sample_rate"])
    tr_clip = int(float(ac.get("random_clip_size", 2.5)) * sr)
    val_clip = int(float(ac.get("val_clip_size", 2.5)) * sr)
    batch_size = int(cfg["opt"]["batch_size"])
    use_mixup = bool(ac.get("mixup", False))

    group = data_group()
    logger = TrainLogger(
        args.expdir, is_master=rank == 0,
        wandb_config=None if args.no_wandb else {
            "project": args.wandb_project,
            "group": args.wandb_group,
            "tags": args.wandb_tags.split(",") if args.wandb_tags else None,
            "name": os.path.basename(args.expdir),
            "config": cfg,
        })
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    loader_bs = loader_batch_size(batch_size, world, world, args.batch_mode)
    logger.print(f"device: {device} ({name}) | devices: {world} | mode: "
                 f"{mode} | batch/step: {loader_bs * world} "
                 f"({args.batch_mode})")

    # ------------------------------------------------------------- data
    if args.high_aug:
        tr_tfs = T.get_raw_transforms_v2(
            True, tr_clip, sample_rate=sr,
            min_duration=float(ac.get("min_duration", 1)),
            background_noise_path=cfg["data"].get("background_noise_dir"))
        val_tfs = T.get_raw_transforms_v2(False, val_clip, sample_rate=sr,
                                          center_crop_val=True)
    elif args.host_aug:
        tr_tfs = T.leaf_supervised_transforms(True, tr_clip, sr)
        val_tfs = T.leaf_supervised_transforms(False, val_clip, sr)
    else:
        # default: crop on the host, elementwise augments on the device
        tr_tfs = T.leaf_host_crop_transforms(True, tr_clip)
        val_tfs = T.leaf_host_crop_transforms(False, val_clip)
    # int16 wire needs every host-side op to be scale-equivariant; packed
    # shards decode through the float byte-reader and ship float32
    int16_ok = (not args.use_packed_dataset and not args.host_aug
                and not args.high_aug and not ac.get("normalize", False))
    wire = args.wire_dtype
    if wire == "auto":
        wire = "int16" if int16_ok else "float32"
    elif wire == "int16" and not int16_ok:
        raise SystemExit(
            "--wire_dtype int16 is incompatible with --host_aug/"
            "--high_aug/--use_packed_dataset/audio_config.normalize: "
            "those host pipelines are not scale-equivariant (int16 would "
            "silently quantize augmented waveforms to {-1,0,1})")
    if args.use_packed_dataset:
        ds_cls = PackedDataset
        extra = {"gcs_bucket_path": args.gcs_bucket_name}
    else:
        ds_cls = RawWaveformDataset
        extra = {"in_memory": bool(cfg["data"].get("in_memory", False)),
                 "wire_dtype": wire}
    train_set = ds_cls(cfg["data"]["train"], cfg["data"]["labels"], ac,
                       mode=mode, delimiter=args.labels_delimiter,
                       transform=tr_tfs, cropped_read=args.cropped_read,
                       **extra)
    val_set = ds_cls(cfg["data"]["val"], cfg["data"]["labels"], ac,
                     mode=mode, delimiter=args.labels_delimiter,
                     transform=val_tfs, is_val=True, **extra)
    train_loader, val_loader = setup_dataloaders(
        train_set, val_set, loader_bs, device_world_size=world,
        local_rank=rank, target_len=tr_clip,
        val_target_len=val_clip, multiclass=multiclass,
        num_workers=args.num_workers, multi_device_val=True,
        packed=args.use_packed_dataset, seed=args.random_seed)
    steps_per_epoch = len(train_loader)
    logger.print(f"train batches/epoch: {steps_per_epoch} | "
                 f"val batches: {len(val_loader)} | wire: {wire}")

    # ------------------------------------------------------------ model
    if args.watch_histograms:
        args.watch_model = True
    k_fuse = max(1, args.steps_per_call)
    if k_fuse > 1 and args.watch_model:
        logger.print("note: --steps_per_call forced to 1 — "
                     "--wandb_watch_model/--watch_histograms log per-step")
        k_fuse = 1
    model = Classifier(cfg, device=device,
                       generator=torch.Generator().manual_seed(
                           args.random_seed))
    # the config's pretrained LEAF frontend (reference
    # frontend_helper.py:12-14,52-53); its parameters stay f32 under --bf16
    model, pre_path = apply_pretrained_frontend(cfg, model)
    if pre_path is not None:
        logger.print(f"loaded pretrained frontend from {pre_path}")
    mesh = make_mesh(world) if group is not None else None
    if mesh is not None:
        shard_params(mesh, model)   # the replicas start equal
    # a CUDA graph of K steps holds a capturable optimizer (device lr)
    optimizer, scheduler, plateau, _ = optimization_helper(
        cfg, model.parameters(), num_devices=world,
        num_tr_steps_per_epoch=steps_per_epoch, num_epochs=args.epochs,
        capturable=k_fuse > 1 and device.type == "cuda")
    state = TrainState(model, optimizer, scheduler)
    n_params = sum(p.numel() for p in model.parameters())
    logger.print(f"model params: {n_params:,}")

    start_epoch = 0
    if args.continue_from_ckpt == "latest":
        args.continue_from_ckpt = latest_checkpoint(args.expdir)
        if args.continue_from_ckpt is None:
            logger.print("no checkpoint to resume; starting fresh")
    if args.continue_from_ckpt:
        state, meta = load_checkpoint(args.continue_from_ckpt, state)
        if mesh is not None and shard_params(mesh, model) != 0.0:
            raise RuntimeError(f"the ranks restored different weights from "
                               f"{args.continue_from_ckpt}")
        start_epoch = int(meta.get("epoch", -1)) + 1
        if plateau is not None and "scheduler" in meta:
            plateau.load_state_dict(meta["scheduler"])
        logger.print(f"resumed from {args.continue_from_ckpt} "
                     f"at epoch {start_epoch}")

    host_aug = args.high_aug or args.host_aug
    tr_augment = None if host_aug else leaf_device_augment
    mixup_alpha = 1.0 if use_mixup else None
    train_step = make_train_step(mode, mixup_alpha=mixup_alpha,
                                 augment_fn=tr_augment,
                                 watch_norms=args.watch_model,
                                 watch_histograms=args.watch_histograms,
                                 process_group=group)
    train_multistep = (make_train_multistep(k_fuse, mode, mixup_alpha,
                                            tr_augment, process_group=group)
                       if k_fuse > 1 else None)
    eval_step = make_eval_step(mode)
    # each rank draws its own augment, mixup and dropout numbers
    step_gen = torch.Generator(device=device).manual_seed(
        args.random_seed + 1 + _RANK_SEED * rank)
    place = pinned_placer(device)

    save_hparams(args.expdir, cfg)
    if args.profile_dir:
        # trace a handful of steps after one warm-up step
        xb, yb = place(next(iter(train_loader)))
        train_step(state, xb, yb, step_gen)
        with profile_trace(args.profile_dir if rank == 0 else None):
            for _ in range(5):
                train_step(state, xb, yb, step_gen)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        logger.print(f"profiler trace written to {args.profile_dir}")

    # Preemption: on SIGTERM finish the in-flight step, checkpoint
    # mid-epoch as epoch_{e:03d}_preempt with meta epoch e-1, and exit 0,
    # so `--continue_from_ckpt latest` redoes the interrupted epoch.
    preempted = []
    try:
        old_handler = signal.signal(signal.SIGTERM,
                                    lambda signum, frame:
                                    preempted.append(signum))
    except ValueError:  # not the main thread (e.g. driven from a test)
        old_handler = None
    try:
        return _run_epochs(args, start_epoch, state, plateau, train_loader,
                           val_loader, train_step, train_multistep,
                           eval_step, step_gen, place, tr_augment, logger,
                           preempted)
    finally:
        if old_handler is not None:
            signal.signal(signal.SIGTERM, old_handler)
        logger.close()


def _group_feed(batches, k: int, agree=bool):
    """("multi", [k batches]) per k consecutive host batches of one shape,
    ("single", batch) for each batch left over: before a batch of another
    shape (a short packed shard) and at the epoch's end. All singles for
    k = 1. ``agree(flag)`` is the ranks' verdict on a shape change
    (``any_rank``), so every rank groups its batches alike."""
    if k == 1:
        yield from (("single", b) for b in batches)
        return
    buf = []
    for b in batches:
        if buf and agree(tuple(np.shape(x) for x in b) != tuple(
                np.shape(x) for x in buf[0])):
            yield from (("single", x) for x in buf)
            buf = []
        buf.append(b)
        if len(buf) == k:
            yield "multi", buf
            buf = []
    for b in buf:
        yield "single", b


def _kernel_counts(train_multistep) -> dict:
    """The kernels' launches: the wrappers' counts, plus the launches of
    the multistep graph's replays."""
    counts = launch_counts()
    if train_multistep is not None:
        for name, n in train_multistep.graph_launch_counts().items():
            counts[name] += n
    return counts


def validate(state, val_loader, eval_step, place, multiclass: bool,
             use_mixup: bool = False, peak_norm: bool = False,
             process_group=None):
    """(val_loss, val_metric) of the model on the val loader's batches.

    Each rank scores its share of the val set (ShardedSampler, unpadded:
    no pad rows); the sums, and the multilabel outputs, are reduced over
    the ranks once, so every rank reads the same metric. val_loss is the
    JAX CLI's: the mean of the batches' mean losses. ``peak_norm``: the
    split pipeline's val PeakNormalization, on the device."""
    device = next(state.model.parameters()).device
    pg = process_group
    sums = torch.zeros(4, dtype=torch.float64, device=device)
    one = torch.ones((), dtype=torch.float64, device=device)
    outputs, gts = [], []
    for xb, yb in prefetch_to_device(iter(val_loader), place):
        if peak_norm:
            xb = peak_normalize(waveform_from_wire(xb))
        m = eval_step(state, xb, yb)
        sums += torch.stack([m["loss"].double(), m["correct"].double(),
                             m["count"].double(), one])
        if not multiclass:
            outputs.append(m["outputs"].cpu().numpy())
            gts.append(yb.cpu().numpy())
    v_loss, v_correct, v_count, v_batches = all_reduce_sum_(sums,
                                                            pg).tolist()
    val_loss = v_loss / max(1.0, v_batches)
    if multiclass:
        return val_loss, v_correct / max(1.0, v_count)
    if pg is not None:
        outputs, gts = ([all_gather_rows(torch.from_numpy(
            np.concatenate(a)), host_group(pg)).numpy()]
            for a in (outputs, gts))
    return val_loss, calculate_mAP(outputs, gts, mixup=use_mixup)


def _run_epochs(args, start_epoch, state, plateau, train_loader, val_loader,
                train_step, train_multistep, eval_step, step_gen, place,
                tr_augment, logger, preempted) -> float:
    """The epoch loop: train, BN recalibration, validation, checkpoint."""
    cfg = state.model.cfg
    multiclass = cfg["model"]["type"] == "multiclass"
    use_mixup = bool(cfg["audio_config"].get("mixup", False))
    device = next(state.model.parameters()).device
    steps_per_epoch = len(train_loader)
    best_val, metric_name = -1.0, "val_acc" if multiclass else "val_mAP"
    k_fuse = 1 if train_multistep is None else train_multistep.k
    pg = data_group()
    world = 1 if pg is None else torch.distributed.get_world_size(pg)
    rank = 0 if pg is None else torch.distributed.get_rank(pg)

    def place_any(item):
        tag, payload = item
        if tag == "single":
            return tag, place(payload)
        return tag, place((np.stack([np.asarray(b[0]) for b in payload]),
                           np.stack([np.asarray(b[1]) for b in payload])))

    def stack_placed(item):
        tag, payload = item
        if tag == "single":
            return item
        return tag, (torch.stack([b[0] for b in payload]),
                     torch.stack([b[1] for b in payload]))

    def feed():
        if pg is None:
            # the feeder thread groups, stacks on the host and places
            return prefetch_to_device(_group_feed(iter(train_loader), k_fuse),
                                      place_any)
        # grouped in this thread, after the feeder placed each batch: the
        # ranks' host collectives (any_rank) stay in one order
        return map(stack_placed, _group_feed(
            prefetch_to_device(iter(train_loader), place), k_fuse, any_rank))

    for epoch in range(start_epoch, args.epochs):
        train_loader.set_epoch(epoch)
        tracker = RateTracker()
        ep_loss = ep_correct = ep_count = None
        t0 = time.time()
        steps_done = 0
        for tag, (xb, yb) in feed():
            # a replay (and the capture) happens on every rank or on none
            if tag == "multi" and not any_rank(
                    not train_multistep.can_replay(xb, yb)):
                metrics = train_multistep(state, xb, yb, step_gen)
                n_new = xb.shape[0]
                loss_sum = metrics["loss"] * n_new  # the mean of K steps
                clips = xb.shape[0] * xb.shape[1]
            elif tag == "multi":
                # K batches of a shape the captured graph was not made
                # for: K single steps, never a replay
                ms = [train_step(state, x, y, step_gen)
                      for x, y in zip(xb, yb)]
                metrics = {"loss": ms[-1]["loss"],
                           "correct": sum(m["correct"] for m in ms),
                           "count": sum(m["count"] for m in ms)}
                n_new = len(ms)
                loss_sum = sum(m["loss"] for m in ms)
                clips = xb.shape[0] * xb.shape[1]
            else:
                metrics = train_step(state, xb, yb, step_gen)
                n_new, loss_sum, clips = 1, metrics["loss"], xb.shape[0]
            clips *= world
            prev_steps = steps_done
            steps_done += n_new
            bi = steps_done - 1  # the last step this call completed
            # accumulate on the device — no per-step host sync
            if ep_loss is None:
                ep_loss = loss_sum
                ep_correct = metrics["correct"]
                ep_count = metrics["count"]
            else:
                ep_loss = ep_loss + loss_sum
                ep_correct = ep_correct + metrics["correct"]
                ep_count = ep_count + metrics["count"]
            tracker.add(clips)
            # under K steps per call: did this call cross a multiple of
            # log_steps?
            at_log = prev_steps == 0 or bi // args.log_steps > (
                (prev_steps - 1) // args.log_steps)
            if at_log:
                logger.print(
                    f"epoch {epoch} step {bi}/{steps_per_epoch} "
                    f"rate {tracker.rate():.1f} ex/s "
                    f"global {tracker.global_rate():.1f} ex/s")
                at = epoch * steps_per_epoch + bi
                if args.watch_model:
                    logger.log_scalars({f"watch/{k}": float(v)
                                        for k, v in metrics.items()
                                        if "norm" in k}, step=at)
                if args.watch_histograms:
                    hists = histogram_tree(
                        dict(state.model.named_parameters()),
                        prefix="params/")
                    hists.update(histogram_tree(metrics["_grads"],
                                                prefix="grads/"))
                    logger.log_histograms(hists, step=at)
            # SIGTERM may reach the ranks at different steps: they agree
            # at log steps, so all stop at the same step (same rewind)
            stop = bool(preempted) if pg is None else (
                at_log and any_rank(bool(preempted)))
            if stop:
                # Rewind the schedule clock to the epoch boundary: the
                # resumed run redoes this epoch from its start, so the
                # mid-epoch steps must not advance warmupcosine/StepLR.
                path = save_checkpoint(
                    args.expdir, rewind_steps(state, steps_done), epoch,
                    float(metrics["loss"]), -1.0, -1.0,
                    scheduler_state=(plateau.state_dict()
                                     if plateau is not None else None),
                    dir_suffix="_preempt", meta_epoch=epoch - 1)
                logger.print(
                    f"SIGTERM: checkpointed mid-epoch {epoch} step {bi} "
                    f"to {path}; resume with --continue_from_ckpt latest")
                return best_val
        if steps_done == 0:
            raise RuntimeError(
                "train loader produced zero batches — the training manifest "
                "has fewer items than one batch with drop_last; reduce "
                f"opt.batch_size or add data (epoch {epoch}).")
        tr_loss = float(ep_loss) / steps_done   # waits for the last step
        train_rate = tracker.global_rate()
        tr_acc = (float(ep_correct) / max(1, int(ep_count))
                  if multiclass else 0.0)

        # --------------------------------------------- BN re-calibration
        if args.bn_recalibrate > 0:
            # Freeze params, re-walk train batches to refresh the BN
            # running stats before validation (and the checkpoint this
            # epoch may save), with the train step's device preprocessing.
            def recal_pre(gen, x):
                x = waveform_from_wire(x)
                return tr_augment(gen, x) if tr_augment else x

            def recal_batches(n):
                done = 0
                while done < n:
                    for bx, _ in iter(train_loader):
                        yield place((bx,))[0]
                        done += 1
                        if done >= n:
                            return

            recalibrate_batch_stats(
                state, recal_batches(args.bn_recalibrate),
                torch.Generator(device=device).manual_seed(
                    args.random_seed + 10_000 + epoch + _RANK_SEED * rank),
                preprocess=recal_pre, process_group=pg)
            logger.print(f"recalibrated BN stats on {args.bn_recalibrate} "
                         f"train batches")

        # ----------------------------------------------------- validation
        val_loss, val_metric = validate(
            state, val_loader, eval_step, place, multiclass, use_mixup,
            peak_norm=tr_augment is not None, process_group=pg)

        dt = time.time() - t0
        logger.print(
            f"epoch {epoch}: tr_loss {tr_loss:.4f} tr_acc {tr_acc:.4f} "
            f"val_loss {val_loss:.4f} {metric_name} {val_metric:.4f} "
            f"({dt:.1f}s, {train_rate:.1f} ex/s) "
            f"kernels {json.dumps(_kernel_counts(train_multistep))}")
        if rank > 0:
            # the metrics are reduced over the ranks: each rank must print
            # rank 0's numbers (the plateau controller reads them)
            print(f"epoch {epoch} [rank {rank}]: val_loss {val_loss:.4f} "
                  f"{metric_name} {val_metric:.4f}", flush=True)
        logger.log_scalars(
            {"train/loss": tr_loss, "train/acc": tr_acc,
             "val/loss": val_loss, f"val/{metric_name}": val_metric,
             "train/examples_per_sec": train_rate, "epoch": epoch},
            step=(epoch + 1) * steps_per_epoch)

        sched_state = plateau.state_dict() if plateau is not None else None
        if (epoch == args.epochs - 1 or val_metric > best_val
                or (epoch + 1) % max(1, args.save_every) == 0):
            save_checkpoint(args.expdir, state, epoch, tr_loss, tr_acc,
                            val_metric, scheduler_state=sched_state)
        if plateau is not None:
            new_lr = plateau.step(val_metric)
            for group in state.optimizer.param_groups:
                set_group_lr(group, new_lr)
        best_val = max(best_val, val_metric)
    logger.print(f"done. best {metric_name}: {best_val:.4f}")
    return best_val


def main(argv=None) -> int:
    train(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
