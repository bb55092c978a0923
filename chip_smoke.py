#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``leaf_tpu_torch``).

Needs one CUDA card (an H100 for the ``sm_90a`` build) and the repository
around this file. Phases, in order; any failure exits non-zero and prints
no result. TF32 is off throughout (cuDNN and matmul).

1. build        — compile the port's CUDA kernels from
                  ``leaf_tpu_torch/ops/csrc`` (one nvcc per source, together);
                  count the tensor-core instructions (HGMMA/HMMA) in each
                  library's SASS (``cuobjdump -sass``), and the bf16 HGMMAs
                  in the bf16 libraries: none fails; the fresh builds of
                  the bf16 forward and backward report no spill and no
                  wgmma serialization warning (C75xx), their registers
                  (and the backward's shared memory) are logged, and the
                  bf16 forward keeps its 52 bf16 HGMMAs
2. parity       — primal forward kernel vs its plain PyTorch version,
                  B=256, F=40, T ∈ {16000, 12345, 48000}, and at the
                  AudioSet ResNet-18 cfg's B=128, T=80000, F=64 (phases 3
                  and 4 too); two launches bit-equal; the worst ratio of
                  error to tolerance
3. parity-train — the residual-saving forward kernel (out and OUT) and the
                  backward kernel (d_bank, d_windows) vs their plain
                  versions and vs autograd through the plain forward, at
                  the same shapes; two launches of each bit-equal
4. parity-bf16  — the three bf16 kernels vs their plain bf16 versions at
                  the same shapes (out, OUT within one bf16 ulp, d_bank,
                  d_windows); two launches of each bit-equal
4a. smoke-leaf  — ``python -m leaf_tpu_torch.scripts.smoke_leaf`` (its
                  ``main([])``) on the card: ``Leaf()`` at its defaults
                  launches the primal kernel once and prints ``output:
                  (1, 100, 40)``; the kernel against its plain version on
                  the smoke's operands, and the output against the same
                  Leaf with ``use_fused_kernel='off'`` (both at the parity
                  tolerance); both recipe sweeps,
                  ``leaf_tpu_torch/scripts/speechcommands_init_exps.sh``
                  and ``voxceleb_run.sh``, run by bash with a stub
                  ``python`` first on PATH, give their 15 and 10 ``python
                  -m leaf_tpu_torch.train`` command lines
5. serving      — the flagship LEAF + EfficientNet-b0 classifier (seeded
                  random weights) answers requests of 3, 8, 64 and 100 clips
                  through ``ServingModel`` with buckets (8, 64); one primal
                  kernel launch per bucket forward; logits held against the
                  same weights with ``use_fused_kernel='off'`` on the card
                  and on the CPU; then the same in bf16 (one bf16 primal
                  launch per bucket forward, logits held against f32)
6. train        — the flagship trains at B=256 × 16000 for 5 steps of
                  ``make_train_step`` (augment, dropout, drop-connect on):
                  finite losses, the step counter advances, one saving and
                  one backward kernel launch per step, one primal launch per
                  eval forward; the same in bf16 through the bf16 kernels
                  only; then 3 steps (augment, dropout, drop-connect
                  off) held against ``use_fused_kernel='off'`` on the card,
                  2 steps at B=8 held against the CPU, and 100 steps of
                  bf16 against f32 on a tone task (the JAX test's bounds)
7. timings      — each kernel (f32 and bf16), its plain version and the
                  cuDNN composition at B=256, T=16000 (CUDA events), and
                  the kernels and the composition at B=128, T=80000, F=64
                  (``[timing-audioset]``); serving latency per bucket, f32
                  and bf16; the train step fused, 'off' and bf16, with a
                  torch.profiler split. The timers, profile readers,
                  peaks, bounds and work counts are those of
                  ``leaf_tpu_torch.scripts`` (``_measure``), and these
                  phases call its tools (kernel_microbench,
                  serving_latency, step_profile, scan_ab, e2e_gap), which
                  also measure what the smoke leaves out (the AudioSet
                  plain versions, K = 8 and 16)
8. stream       — the streaming frontend (``LeafStreamer``, seeded
                  flagship Leaf): 64 streams of 1 s and 8 of 3 s with a
                  flush remainder in 1600-sample chunks, held against the
                  offline Leaf ('off' at tests/test_streaming.py's TOL; the
                  fused kernel's Leaf, logged ratio; bf16 against bf16);
                  per-chunk latency
9. export       — ``save_exported`` at buckets (8, 64), f32 and bf16,
                  ``ServingModel.load``: requests of 3, 8, 64 and 100 clips
                  against the live ``ServingModel``, one primal launch of
                  the dtype's kernel per bucket forward (the kernels run
                  inside the programs as ``torch.ops.leaf_tpu_torch`` ops);
                  the streaming artifact against the live streamer;
                  latency and a profile per bucket, artifact and live
10. multistep   — ``make_train_multistep`` at B=256, f32 and bf16: a K=4
                  CUDA-graph replay against 4 eager steps from the same
                  state and generator state (augment, dropout and
                  drop-connect on), 4 saving-forward and 4 backward
                  launches of the dtype's kernels per replay in the
                  profiler, host ms per step at K = 1 (eager) and 4
                  (graph) with device-busy time, idle share and pool size
10a. dp         — data parallelism at B=256 per rank, the flagship cfg:
                  world 1 on NCCL in this process (f32 and bf16): the
                  data-parallel (global-BatchNorm) step and the
                  per-replica step bit-equal to the plain step under
                  deterministic algorithms, a K=4 graph of the
                  data-parallel step bit-equal to 4 eager ones (its
                  NCCL kernels counted in a replay), ms per step and
                  device busy against the plain step eager and at K=4
                  in turns, the collectives per step; world 2 as two
                  spawned gloo ranks on cuda:0 (NCCL over two cards too
                  where there are two): each rank's step launches the
                  saving forward and the backward once, the replicas
                  agree, the result equals the plain step on the joined
                  512 clips (loss 2e-4, BN running stats 1e-5), the
                  per-replica step on equal rows equals the plain step
                  on them, and per-replica BatchNorm misses the global
                  running stats
10b. zoo        — the rest of the model zoo on the fused kernels. The
                  speechcommands ResNet-18 cfg (read from cfgs/) served
                  through ``ServingModel`` (8, 64) in f32 and bf16 and from
                  ``save_exported`` artifacts (one primal launch per
                  bucket forward; logits against 'off', the CPU, f32 and
                  the live module; latency per bucket); trained at B=256
                  (5 steps f32 and bf16, launch counts), fused against
                  'off' (losses of 3 steps, the first step's gradients
                  and running stats), as a K=4 graph against 4 eager
                  steps, and timed (ms per step eager and at K=4, device
                  busy, idle and frontend share, the largest kernels);
                  the AudioSet cfg (B=128 x 80000, F=64, multilabel): 3
                  steps and 1 step against 'off'; ResNet-50, ResNet-18
                  with NetVLAD, CIFAR-ResNet-20, DenseNet-121
                  (memory_efficient) and b0 (remat) at B=32: logits
                  against the CPU, a train step, remat on against off
                  (cuDNN deterministic), and b0 with remat as a K=4 graph
11. cli         — the flagship recipe through ``python -m
                  leaf_tpu_torch.train`` / ``.evaluate`` on a synthetic tone
                  task (35 classes; 1024 train, 256 val clips of 1 s, 48
                  test clips of 1–3 s): 2 epochs at B=256 (saving forward =
                  backward launches = steps), SIGTERM mid-epoch and a resume
                  that redoes the epoch, evaluate with BN recalibration
                  (JAX-format results.txt; a rerun skips), ``train --bf16``
                  for an epoch and evaluate reading bf16 from its
                  hparams.json (bf16 kernels only); the train loop's
                  clips/s, each CLI's wall time, and the train DataLoader's
                  clips/s alone (in_memory off and on); ``export_serving``
                  on the trained experiment (its artifact against the live
                  model of the checkpoint); ``train --steps_per_call 4``
                  for 2 epochs (epoch 1 replays the graph; the epoch line
                  counts the replays' launches); the speechcommands
                  ResNet-18 cfg through ``train`` (1 epoch, its launch
                  counts) and ``evaluate``
11b. packed     — [cli]'s task packed by ``python -m
                  leaf_tpu_torch.pack_dataset`` (64 records per shard):
                  every record's bytes are its WAV file's, the packed val
                  items equal the CSV dataset's exactly; the flagship
                  trained 1 epoch in this process through
                  ``leaf_tpu_torch.train --use_packed_dataset`` at 4 shards
                  x 64 = 256 clips per batch, with ``frontend.pretrained``
                  set to [cli]'s epoch_001 checkpoint and then to a
                  ``frontend_params.npz`` (scripts/convert_torch_checkpoint
                  .py's converter): before step 0 the frontend equals the
                  source's exactly and the backbone the seed's fresh init;
                  saving forward = backward launches = steps, a primal
                  launch per val batch, a finite loss; the packed
                  DataLoader's clips/s alone beside [cli]'s CSV loader
11c. dp-cli     — ``torchrun --standalone --nproc_per_node 1`` runs of
                  ``train --n_devices 1 --multihost`` (1 epoch, its
                  launch counts) and ``evaluate --n_devices 1`` on
                  [cli]'s task, and the one-device evaluate of the same
                  checkpoint (the same accuracy)
11d. converge   — two rows of CONVERGENCE.md through ``python -m
                  leaf_tpu_torch.synthetic_convergence`` (2560 train clips
                  of the 35-class tone task, B=256, bf16): the flagship
                  b0 for 40 epochs scored after ``--bn_recalibrate 400``,
                  and ResNet-18 for 40 epochs; each reaches test accuracy
                  0.95, and its train run launched the bf16 saving forward
                  and backward once per step (400) and no f32 kernel; the
                  raw final val accuracy, the train wall time and the
                  launch counts are logged. The two rows run side by side
                  (each its own --root), beside [dp-cli]
12. report       — card name and power limit, the ``kernels`` JSON line (six
                  kernels: f32 and bf16), and the last line
                  ``{"ok": true, "device": {...}}``

    python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from leaf_tpu_torch.scripts import (_measure, e2e_gap, scan_ab,
                                    serving_latency, streaming_latency)
from leaf_tpu_torch.scripts.kernel_microbench import (kernel_timings,
                                                      leaf_operands)
from leaf_tpu_torch.scripts.step_profile import (measure_program, stacked,
                                                 trainer)

FLAGSHIP_CFG = {  # cfgs/speechcommands/efficientnet-b0-leaf-default.cfg
    "frontend": {"name": "leaf", "default_args": True},
    "audio_config": {"sample_rate": 16000},
    "model": {"arch": "efficientnet", "model_depth": "b0",
              "num_classes": 35},
}
BUCKETS = (8, 64)
REQUEST_SIZES = (3, 8, 64, 100)
PARITY_B, PARITY_F = 256, 40
PARITY_T = (16000, 12345, 48000)
# the AudioSet ResNet-18 cfg's shape (cfgs/audioset/resnet-18-leaf-default
# .cfg: 64 filters, 5 s clips, B=128): the f32 forward's blocks of 20
# channels end in a group of 4, the backward's groups of 40 in one of 24
AUDIOSET_B, AUDIOSET_F, AUDIOSET_T = 128, 64, 80000
PARITY_SHAPES = ((PARITY_B, PARITY_F, PARITY_T),
                 (AUDIOSET_B, AUDIOSET_F, (AUDIOSET_T,)))
# kernel vs plain, elementwise: |k − p| ≤ RTOL·|p| + ATOL_REL·max|p|.
# The kernels sum the 401-tap products on the tensor cores in 3×TF32
# (~22 bits per product, the accumulator flushed into f32 every 136
# taps), the plain versions in f32 (~6e-8 relative rounding).
KERNEL_RTOL, KERNEL_ATOL_REL = 1e-4, 1e-6
# logits, fused vs unfused frontend: max|a − b| ≤ LOGIT_TOL·max|b| (the
# kernel's last-bit differences pass through PCEN and 16 MBConv blocks)
LOGIT_TOL = 1e-3
# gradients, backward kernel vs plain: ‖k − p‖ ≤ GRAD_REL_TOL·‖p‖ and
# max|k − p| ≤ GRAD_REL_TOL·max|p|. d_bank sums B·T ≈ 4.1e6 products per
# entry on the tensor cores in 3×TF32 (each product keeps ~22 bits; the
# wgmma accumulator, whose error grows with the positions it adds, is
# flushed into f32 every 2048 positions), ~1.5e-5 of the norm at the
# flagship shape.
GRAD_REL_TOL = 1e-4
# the train recipe (cfg opt section): Adam lr 1e-3, coupled L2 1e-4,
# warm-up cosine over 10 of 40 epochs of SpeechCommands' 84843 clips
TRAIN_CFG = {**FLAGSHIP_CFG, "opt": {"optimizer": "Adam", "lr": 1e-3,
                                     "weight_decay": 1e-4,
                                     "scheduler": "warmupcosine",
                                     "warmup_epochs": 10}}
TRAIN_B, TRAIN_STEPS = 256, 5
STEPS_PER_EPOCH, EPOCHS = 84843 // 256, 40
# train parity: augment, dropout and drop-connect off; warm-up of 2 steps so
# that steps 1 and 2 update (lr 0, 5e-4, 1e-3). Per-step losses agree to
# LOSS_TOL (relative); the parameter update Δ = p_3 − p_0 to UPDATE_TOL
# (‖Δa − Δb‖ / ‖Δb‖): Adam's first updates are lr·sign(g) on gradient
# entries at float-noise level (the BN biases before a BN have a zero
# gradient in exact arithmetic), which dominates this measure (9.4e-3,
# port vs JAX on the CPU); BN running stats to STATS_TOL of each layer's
# feature scale (mean: of max sd, var: of max var). The whole-model norm
# cannot see the frontend (~320 of ~4M entries), so each frontend leaf
# (features.*: the only leaves the fused op's gradients reach) is held on
# its own to FRONTEND_TOL: port vs JAX on the CPU reads ≤ 1.2e-3, a zeroed
# d_bank 1.25 (tests/test_torch_port_train_step.py).
PARITY_CFG = {**FLAGSHIP_CFG,
              "model": {**FLAGSHIP_CFG["model"], "dropout_rate": 0.0,
                        "drop_connect_rate": 0.0},
              "opt": {**TRAIN_CFG["opt"], "warmup_epochs": 1}}
LOSS_TOL, UPDATE_TOL, STATS_TOL, FRONTEND_TOL = 1e-4, 3e-2, 1e-3, 1e-2
TIMED_STEPS = 12
# the 'off' step against the fused one: a ~40 ms difference on a step of
# ~45 ms, which 5 steps after 2 resolve
OFF_TIMED_STEPS = 5


def _bf16(cfg: dict) -> dict:
    """``cfg`` under bf16 compute, as ``train --bf16`` sets it."""
    return {**cfg,
            "frontend": {**cfg["frontend"], "compute_dtype": "bfloat16"},
            "model": {**cfg["model"], "compute_dtype": "bfloat16"}}


# bf16 kernels vs their plain bf16 versions on the same bf16 operands: out
# at KERNEL_RTOL / KERNEL_ATOL_REL (the bf16 products are exact in f32,
# only the order of the f32 sums differs); OUT within one bf16 ulp of the
# plain OUT plus KERNEL_ATOL_REL·max|OUT| (both round f32 sums that may
# straddle a rounding point); d_bank, rounded to bf16 once at the end,
# within one ulp plus GRAD_REL_TOL·max|d_bank| elementwise and
# GRAD_BF16_TOL of its norm (the rounding flips: 7.4e-5–1.0e-4 on the
# flagship bank, PERF.md §6); d_windows (f32) at GRAD_REL_TOL.
GRAD_BF16_TOL = 1e-3
# serving logits, bf16 vs f32 on the same seeded weights with unit BN
# statistics: max|a − b| ≤ BF16_LOGIT_TOL·max|b| (1.5e-2–2.2e-2 measured,
# PERF.md §6). With statistics taken from data the random network
# amplifies any rounding to the size of the logits, so that state is not
# used for this check.
BF16_LOGIT_TOL = 0.05
# the bf16-vs-f32 trajectory: 100 Adam + warm-up cosine steps on 4
# batches of TRAJ_B tone clips, cycled, held to the bounds of
# tests/test_efficientnet_parity.py::test_hundred_steps_bf16_bounded_divergence
TRAJ_B, TRAJ_STEPS, TRAJ_WARMUP = 64, 100, 6
# bf16 HGMMAs in the bf16 forward library's SASS (26 unrolled k-steps per
# tile, primal and saving): an edit of the helpers it shares with the
# backward (hopper_bf16.cuh) must leave them as they are
FWD_BF16_HGMMAS = 52


def log(msg: str) -> None:
    print(msg, flush=True)


def _sass_counts(path) -> dict:
    """Tensor-core instructions in a library's SASS (cuobjdump -sass), and
    the HGMMAs that take bf16 operands."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    counts = {op: sass.count(op + ".") for op in ("HGMMA", "HMMA")}
    counts["HGMMA.BF16"] = len(re.findall(r"HGMMA\.\S*BF16", sass))
    return counts


def _check_bf16_build(build_log: str, source: str, tag: str) -> None:
    """A bf16 library's ptxas report: its registers logged; a spill or a
    wgmma serialization warning (C75xx "Potential Performance Loss ...
    serialized") fails."""
    section = re.search(rf"^\[{re.escape(source)}\]\n(.*?)(?=^\[|\Z)",
                        build_log, re.S | re.M)
    if section is None:
        log(f"[build] {source}: an earlier build was reused, its ptxas "
            "report is not in this run")
        return
    text = section.group(1)
    for line in text.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {tag} ptxas: {line.strip()}")
    arrives = len(re.findall(r"\(C7519\)", text))
    if arrives:
        log(f"[build] {tag} ptxas: {arrives} warpgroup.arrive injected "
            "(C7519, not a serialization)")
    spills = [int(n) for n in re.findall(r"(\d+) bytes spill (?:stores|loads)",
                                         text)]
    serialized = sorted(set(re.findall(r"\((C75\d\d)\)[^\n]*serialized", text))
                        | set(re.findall(r"C7513", text)))
    if not spills or any(spills) or serialized:
        raise AssertionError(
            f"{source}: spills {spills}, wgmma serialization warnings "
            f"{serialized} (want no spill and none)")


def phase_build():
    from leaf_tpu_torch.ops._build import load_library
    lib = load_library()
    log(f"[build] {', '.join(p.name for p in lib.paths.values())}: "
        f"{lib.build_seconds:.2f} s")
    for line in lib.build_log.splitlines():
        if ("registers" in line or "spill" in line or "smem" in line
                or "C75" in line or line.startswith("[")):
            log(f"[build] {line.strip()}")
    # the bf16 libraries' shared memory is dynamic (ptxas does not print it)
    _check_bf16_build(lib.build_log, "fused_frontend_bf16.cu", "fwd_bf16")
    _check_bf16_build(lib.build_log, "fused_frontend_bwd_bf16.cu", "bwd_bf16")
    log(f"[build] bwd_bf16 dynamic shared memory: "
        f"{lib.fused_bwd_bf16_smem_bytes()} bytes per block")
    for name, path in lib.paths.items():
        if name == "marks":      # empty phase-marker kernels: no tensor core
            continue
        counts = _sass_counts(path)
        log(f"[build] {name} SASS tensor-core instructions: {counts}")
        if not counts["HGMMA"] + counts["HMMA"]:
            raise AssertionError(f"the {name} library holds no HGMMA/HMMA")
        if name.endswith("_bf16") and not counts["HGMMA.BF16"]:
            raise AssertionError(f"the {name} library holds no bf16 HGMMA")
        if name == "fwd_bf16" and counts["HGMMA.BF16"] != FWD_BF16_HGMMAS:
            raise AssertionError(
                f"the bf16 forward library holds {counts['HGMMA.BF16']} bf16 "
                f"HGMMAs, not {FWD_BF16_HGMMAS}: its SASS changed")


def phase_parity(device):
    from leaf_tpu_torch.ops.fused_frontend import (fused_forward_cuda,
                                                   fused_reference)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("[parity] TF32 off (cudnn.allow_tf32 = matmul.allow_tf32 = False)")
    rng = np.random.RandomState(0)
    worst = 0.0
    for b, f, ts in PARITY_SHAPES:
        bank, windows = leaf_operands(device, f)
        x_all = torch.from_numpy(
            (rng.randn(b, max(ts)) * 0.1).astype(np.float32)).to(device)
        for t in ts:
            x = x_all[:, :t].contiguous()
            got = fused_forward_cuda(x, bank, windows)
            again = fused_forward_cuda(x, bank, windows)
            ref = fused_reference(x, bank, windows)
            torch.cuda.synchronize()
            _check_bit_equal("[parity]", f"fwd T={t} F={f}", (got,),
                             (again,))
            worst = max(worst, _check_elementwise(
                "[parity]", f"fwd T={t} B={b} F={f}", got, ref))
            del got, again, ref
        del x_all
    return worst


def _check_bit_equal(phase: str, tag: str, first, second) -> None:
    """Two launches on the same operands give the same bits, or raise."""
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    log(f"{phase} {tag}: two launches bit-equal: {same}")
    if not same:
        raise AssertionError(f"{tag}: two launches differ")


def _check_elementwise(phase: str, tag: str, got, ref) -> float:
    """|got − ref| ≤ KERNEL_RTOL·|ref| + KERNEL_ATOL_REL·max|ref|, or raise;
    logs the worst ratio of |got − ref| to that bound."""
    err = (got - ref).abs()
    scale = float(ref.abs().max())
    ratio = float((err / (KERNEL_RTOL * ref.abs()
                          + KERNEL_ATOL_REL * scale)).max())
    ok = (got.shape == ref.shape and bool(torch.isfinite(got).all())
          and ratio <= 1.0)
    log(f"{phase} {tag} shape={tuple(got.shape)} max_abs_err="
        f"{float(err.max()):.3e} max|ref|={scale:.3e} tol: |d| <= "
        f"{KERNEL_RTOL:g}*|ref| + {KERNEL_ATOL_REL:g}*max|ref|, worst "
        f"|d|/tol {ratio:.3f} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: kernel disagrees with plain")
    return float(err.max())


def _check_grad(tag: str, got, ref) -> float:
    """‖got − ref‖ ≤ GRAD_REL_TOL·‖ref‖ and max|got − ref| ≤
    GRAD_REL_TOL·max|ref|, or raise."""
    diff = got - ref
    rel = float(diff.norm() / ref.norm())
    max_rel = float(diff.abs().max() / ref.abs().max())
    ok = (got.shape == ref.shape and bool(torch.isfinite(got).all())
          and rel <= GRAD_REL_TOL and max_rel <= GRAD_REL_TOL)
    log(f"[parity-train] {tag} shape={tuple(got.shape)} rel-norm={rel:.3e} "
        f"max_abs_err={float(diff.abs().max()):.3e} (/max|ref| "
        f"{max_rel:.3e}) tol {GRAD_REL_TOL:g} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: kernel disagrees with plain")
    return float(diff.abs().max())


def phase_parity_train(device):
    """The residual-saving forward and the backward kernel vs plain."""
    from leaf_tpu_torch.ops.fused_frontend import (
        fused_backward_cuda, fused_backward_reference,
        fused_forward_saving_cuda, fused_forward_saving_reference,
        fused_reference)
    rng = np.random.RandomState(4)
    worst_fwd = worst_bwd = 0.0
    for b, f, ts in PARITY_SHAPES:
        bank, windows = leaf_operands(device, f)
        x_all = torch.from_numpy(
            (rng.randn(b, max(ts)) * 0.1).astype(np.float32)).to(device)
        for t in ts:
            x = x_all[:, :t].contiguous()
            sh = f"T={t} F={f}"
            out, conv = fused_forward_saving_cuda(x, bank, windows)
            again = fused_forward_saving_cuda(x, bank, windows)
            ref_out, ref_conv = fused_forward_saving_reference(x, bank,
                                                               windows)
            torch.cuda.synchronize()
            _check_bit_equal("[parity-train]", f"saving fwd {sh}",
                             (out, conv), again)
            del again
            worst_fwd = max(worst_fwd,
                            _check_elementwise("[parity-train]",
                                               f"saving fwd out {sh}", out,
                                               ref_out),
                            _check_elementwise("[parity-train]",
                                               f"saving fwd OUT {sh}", conv,
                                               ref_conv))
            del ref_conv
            d_out = torch.from_numpy(
                rng.randn(*out.shape).astype(np.float32)).to(device)
            d_bank, d_win = fused_backward_cuda(x, conv, windows, d_out)
            again = fused_backward_cuda(x, conv, windows, d_out)
            p_bank, p_win = fused_backward_reference(x, conv, windows, d_out)
            torch.cuda.synchronize()
            _check_bit_equal("[parity-train]", f"bwd {sh}", (d_bank, d_win),
                             again)
            del again, conv
            # autograd through the plain forward, x not requiring a gradient
            b_ = bank.clone().requires_grad_()
            w_ = windows.clone().requires_grad_()
            a_bank, a_win = torch.autograd.grad(
                fused_reference(x, b_, w_), (b_, w_), d_out)
            for tag, got, ref in (("d_bank", d_bank, p_bank),
                                  ("d_windows", d_win, p_win),
                                  ("d_bank vs autograd", d_bank, a_bank),
                                  ("d_windows vs autograd", d_win, a_win)):
                worst_bwd = max(worst_bwd, _check_grad(f"bwd {tag} {sh}",
                                                       got, ref))
            del p_bank, p_win, a_bank, a_win, out, ref_out, d_out
        del x_all
        torch.cuda.empty_cache()
    return worst_fwd, worst_bwd


def _bf16_ulp(ref):
    """One bf16 ulp of each entry of ``ref``: 2^(e − 8) for |ref| in
    [2^(e−1), 2^e)."""
    _, e = torch.frexp(ref.float())
    return torch.ldexp(torch.ones_like(ref, dtype=torch.float32), e - 8)


def _check_ulp(phase: str, tag: str, got, ref, atol_rel: float) -> float:
    """|got − ref| ≤ one bf16 ulp of ref + atol_rel·max|ref|, or raise;
    logs the worst ratio of |got − ref| to that bound and the share of
    entries that differ at all."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    scale = float(ref.abs().max())
    ratio = float((err / (_bf16_ulp(ref) + atol_rel * scale)).max())
    ok = (got.shape == ref.shape and bool(torch.isfinite(got).all())
          and ratio <= 1.0)
    log(f"{phase} {tag} shape={tuple(got.shape)} max_abs_err="
        f"{float(err.max()):.3e} max|ref|={scale:.3e} tol: one bf16 ulp + "
        f"{atol_rel:g}*max|ref|, worst |d|/tol {ratio:.3f}, "
        f"{float((err > 0).float().mean()):.4%} of entries differ -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: kernel disagrees with plain")
    return float(err.max())


def phase_parity_bf16(device):
    """The three bf16 kernels vs their plain bf16 versions: x and the bank
    in bf16, the windows in f32, at each of PARITY_SHAPES; two launches
    of each bit-equal."""
    from leaf_tpu_torch.ops.fused_frontend import (
        fused_backward_bf16_cuda, fused_backward_reference,
        fused_forward_bf16_cuda, fused_forward_saving_bf16_cuda,
        fused_forward_saving_reference, fused_reference)
    rng = np.random.RandomState(9)
    worst = {"fwd": 0.0, "fwd_save": 0.0, "bwd": 0.0}
    for b, f, ts in PARITY_SHAPES:
        bank, windows = leaf_operands(device, f)
        bank = bank.bfloat16()
        x_all = torch.from_numpy(
            (rng.randn(b, max(ts)) * 0.1).astype(np.float32)
        ).to(device).bfloat16()
        for t in ts:
            x = x_all[:, :t].contiguous()
            sh = f"T={t} F={f}"
            got = fused_forward_bf16_cuda(x, bank, windows)
            again = fused_forward_bf16_cuda(x, bank, windows)
            ref = fused_reference(x, bank, windows)
            torch.cuda.synchronize()
            _check_bit_equal("[parity-bf16]", f"fwd {sh}", (got,), (again,))
            worst["fwd"] = max(worst["fwd"], _check_elementwise(
                "[parity-bf16]", f"fwd T={t} B={b} F={f}", got, ref))
            del got, again, ref
            out, conv = fused_forward_saving_bf16_cuda(x, bank, windows)
            again = fused_forward_saving_bf16_cuda(x, bank, windows)
            ref_out, ref_conv = fused_forward_saving_reference(x, bank,
                                                               windows)
            torch.cuda.synchronize()
            _check_bit_equal("[parity-bf16]", f"saving fwd {sh}",
                             (out, conv), again)
            del again
            if conv.dtype != torch.bfloat16:
                raise AssertionError(f"OUT is {conv.dtype}, not bf16")
            worst["fwd_save"] = max(
                worst["fwd_save"],
                _check_elementwise("[parity-bf16]", f"saving fwd out {sh}",
                                   out, ref_out),
                _check_ulp("[parity-bf16]", f"saving fwd OUT {sh}", conv,
                           ref_conv, KERNEL_ATOL_REL))
            del ref_conv
            d_out = torch.from_numpy(
                rng.randn(*out.shape).astype(np.float32)).to(device)
            d_bank, d_win = fused_backward_bf16_cuda(x, conv, windows, d_out)
            again = fused_backward_bf16_cuda(x, conv, windows, d_out)
            p_bank, p_win = fused_backward_reference(x, conv, windows, d_out)
            torch.cuda.synchronize()
            _check_bit_equal("[parity-bf16]", f"bwd {sh}", (d_bank, d_win),
                             again)
            rel = float((d_bank.float() - p_bank.float()).norm()
                        / p_bank.float().norm())
            log(f"[parity-bf16] bwd d_bank {sh} dtype {d_bank.dtype}: "
                f"rel-norm {rel:.3e} (tol {GRAD_BF16_TOL:g})")
            if d_bank.dtype != torch.bfloat16 or rel > GRAD_BF16_TOL:
                raise AssertionError(f"bwd d_bank {sh}: {d_bank.dtype}, "
                                     f"{rel}")
            worst["bwd"] = max(
                worst["bwd"],
                _check_ulp("[parity-bf16]", f"bwd d_bank {sh}", d_bank,
                           p_bank, GRAD_REL_TOL),
                _check_grad(f"bwd d_windows {sh} (bf16 kernel)", d_win,
                            p_win))
            del conv, out, again, p_bank, p_win, ref_out, d_out
        del x_all
        torch.cuda.empty_cache()
    return worst


# the recipe sweeps' grids: (cfg directory, cfgs); seeds 8881-8885 each
SWEEPS = {
    "speechcommands_init_exps.sh": (
        "speechcommands", ("efficientnet-b0-leaf-default_random",
                           "efficientnet-b0-leaf-default_kaiming",
                           "efficientnet-b0-leaf-default_xavier")),
    "voxceleb_run.sh": ("voxceleb", ("efficientnet-b0-leaf-default",
                                     "resnet-18-leaf-default")),
}


def phase_smoke_leaf(device) -> None:
    """The forward smoke's primal launch and its output against 'off';
    the recipe sweeps' command lines (a stub ``python``)."""
    from leaf_tpu_torch.frontend import Leaf
    from leaf_tpu_torch.ops.fused_frontend import (fused_forward_cuda,
                                                   fused_reference)
    from leaf_tpu_torch.scripts import smoke_leaf

    # the plain versions' cuDNN convs in f32 (with TF32 they put the Leaf
    # at 3.1× the parity tolerance)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _zero_counts()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = smoke_leaf.main([])
    counts = _counts()
    lines = printed.getvalue().splitlines()
    log(f"[smoke-leaf] {' | '.join(lines)}; launches {counts}")
    if (rc != 0 or "output: (1, 100, 40)" not in lines
            or counts != {**_no_launches(), "fwd": 1}):
        raise AssertionError(f"smoke_leaf: rc {rc}, {lines}, {counts}")
    # comparison launches at the parity tolerance: the kernel against its
    # plain version on the smoke's own operands, and the smoke's Leaf
    # against the same Leaf 'off'
    leaf, x, got = smoke_leaf.smoke(device)
    off = Leaf(use_fused_kernel="off", device=device)
    off.load_state_dict(leaf.state_dict())
    with torch.no_grad():
        bank = leaf._complex_conv.emit_filters().contiguous()
        windows = leaf._pooling.emit_windows()[0].contiguous()
        _check_elementwise("[smoke-leaf]", "fused_fwd on the smoke's operands",
                           fused_forward_cuda(x, bank, windows),
                           fused_reference(x, bank, windows))
        _check_elementwise("[smoke-leaf]", "Leaf() 'auto' vs 'off'", got,
                           off(x))
    if lines[2] != (f"min/max/mean: {float(got.min())} {float(got.max())} "
                    f"{float(got.mean())}"):
        raise AssertionError(f"smoke_leaf printed {lines[2]!r}, not its "
                             f"output's range")

    repo = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix="leaf_sweep_") as tmp:
        stub = os.path.join(tmp, "python")
        with open(stub, "w") as f:
            f.write('#!/usr/bin/env bash\necho "$PWD $*" >> "$STUB_LOG"\n')
        os.chmod(stub, 0o755)
        for script, (folder, cfgs) in SWEEPS.items():
            log_path = os.path.join(tmp, script + ".log")
            env = {**os.environ, "PATH": tmp + os.pathsep + os.environ["PATH"],
                   "STUB_LOG": log_path, "EXP_ROOT": "/sweep", "EPOCHS": "3"}
            subprocess.run(["bash", os.path.join(
                repo, "leaf_tpu_torch", "scripts", script)], check=True,
                env=env, cwd=tmp, timeout=60)
            with open(log_path) as f:
                got_runs = f.read().splitlines()
            want = [f"{repo} -m leaf_tpu_torch.train --cfg_file "
                    f"cfgs/{folder}/{cfg}.cfg --expdir /sweep/{cfg}_seed"
                    f"{seed} --epochs 3 --random_seed {seed}"
                    for cfg in cfgs for seed in range(8881, 8886)]
            log(f"[smoke-leaf] {script}: {len(got_runs)} runs, e.g. "
                f"`python {got_runs[0].split(' ', 1)[1]}`")
            if got_runs != want or len(want) != 5 * len(cfgs):
                raise AssertionError(f"{script}: {got_runs} != {want}")


def phase_serving(device):
    from leaf_tpu_torch.models import Classifier
    from leaf_tpu_torch.models.common import set_batch_norm_stats_
    from leaf_tpu_torch.serving import ServingModel

    rng = np.random.RandomState(1)
    clf = Classifier(FLAGSHIP_CFG, device=device,
                     generator=torch.Generator().manual_seed(0)).eval()
    calib = torch.from_numpy(
        (rng.randn(64, 16000) * 0.1).astype(np.float32)).to(device)
    # seeded random weights with BN stats taken from one seeded batch, so
    # that the logits compared below are O(1) and not ~1e-8
    set_batch_norm_stats_(clf, calib)
    state = clf.state_dict()
    server = ServingModel(FLAGSHIP_CFG, state_dict=state, device=device,
                          batch_sizes=BUCKETS)
    requests = {n: (rng.randn(n, 16000) * 0.1).astype(np.float32)
                for n in REQUEST_SIZES}

    _zero_counts()
    outs = {n: server(requests[n]) for n in REQUEST_SIZES}
    torch.cuda.synchronize()
    counts = _counts()
    launches = counts["fwd"]
    forwards = sum(-(-n // BUCKETS[-1]) for n in REQUEST_SIZES)
    log(f"[serving] requests {REQUEST_SIZES} -> {forwards} bucket forwards, "
        f"kernel launches {counts}")
    if counts != {**_no_launches(), "fwd": forwards}:
        raise AssertionError(f"expected one kernel launch per forward "
                             f"({forwards}), counted {counts}")

    off_cfg = {**FLAGSHIP_CFG, "frontend": {**FLAGSHIP_CFG["frontend"],
                                            "use_fused_kernel": "off"}}
    off = ServingModel(off_cfg, state_dict=state, device=device,
                       batch_sizes=BUCKETS)
    cpu = ServingModel(off_cfg, state_dict=state, device="cpu",
                       batch_sizes=BUCKETS)
    for n in REQUEST_SIZES:
        got = outs[n]
        if got.shape != (n, 35) or not np.isfinite(got).all():
            raise AssertionError(f"bad logits for {n} clips: {got.shape}")
        ref = off(requests[n])
        rel = float(np.abs(got - ref).max() / np.abs(ref).max())
        line = (f"[serving] n={n} logits {got.shape} max|logit|="
                f"{np.abs(ref).max():.3e} fused-vs-off rel={rel:.3e}")
        if n == REQUEST_SIZES[0]:
            cpu_rel = float(np.abs(got - cpu(requests[n])).max()
                            / np.abs(ref).max())
            line += f" card-vs-cpu rel={cpu_rel:.3e}"
            rel = max(rel, cpu_rel)
        log(line + f" (tol {LOGIT_TOL:g}, TF32 off)")
        if rel > LOGIT_TOL:
            raise AssertionError(f"logits disagree for {n} clips: {rel}")
    return launches, server, state


def phase_serving_bf16(device):
    """The flagship in bf16 through ``ServingModel``: one bf16 primal
    launch per bucket forward and no other; logits held against the same
    weights in f32 (unit BN statistics, see BF16_LOGIT_TOL)."""
    from leaf_tpu_torch.models import Classifier
    from leaf_tpu_torch.serving import ServingModel

    state = Classifier(FLAGSHIP_CFG, device=device,
                       generator=torch.Generator().manual_seed(0)).state_dict()
    server = ServingModel(_bf16(FLAGSHIP_CFG), state_dict=state,
                          device=device, batch_sizes=BUCKETS)
    rng = np.random.RandomState(11)
    requests = {n: (rng.randn(n, 16000) * 0.1).astype(np.float32)
                for n in REQUEST_SIZES}
    _zero_counts()
    outs = {n: server(requests[n]) for n in REQUEST_SIZES}
    torch.cuda.synchronize()
    counts = _counts()
    forwards = sum(-(-n // BUCKETS[-1]) for n in REQUEST_SIZES)
    log(f"[serving-bf16] requests {REQUEST_SIZES} -> {forwards} bucket "
        f"forwards, kernel launches {counts}")
    if counts != {**_no_launches(), "fwd_bf16": forwards}:
        raise AssertionError(f"expected one bf16 primal launch per forward "
                             f"({forwards}) and no other, counted {counts}")
    f32 = ServingModel(FLAGSHIP_CFG, state_dict=state, device=device,
                       batch_sizes=BUCKETS)
    for n in REQUEST_SIZES:
        got, ref = outs[n], f32(requests[n])
        rel = float(np.abs(got - ref).max() / np.abs(ref).max())
        agree = float((got.argmax(1) == ref.argmax(1)).mean())
        log(f"[serving-bf16] n={n} logits {got.shape} {got.dtype} "
            f"max|logit|={np.abs(ref).max():.3e} bf16-vs-f32 rel={rel:.3e} "
            f"(tol {BF16_LOGIT_TOL:g}), argmax agreement {agree:.0%}")
        if (got.shape != (n, 35) or got.dtype != np.float32
                or not np.isfinite(got).all() or rel > BF16_LOGIT_TOL):
            raise AssertionError(f"bf16 logits disagree for {n} clips: {rel}")
    return counts["fwd_bf16"], server


def _counts() -> dict:
    from leaf_tpu_torch.ops.fused_frontend import launch_counts
    return launch_counts()


def _zero_counts() -> None:
    from leaf_tpu_torch.ops.fused_frontend import reset_launch_counts
    reset_launch_counts()


def _no_launches() -> dict:
    return {name: 0 for name in _counts()}


def _batch(rng, b: int, device):
    x = torch.from_numpy((rng.randn(b, 16000) * 0.1).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 35, b).astype(np.int64))
    return x.to(device), y.to(device)


def phase_train(device, state, bf16: bool = False):
    """The main training path: 5 steps, then one eval forward; under
    ``bf16`` the recipe of ``train --bf16``, through the bf16 kernels."""
    from leaf_tpu_torch.training import make_eval_step
    sfx, tag = ("_bf16", "[train-bf16]") if bf16 else ("", "[train]")
    cfg = _bf16(TRAIN_CFG) if bf16 else TRAIN_CFG
    st, step = trainer(cfg, state, device, True, STEPS_PER_EPOCH, EPOCHS)
    x, y = _batch(np.random.RandomState(5), TRAIN_B, device)
    gen = torch.Generator(device=device).manual_seed(5)
    _zero_counts()
    metrics = [step(st, x, y, gen) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    counts = _counts()
    losses = [float(m["loss"]) for m in metrics]
    log(f"{tag} B={TRAIN_B} x 16000, {TRAIN_STEPS} steps (augment, "
        f"dropout 0.2, drop-connect 0.2 on): losses "
        f"{', '.join(f'{v:.6f}' for v in losses)} ({metrics[0]['loss'].dtype}); "
        f"step counter {st.step}; kernel launches {counts}")
    if not (all(np.isfinite(losses)) and st.step == TRAIN_STEPS):
        raise AssertionError(f"train steps failed: {losses}, step {st.step}")
    if counts != {**_no_launches(), "fwd_save" + sfx: TRAIN_STEPS,
                  "bwd" + sfx: TRAIN_STEPS}:
        raise AssertionError(f"expected one saving-forward and one backward "
                             f"launch per step and no other, counted {counts}")
    _zero_counts()
    out = make_eval_step()(st, x, y)
    torch.cuda.synchronize()
    eval_counts = _counts()
    log(f"{tag} eval forward: loss {float(out['loss']):.6f}, correct "
        f"{int(out['correct'])}/{int(out['count'])}, kernel launches "
        f"{eval_counts}")
    if (eval_counts != {**_no_launches(), "fwd" + sfx: 1}
            or not bool(torch.isfinite(out["outputs"]).all())
            or tuple(out["outputs"].shape) != (TRAIN_B, 35)):
        raise AssertionError(f"eval forward failed: {eval_counts}")
    return counts


def _stats_error(a, b) -> tuple:
    """The worst BN running-stat error of module ``a`` against ``b``: the
    mean's against the layer's largest sd, the variance's against its
    largest variance."""
    mean_err = var_err = 0.0
    mods_b = dict(b.named_modules())
    for name, ma in a.named_modules():
        if isinstance(ma, torch.nn.BatchNorm2d):
            mb = mods_b[name]
            va, vb = ma.running_var.cpu(), mb.running_var.cpu()
            mean_err = max(mean_err, float(
                (ma.running_mean.cpu() - mb.running_mean.cpu()).abs().max()
                / vb.sqrt().max()))
            var_err = max(var_err, float((va - vb).abs().max() / vb.max()))
    return mean_err, var_err


def _compare_runs(tag: str, a, b, p0: dict, losses_a, losses_b,
                  loss_tol: float = LOSS_TOL,
                  stats_tol: float = STATS_TOL,
                  front_tol: float = FRONTEND_TOL) -> None:
    """Losses, parameter update and BN running stats of two train runs
    from the same weights ``p0`` (CPU tensors), within the stated
    tolerances (run b is the reference)."""
    loss_rel = max(abs(la - lb) / abs(lb) for la, lb in zip(losses_a,
                                                          losses_b))
    num = den = 0.0
    front = {}
    params_b = dict(b.named_parameters())
    for name, pa in a.named_parameters():
        da = pa.detach().cpu() - p0[name]
        db = params_b[name].detach().cpu() - p0[name]
        num += float(((da - db) ** 2).sum())
        den += float((db ** 2).sum())
        if name.startswith("features."):
            front[name] = float((da - db).norm() / db.norm())
    upd = (num / den) ** 0.5
    worst = max(front, key=front.get)
    mean_err, var_err = _stats_error(a, b)
    ok = (loss_rel <= loss_tol and upd <= UPDATE_TOL
          and len(front) == 7 and front[worst] <= front_tol
          and max(mean_err, var_err) <= stats_tol)
    log(f"[train] {tag}: losses {', '.join(f'{v:.6f}' for v in losses_a)} "
        f"vs {', '.join(f'{v:.6f}' for v in losses_b)} (max rel "
        f"{loss_rel:.3e}, tol {loss_tol:g}); update rel-norm {upd:.3e} (tol "
        f"{UPDATE_TOL:g}); worst of {len(front)} frontend leaves {worst} "
        f"{front[worst]:.3e} (tol {front_tol:g}); BN stats mean/sd "
        f"{mean_err:.3e}, var/var {var_err:.3e} (tol {stats_tol:g}) -> "
        f"{'ok' if ok else 'FAIL'}")
    log(f"[train] {tag}: frontend leaves "
        + ", ".join(f"{k[len('features.'):]} {v:.3e}"
                    for k, v in front.items()))
    if not ok:
        raise AssertionError(f"{tag}: train runs disagree")


def phase_train_parity(device, state):
    """3 steps fused vs 'off' on the card (B=256); 2 steps card vs CPU
    (B=8). Augment, dropout and drop-connect off."""
    off_cfg = {**PARITY_CFG, "frontend": {**PARITY_CFG["frontend"],
                                          "use_fused_kernel": "off"}}
    p0 = {k: v.detach().cpu().clone() for k, v in state.items()}
    rng = np.random.RandomState(6)
    for tag, b, n_steps, ref_cfg, ref_device in (
            ("fused vs 'off' on the card, B=256", TRAIN_B, 3, off_cfg,
             device),
            ("card vs CPU, B=8", 8, 2, PARITY_CFG, torch.device("cpu"))):
        x, y = _batch(rng, b, device)
        runs = []
        for cfg, dev in ((PARITY_CFG, device), (ref_cfg, ref_device)):
            st, step = trainer(cfg, state, dev, False, 2, 10)
            losses = [float(step(st, x.to(dev), y.to(dev))["loss"])
                      for _ in range(n_steps)]
            runs.append((st.model, losses))
        _compare_runs(tag, runs[0][0], runs[1][0], p0, runs[0][1], runs[1][1])


def phase_trajectory(device, state):
    """bf16 against f32 over TRAJ_STEPS Adam + warm-up cosine steps on the
    tone task, from the same weights on the same 4 batches (augment,
    dropout and drop-connect off), held to the JAX test's bounds."""
    rng = np.random.RandomState(12)
    t = np.arange(16000) / 16000
    labels = np.arange(4 * TRAJ_B) % CLI_CLASSES
    waves = np.stack([_tone(rng, c, t) for c in labels])
    waves += 0.05 * rng.randn(*waves.shape)
    x = torch.from_numpy(waves.astype(np.float32)).to(device)
    y = torch.from_numpy(labels.astype(np.int64)).to(device)
    curves = {}
    for tag, cfg in (("f32", PARITY_CFG), ("bf16", _bf16(PARITY_CFG))):
        st, step = trainer(cfg, state, device, False, TRAJ_WARMUP,
                           TRAJ_STEPS // TRAJ_WARMUP)
        t0 = time.perf_counter()
        losses = [step(st, x[lo:lo + TRAJ_B], y[lo:lo + TRAJ_B])["loss"]
                  for lo in ((i % 4) * TRAJ_B for i in range(TRAJ_STEPS))]
        curves[tag] = np.array([float(v) for v in losses])
        log(f"[trajectory] {tag}: {TRAJ_STEPS} steps at B={TRAJ_B} in "
            f"{time.perf_counter() - t0:.1f} s, losses "
            + ", ".join(f"{v:.4f}" for v in curves[tag][::10])
            + f" ... {curves[tag][-1]:.4f}")
    f, b = curves["f32"], curves["bf16"]
    first = abs(b[0] - f[0])
    med = float(np.median(np.abs(b - f) / np.maximum(np.abs(f), 0.1)))
    tail = abs(b[-10:].mean() - f[-10:].mean()) / max(f[-10:].mean(), 0.1)
    ok = first < 0.05 and med < 0.25 and tail < 0.25 and b[-1] < 0.5 * b[0]
    log(f"[trajectory] bf16 vs f32: first-loss gap {first:.4f} (< 0.05), "
        f"median relative gap {med:.4f} (< 0.25), tail gap {tail:.4f} "
        f"(< 0.25), last/first bf16 {b[-1] / b[0]:.3f} (< 0.5) -> "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("bf16 trajectory diverged from f32")


def phase_timing_audioset(device):
    """The six kernels and the cuDNN composition at the AudioSet ResNet-18
    cfg's shape (B=128, T=80000, F=64); their plain versions there are
    ``python -m leaf_tpu_torch.scripts.kernel_microbench --shape audioset
    --plain``'s."""
    kernel_timings(device, AUDIOSET_B, AUDIOSET_T, AUDIOSET_F, iters=5,
                   log=log, tag="[timing-audioset] ")


def phase_timings(device, servers):
    """The six kernels (kernel_microbench, with their plain versions) at
    B=256, T=16000, and serving latency per bucket, f32 and bf16
    (serving_latency, 20 requests and a profile of 5)."""
    results = kernel_timings(device, 256, 16000, PARITY_F, iters=20,
                             plain=True, log=log, tag="[timing] ")
    rng = np.random.RandomState(2)
    for dtype, server in servers.items():
        for bucket in BUCKETS:
            req = (rng.randn(bucket, 16000) * 0.1).astype(np.float32)
            rec = serving_latency.measure_request(server, req, device,
                                                  wall_reps=20,
                                                  trace_execs=5)
            log(serving_latency.describe(f"[timing] serving {dtype}", rec))
    return results


def phase_train_timing(device, state):
    """Train step time (step_profile.measure_program: the host clock of
    calls ending in a synchronize, and a profile of one step): fused
    (12 steps) and bf16 (12), and 'off' (5) against fused."""
    off_cfg = {**TRAIN_CFG, "frontend": {**TRAIN_CFG["frontend"],
                                         "use_fused_kernel": "off"}}
    x, y = _batch(np.random.RandomState(7), TRAIN_B, device)
    medians = {}
    for tag, cfg, n in (("fused", TRAIN_CFG, TIMED_STEPS),
                        ("off", off_cfg, OFF_TIMED_STEPS),
                        ("bf16", _bf16(TRAIN_CFG), TIMED_STEPS)):
        st, step = trainer(cfg, state, device, True, STEPS_PER_EPOCH, EPOCHS)
        gen = torch.Generator(device=device).manual_seed(8)
        m = measure_program(lambda: step(st, x, y, gen), device, n,
                            warmup=3 if n == TIMED_STEPS else 2,
                            profile=tag != "off")
        medians[tag] = m["wall_ms"]
        log(f"[timing] train step B={TRAIN_B} {tag}: median "
            f"{m['wall_ms']:.3f} ms/step ({TRAIN_B / m['wall_ms'] * 1e3:.1f} "
            f"clips/s), min {m['wall_min_ms']:.3f}, max "
            f"{m['wall_max_ms']:.3f} ({n} steps after warm-up, host clock, "
            f"TF32 off)")
        _log_profile(f"train step ({tag})", m["profile"])
        del st, step
    return medians


def _log_profile(tag: str, prof, top: int = 8) -> None:
    """A step's profile (``measure_program``'s): busy, idle, the frontend
    kernels' share and the largest kernels."""
    if prof is None:
        return
    if prof.busy_ms is None:
        log(f"[profile] {tag}: no device time in the trace: not measured")
        return
    front = prof.ms("fused_fwd", "fused_bwd")
    log(f"[profile] {tag}: device busy {prof.busy_ms:.3f} ms of the "
        f"{prof.host_ms:.3f} ms median (idle {prof.idle:.1%}) in "
        f"{prof.launches:.0f} kernels; frontend kernels {front:.3f} ms "
        f"({front / prof.busy_ms:.1%} of busy), everything else (backbone, "
        f"optimizer, PCEN, augment, loss) {prof.busy_ms - front:.3f} ms; "
        "by category: " + ", ".join(f"{k} {v:.3f}" for k, v in
                                    prof.categories.items() if v))
    for name, count, ms in prof.rows[:top]:
        log(f"[profile]   {ms:.3f} ms  x{count:g}  {name[:90]}")


# ---------------------------------------------------------------- [stream]
# streamed frames vs the offline Leaf: tests/test_streaming.py's TOL
# against the unfused 'off' Leaf (the same math, other summation orders);
# against the fused kernel's Leaf, |a − b| ≤ STREAM_FUSED_RTOL·|b| +
# STREAM_FUSED_ATOL_REL·max|b| (the kernel's 3×TF32 sums, the same
# tolerance shape as its parity check, widened by PCEN's x^(1/2)); bf16
# streamed vs bf16 offline 'off' to tests/test_torch_port_bf16.py's
# LEAF_FEATURE_TOL of max|b|; the exported cells vs the live streamer to
# tests/test_serving.py's rtol 1e-6, atol 1e-7.
STREAM_TOL = {"rtol": 2e-5, "atol": 2e-6}
STREAM_FUSED_RTOL, STREAM_FUSED_ATOL_REL = 1e-3, 1e-5
STREAM_BF16_TOL = 2e-5
STREAM_CHUNK, STREAM_N, STREAM_LONG = 1600, 64, 48480  # 3 s + 3 hops
SERVED_STREAM_TOL = {"rtol": 1e-6, "atol": 1e-7}
# an artifact's logits vs the live module's: tests/test_serving.py's
# atol 1e-5, relative to max|logit|
ARTIFACT_TOL = 1e-5
MULTI_K = 4
# graph vs eager parameters: tests/test_training.py's multistep bounds
MULTI_ATOL, MULTI_RTOL, MULTI_LOSS_RTOL = 2e-4, 1e-4, 1e-5
# the kernels' symbols as the profiler names them, by launch_counts name
KERNEL_SYMBOLS = {"fwd_save": "fused_fwd_tf32x3_kernel<true>",
                  "bwd": "fused_bwd_tf32x3_kernel",
                  "fwd_save_bf16": "fused_fwd_bf16_kernel<true>",
                  "bwd_bf16": "fused_bwd_bf16_kernel"}


def phase_stream(device):
    """The streaming frontend (seeded flagship Leaf, 40 filters): 64
    streams of 1 s and 8 of 3 s + 480 samples (a flush remainder) in
    1600-sample chunks, against the offline Leaf, f32 and bf16."""
    from leaf_tpu_torch.frontend import Leaf, LeafStreamer
    bf16 = torch.bfloat16
    leaf = Leaf(device=device, generator=torch.Generator().manual_seed(3))
    off = Leaf(use_fused_kernel="off", device=device)
    off_b = Leaf(use_fused_kernel="off", compute_dtype=bf16, device=device)
    for m in (off, off_b):
        m.load_state_dict(leaf.state_dict())
    rng = np.random.RandomState(14)
    latencies = []
    for name, b, t in (("1 s", STREAM_N, 16000), ("3 s", 8, STREAM_LONG)):
        wave = (rng.randn(b, t) * 0.1).astype(np.float32)
        x = torch.from_numpy(wave).to(device)
        got = streaming_latency.stream(LeafStreamer(leaf, STREAM_CHUNK),
                                       wave, STREAM_CHUNK,
                      latencies if name == "1 s" else None)
        with torch.no_grad():
            ref, fused = off(x).cpu().numpy(), leaf(x).cpu().numpy()
            ref_b = off_b(x).cpu().numpy()
        got_b = streaming_latency.stream(LeafStreamer(off_b, STREAM_CHUNK),
                                         wave,
                        STREAM_CHUNK)
        err = np.abs(got - ref)
        ratio = float((err / (STREAM_TOL["atol"]
                              + STREAM_TOL["rtol"] * np.abs(ref))).max())
        fused_ratio = float((np.abs(got - fused) / (
            STREAM_FUSED_RTOL * np.abs(fused)
            + STREAM_FUSED_ATOL_REL * np.abs(fused).max())).max())
        b_rel = float(np.abs(got_b - ref_b).max() / np.abs(ref_b).max())
        log(f"[stream] {b} streams of {name} ({t} samples) in "
            f"{STREAM_CHUNK}-sample chunks: frames {got.shape}; vs offline "
            f"'off' max err {err.max():.3e}, worst ratio to TOL "
            f"{ratio:.3f}; vs the fused kernel's offline Leaf worst ratio "
            f"{fused_ratio:.3f} (rtol {STREAM_FUSED_RTOL:g} + "
            f"{STREAM_FUSED_ATOL_REL:g}·max); bf16 streamed vs bf16 "
            f"offline max-rel {b_rel:.3e} (tol {STREAM_BF16_TOL:g})")
        if (got.shape != ref.shape or ratio > 1.0 or fused_ratio > 1.0
                or b_rel > STREAM_BF16_TOL):
            raise AssertionError(f"streamed frames disagree ({name})")
    steady = latencies[1:]
    log(f"[stream] per-chunk latency, {STREAM_N} streams x {STREAM_CHUNK} "
        f"samples (host clock, synchronised): first call "
        f"{latencies[0]:.3f} ms; steady median {np.median(steady):.3f} ms, "
        f"p90 {np.percentile(steady, 90):.3f} ms over {len(steady)} chunks")
    return leaf


def _serve_in_turns(tag: str, servers: dict, rng, device) -> None:
    """Latency of ``servers`` (artifact and live) at each bucket in turns
    (serving_latency.in_turns: 20 requests per turn, a b b a; a profile
    of 5 requests each)."""
    for bucket in BUCKETS:
        req = (rng.randn(bucket, 16000) * 0.1).astype(np.float32)
        recs = serving_latency.in_turns(servers, req, device, wall_reps=20,
                                        trace_execs=5)
        for name, rec in recs.items():
            log(serving_latency.describe(f"{tag} {name}", rec))


def phase_export(device, state, leaf, tmp):
    """``save_exported`` at buckets (8, 64), f32 and bf16, loaded with
    ``ServingModel.load`` and held against the live ``ServingModel``;
    one primal launch of the dtype's kernel per bucket forward; the
    streaming artifact against the live streamer; latencies."""
    from leaf_tpu_torch.frontend import LeafStreamer
    from leaf_tpu_torch.serving import (ServingModel, StreamingServingModel,
                                        save_exported,
                                        save_exported_streaming)
    rng = np.random.RandomState(15)
    requests = {n: (rng.randn(n, 16000) * 0.1).astype(np.float32)
                for n in REQUEST_SIZES}
    forwards = sum(-(-n // BUCKETS[-1]) for n in REQUEST_SIZES)
    launches = {}
    for dtype, cfg, sfx in (("f32", FLAGSHIP_CFG, ""),
                            ("bf16", _bf16(FLAGSHIP_CFG), "_bf16")):
        out = os.path.join(tmp, f"serving_{dtype}")
        t0 = time.perf_counter()
        save_exported(out, cfg, state_dict=state, device=device,
                      batch_sizes=BUCKETS)
        t_export = time.perf_counter() - t0
        t0 = time.perf_counter()
        art = ServingModel.load(out, device=device)
        t_load = time.perf_counter() - t0
        live = ServingModel(cfg, state_dict=state, device=device,
                            batch_sizes=BUCKETS)
        _zero_counts()
        outs = {n: art(requests[n]) for n in REQUEST_SIZES}
        torch.cuda.synchronize()
        counts = _counts()
        launches[dtype] = counts["fwd" + sfx]
        worst = 0.0
        for n in REQUEST_SIZES:
            ref = live(requests[n])
            worst = max(worst, float(np.abs(outs[n] - ref).max()
                                     / np.abs(ref).max()))
            if outs[n].shape != (n, 35) or not np.isfinite(outs[n]).all():
                raise AssertionError(f"bad artifact logits for {n} clips")
        log(f"[export] {dtype}: exported buckets {BUCKETS} in "
            f"{t_export:.1f} s, loaded in {t_load:.1f} s "
            f"({sum(os.path.getsize(os.path.join(out, f)) for f in os.listdir(out)) / 2**20:.1f} MiB); "
            f"requests {REQUEST_SIZES} -> {forwards} bucket forwards, kernel "
            f"launches {counts}; artifact vs live max|a-b|/max|b| "
            f"{worst:.3e} (tol {ARTIFACT_TOL:g})")
        if counts != {**_no_launches(), "fwd" + sfx: forwards}:
            raise AssertionError(f"expected one {dtype} primal launch per "
                                 f"bucket forward ({forwards}), {counts}")
        if worst > ARTIFACT_TOL:
            raise AssertionError(f"{dtype} artifact disagrees with live")
        _serve_in_turns(f"[export] {dtype}", {"artifact": art, "live": live},
                        rng, device)
        del art, live
    out = os.path.join(tmp, "serving_stream")
    save_exported_streaming(out, leaf, STREAM_CHUNK, STREAM_N)
    served = StreamingServingModel.load(out, device=device)
    wave = (rng.randn(STREAM_N, 16000) * 0.1).astype(np.float32)
    lat_art, lat_live = [], []
    a = streaming_latency.stream(served, wave, STREAM_CHUNK, lat_art)
    b = streaming_latency.stream(LeafStreamer(leaf, STREAM_CHUNK), wave,
                                 STREAM_CHUNK, lat_live)
    err = float(np.abs(a - b).max())
    ok = np.allclose(a, b, **SERVED_STREAM_TOL) and a.shape == b.shape
    log(f"[export] streaming artifact ({STREAM_N} streams, chunk "
        f"{STREAM_CHUNK}): frames {a.shape} vs the live streamer max err "
        f"{err:.3e} (rtol 1e-6, atol 1e-7) -> {'ok' if ok else 'FAIL'}; "
        f"steady per-chunk median artifact {np.median(lat_art[1:]):.3f} ms, "
        f"live {np.median(lat_live[1:]):.3f} ms")
    if not ok:
        raise AssertionError("streaming artifact disagrees with live")
    return launches


def _twin(cfg, st, gen, device):
    """A second train state with copies of ``st``'s weights, buffers,
    optimizer and schedule, and a generator at ``gen``'s state."""
    import copy

    from leaf_tpu_torch.training import TrainState
    twin, step = trainer(cfg, st.model.state_dict(), device, True,
                         STEPS_PER_EPOCH, EPOCHS, capturable=True)
    twin.optimizer.load_state_dict(copy.deepcopy(st.optimizer.state_dict()))
    twin.scheduler.load_state_dict(st.scheduler.state_dict())
    twin.step = st.step
    g = torch.Generator(device=device)
    g.set_state(gen.get_state())
    return twin, step, g


def phase_multistep(device, state):
    """K train steps per call as one CUDA graph, B=256, f32 and bf16, with
    augment, dropout and drop-connect on: a replay against K eager steps
    from the same state and generator state, its kernels in the profiler,
    and host ms per step at K = 1 (eager) and 4 (graph; K = 8 and 16:
    ``python -m leaf_tpu_torch.scripts.scan_ab``)."""
    results = {}
    for dtype, cfg, sfx in (("f32", TRAIN_CFG, ""),
                            ("bf16", _bf16(TRAIN_CFG), "_bf16")):
        tag = f"[multistep] {dtype}"
        results[dtype] = {"per_replay": _multistep_check(device, state, cfg,
                                                         sfx, tag)}
        torch.cuda.empty_cache()
        results[dtype]["timing"] = scan_ab.multistep_timing(
            cfg, state, device, ks=(1, MULTI_K), calls=TIMED_STEPS,
            batch=TRAIN_B, log=log, tag=tag)
    return results


def _multistep_check(device, state, cfg, sfx: str, tag: str,
                     k: int = MULTI_K) -> dict:
    """A K-step graph of ``cfg``'s train step from the weights ``state``
    (B=256, augment on) against K eager steps from the same state and
    generator state, within the multistep bounds; one saving-forward and
    one backward launch of the ``sfx`` kernels per step in a replay, in
    the runner's record and in the profiler. Returns the per-replay
    launches."""
    from leaf_tpu_torch.data import leaf_device_augment
    from leaf_tpu_torch.training import make_train_multistep
    rng = np.random.RandomState(16)
    st, _ = trainer(cfg, state, device, True, STEPS_PER_EPOCH, EPOCHS,
                    capturable=True)
    gen = torch.Generator(device=device).manual_seed(16)
    multi = make_train_multistep(k, augment_fn=leaf_device_augment)
    groups = [stacked(rng, k, TRAIN_B, 16000, device) for _ in range(3)]
    t0 = time.perf_counter()
    multi(st, *groups[0], gen)  # K eager steps, then the capture
    torch.cuda.synchronize()
    log(f"{tag}: first call (K={k} eager steps + capture) "
        f"{time.perf_counter() - t0:.2f} s; graph pool "
        f"{multi.pool_bytes / 2**30:.2f} GiB; launches per replay "
        f"{multi.per_replay}")
    want = {"fwd_save" + sfx: k, "bwd" + sfx: k}
    if multi.per_replay != want:
        raise AssertionError(f"{tag}: per replay {multi.per_replay}, "
                             f"want {want}")
    twin, step, tgen = _twin(cfg, st, gen, device)
    _zero_counts()
    got = multi(st, *groups[1], gen)
    torch.cuda.synchronize()
    replay_counts = _counts()
    ref = [step(twin, groups[1][0][i], groups[1][1][i], tgen)
           for i in range(k)]
    ref_loss = float(torch.stack([m["loss"] for m in ref]).float().mean())
    loss_rel = abs(float(got["loss"]) - ref_loss) / abs(ref_loss)
    correct = (int(got["correct"]), int(sum(int(m["correct"])
                                            for m in ref)))
    count = (int(got["count"]), int(sum(int(m["count"]) for m in ref)))
    worst, equal = 0.0, True
    twin_params = dict(twin.model.named_parameters())
    for name, p in st.model.named_parameters():
        q = twin_params[name]
        worst = max(worst, float(((p - q).detach().abs()
                                  / (MULTI_ATOL + MULTI_RTOL * q.abs()))
                                 .max()))
        equal = equal and torch.equal(p, q)
    ok = (st.step == twin.step == 2 * k and loss_rel <= MULTI_LOSS_RTOL
          and correct[0] == correct[1] and count[0] == count[1]
          and worst <= 1.0 and replay_counts == _no_launches())
    log(f"{tag}: replay vs {k} eager steps from the same state "
        f"and generator state: step {st.step} vs {twin.step}; loss "
        f"{float(got['loss']):.6f} vs {ref_loss:.6f} (rel {loss_rel:.2e}, "
        f"tol {MULTI_LOSS_RTOL:g}); correct {correct[0]} vs "
        f"{correct[1]}; count {count[0]} vs {count[1]}; parameters "
        f"worst ratio {worst:.3e} to atol {MULTI_ATOL:g} + rtol "
        f"{MULTI_RTOL:g} (bit-equal: {equal}); wrapper counts during "
        f"the replay {replay_counts} -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: the graph disagrees with eager "
                             "steps")
    del twin, ref
    prof = _measure.device_profile(lambda: multi(st, *groups[2], gen))
    seen = {name: prof.count(sym) for name, sym in KERNEL_SYMBOLS.items()}
    log(f"{tag}: profiler, one replay: {seen} kernel launches, device "
        f"busy {prof.busy_ms:.3f} ms")
    if {name: v for name, v in seen.items() if v} != want:
        raise AssertionError(f"{tag}: the profiler saw {seen}, want "
                             f"{want} per replay")
    return multi.per_replay


# ------------------------------------------------------------------- [dp]
# Data parallelism (leaf_tpu_torch.parallel) on the flagship at B=256 per
# rank. NCCL refuses two ranks on one device, and this machine has had one
# card: world 1 runs on NCCL in this process (every collective is issued,
# a sum of one term: bit-equal to the plain step under deterministic
# algorithms), world 2 on gloo with both ranks on cuda:0 (gloo moves each
# tensor through the host: its results are checked, its times are not
# speed numbers), or on NCCL over two cards where there are two. The
# world-2 runs are held against the plain step on the joined batch:
# losses to DP_LOSS_TOL, BN running stats to DP_STATS_TOL of the layer's
# scale (the global-batch claim: a per-replica BatchNorm misses it), the
# update and the frontend leaves to the train-parity bounds.
DP_CFG = {**PARITY_CFG, "opt": {**PARITY_CFG["opt"], "warmup_epochs": 0}}
DP_STEPS = 2          # steps of each world-1 run (lr > 0 in both)
# one step at world 2: the running stats after it are the first forward's
# (from equal weights), which DP_STATS_TOL holds; a second step's would
# also carry the first update's Adam sign noise
DP2_STEPS = 1
DP_K = 4
DP_LOSS_TOL, DP_STATS_TOL = 2e-4, 1e-5
DP_TIMEOUT = 300      # seconds for the world-2 ranks


class _deterministic:
    """cuDNN's deterministic algorithms and PyTorch's where an op has one
    (warn_only), as tests/test_torch_port_cuda.py's fixture sets them."""

    def __enter__(self):
        self.was = (torch.backends.cudnn.deterministic,
                    torch.backends.cudnn.benchmark,
                    torch.are_deterministic_algorithms_enabled(),
                    torch.is_deterministic_algorithms_warn_only_enabled(),
                    os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.use_deterministic_algorithms(True, warn_only=True)

    def __exit__(self, *exc):
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = self.was[:2]
        torch.use_deterministic_algorithms(self.was[2],
                                           warn_only=self.was[3])
        if self.was[4] is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = self.was[4]
        return False


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


_LAUNCH_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")


def phase_dp(device, state, multistep: dict) -> dict:
    """World 1 on NCCL (f32 and bf16: bit-equality, the K=4 graph, timings
    beside ``multistep``'s plain-step timings) and world 2 (gloo on one
    card, or NCCL on two)."""
    from leaf_tpu_torch.parallel import (data_group, init_distributed,
                                         shutdown_distributed)
    saved = {k: os.environ.get(k) for k in _LAUNCH_VARS}
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    results = {}
    try:
        rank, world, dev = init_distributed("cuda")
        pg = data_group()
        log(f"[dp] world {world} on {torch.distributed.get_backend(pg)}, "
            f"rank {rank} on {dev}")
        for dtype, cfg, sfx in (("f32", TRAIN_CFG, ""),
                                ("bf16", _bf16(TRAIN_CFG), "_bf16")):
            tag = f"[dp] {dtype}"
            par = DP_CFG if dtype == "f32" else _bf16(DP_CFG)
            results[dtype] = {"counts": _dp_world1_bit_equal(
                device, state, par, sfx, tag, pg)}
            _dp_graph_check(device, state, cfg, sfx, tag, pg)
            torch.cuda.empty_cache()
            results[dtype]["timing"] = _dp_timing(
                device, state, cfg, tag, pg, multistep[dtype]["timing"])
    finally:
        shutdown_distributed()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    torch.cuda.empty_cache()
    n_cards = torch.cuda.device_count()
    _dp_world2(device, state, "gloo")
    if n_cards >= 2:
        _dp_world2(device, state, "nccl")
    else:
        log(f"[dp] {n_cards} card on this machine: no NCCL run across "
            f"cards (world 2 ran on gloo, both ranks on cuda:0)")
    return results


def _dp_world1_bit_equal(device, state, cfg, sfx: str, tag: str,
                         pg) -> dict:
    """The plain step, the data-parallel step and the per-replica step at
    world 1 from the same weights on the same batch, DP_STEPS each, under
    deterministic algorithms: losses and every parameter and buffer
    bit-equal; one saving-forward and one backward launch per step."""
    from leaf_tpu_torch.parallel import make_mesh, make_shard_map_train_step
    x, y = _batch(np.random.RandomState(20), TRAIN_B, device)
    runs = {}
    with _deterministic():
        for kind in ("plain", "gspmd", "shard_map"):
            st, step = trainer(cfg, state, device, False, 2, 10,
                               pg=pg if kind == "gspmd" else None)
            if kind == "shard_map":
                step = make_shard_map_train_step(make_mesh(1))
            _zero_counts()
            losses = [step(st, x, y)["loss"] for _ in range(DP_STEPS)]
            torch.cuda.synchronize()
            runs[kind] = (torch.stack(losses), st.model.state_dict(),
                          _counts())
            del st, step
    ref_loss, ref_sd, ref_counts = runs["plain"]
    want = {**_no_launches(), "fwd_save" + sfx: DP_STEPS,
            "bwd" + sfx: DP_STEPS}
    for kind in ("gspmd", "shard_map"):
        loss, sd, counts = runs[kind]
        unequal = [k for k, v in sd.items() if not torch.equal(v, ref_sd[k])]
        ok = (torch.equal(loss, ref_loss) and not unequal
              and counts == ref_counts == want)
        log(f"{tag}: world 1 {kind} step vs the plain step, {DP_STEPS} "
            f"steps at B={TRAIN_B} (deterministic algorithms): losses "
            f"{[float(v) for v in loss]} vs {[float(v) for v in ref_loss]}; "
            f"{len(sd) - len(unequal)}/{len(sd)} state tensors bit-equal; "
            f"launches {counts} -> {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{tag}: the world-1 {kind} step differs "
                                 f"from the plain step: {unequal[:5]}")
    return runs["gspmd"][2]


def _dp_graph_check(device, state, cfg, sfx: str, tag: str, pg) -> None:
    """A K=4 graph of the data-parallel step (augment, dropout and
    drop-connect on) against 4 eager data-parallel steps from the same
    state and generator state, under deterministic algorithms: bit-equal;
    the graph holds the NCCL collectives (the profiler's count in one
    replay)."""
    from leaf_tpu_torch.data import leaf_device_augment
    from leaf_tpu_torch.training import make_train_multistep, make_train_step
    rng = np.random.RandomState(21)
    groups = [stacked(rng, DP_K, TRAIN_B, 16000, device) for _ in range(3)]
    with _deterministic():
        st, _ = trainer(cfg, state, device, True, STEPS_PER_EPOCH, EPOCHS,
                        capturable=True)
        gen = torch.Generator(device=device).manual_seed(21)
        multi = make_train_multistep(DP_K, augment_fn=leaf_device_augment,
                                     process_group=pg)
        multi(st, *groups[0], gen)      # K eager steps, then the capture
        want = {"fwd_save" + sfx: DP_K, "bwd" + sfx: DP_K}
        twin, _, tgen = _twin(cfg, st, gen, device)
        step = make_train_step(augment_fn=leaf_device_augment,
                               process_group=pg)
        got = multi(st, *groups[1], gen)
        ref = [step(twin, groups[1][0][i], groups[1][1][i], tgen)
               for i in range(DP_K)]
        torch.cuda.synchronize()
    # the mean of the K losses as the graph forms it (in the loss's dtype)
    ref_loss = torch.stack([m["loss"] for m in ref]).mean()
    unequal = [k for (k, a), b in zip(st.model.state_dict().items(),
                                      twin.model.state_dict().values())
               if not torch.equal(a, b)]
    ok = (multi.per_replay == want and not unequal
          and torch.equal(got["loss"], ref_loss)
          and int(got["correct"]) == sum(int(m["correct"]) for m in ref)
          and gen.get_state().equal(tgen.get_state()))
    calls, n, dev_ms, _ = _measure.collectives(
        lambda: multi(st, *groups[2], gen))
    log(f"{tag}: K={DP_K} graph of the data-parallel step vs {DP_K} eager "
        f"data-parallel steps (deterministic algorithms): loss "
        f"{float(got['loss']):.6f} vs {float(ref_loss):.6f}; "
        f"{len(unequal)} state tensors differ; launches per replay "
        f"{multi.per_replay}; one replay: {calls} c10d calls, {n} NCCL "
        f"kernels ({dev_ms:.3f} device ms) -> {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{tag}: the data-parallel graph differs from "
                             f"its eager steps: {unequal[:5]}")


def _dp_timing(device, state, cfg, tag: str, pg, plain: dict) -> dict:
    """ms per step (host clock) and device-busy ms of the world-1
    data-parallel step, eager and as a K=4 graph, beside the plain step's
    (``plain``: [multistep]'s timing of this run, by K)."""
    out = {}
    for k in (1, DP_K):
        out[k] = scan_ab.multistep_timing(cfg, state, device, (k,),
                                          calls=TIMED_STEPS, batch=TRAIN_B,
                                          pg=pg, log=log,
                                          tag=f"{tag} dp")[k]
        torch.cuda.empty_cache()
        p, d = plain[k], out[k]
        log(f"{tag} K={k} ({'eager' if k == 1 else 'graph'}): data-parallel "
            f"{d['ms']:.3f} ms/step, device busy {d['busy_ms']:.3f} ms; the "
            f"plain step ([multistep], this run) {p['ms']:.3f} / "
            f"{p['busy_ms']:.3f} ms: {d['ms'] / p['ms'] - 1:+.1%} host "
            f"clock, {d['busy_ms'] / p['busy_ms'] - 1:+.1%} device busy")
    return out


def _dp_rank(r: int, world: int, store: str, tmp: str, backend: str,
             device: str) -> None:
    """One rank of the world-2 run (a spawned process): the data-parallel
    step on its half of the batch, the per-replica step on its half, and
    the per-replica step on the first half (the same rows on every
    rank); writes <tmp>/rank<r>.pt."""
    import torch.distributed as dist

    from leaf_tpu_torch.parallel import make_mesh, make_shard_map_train_step
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=r, world_size=world, **kw)
    try:
        blob = torch.load(os.path.join(tmp, "in.pt"), weights_only=True)
        x, y = blob["x"].to(device), blob["y"].to(device)
        half = slice(r * TRAIN_B, (r + 1) * TRAIN_B)
        out = {}
        for kind, rows in (("dp", half), ("per_replica", half),
                           ("shard_same", slice(0, TRAIN_B))):
            st, step = trainer(DP_CFG, blob["state"], device, False, 2, 10,
                               pg=dist.group.WORLD if kind == "dp" else None)
            if kind != "dp":
                step = make_shard_map_train_step(make_mesh(world))
            _zero_counts()
            t0 = time.perf_counter()
            ms = [step(st, x[rows], y[rows]) for _ in range(DP2_STEPS)]
            torch.cuda.synchronize()
            out[kind] = {"losses": [float(m["loss"]) for m in ms],
                         "count": int(ms[-1]["count"]),
                         "sd": {k: v.cpu() for k, v in
                                st.model.state_dict().items()},
                         "launches": _counts(),
                         "s": time.perf_counter() - t0}
            del st, step
        torch.save(out, os.path.join(tmp, f"rank{r}.pt"))
    finally:
        dist.destroy_process_group()


def _dp_world2(device, state, backend: str) -> None:
    """Two ranks (spawned) against the plain step on the joined batch and
    on the first half, in this process."""
    import multiprocessing

    from leaf_tpu_torch.models import Classifier
    tag = f"[dp] world 2 ({backend}" + (", both ranks on cuda:0)"
                                        if backend == "gloo" else ")")
    rng = np.random.RandomState(22)
    x, y = _batch(rng, 2 * TRAIN_B, "cpu")
    with tempfile.TemporaryDirectory(prefix="leaf_dp_") as tmp:
        torch.save({"state": {k: v.cpu() for k, v in state.items()},
                    "x": x, "y": y}, os.path.join(tmp, "in.pt"))
        ctx = multiprocessing.get_context("spawn")
        t0 = time.perf_counter()
        procs = [ctx.Process(target=_dp_rank, args=(
            r, 2, os.path.join(tmp, "store"), tmp, backend,
            f"cuda:{r}" if backend == "nccl" else str(device)))
            for r in range(2)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(DP_TIMEOUT)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        if any(p.exitcode != 0 for p in procs):
            raise AssertionError(f"{tag}: rank exit codes "
                                 f"{[p.exitcode for p in procs]}")
        outs = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=True) for r in range(2)]
    log(f"{tag}: both ranks done in {time.perf_counter() - t0:.1f} s "
        f"(spawn included; " + ", ".join(
            f"{k} {outs[0][k]['s']:.1f} s" for k in outs[0])
        + f" for {DP2_STEPS} step on rank 0: correctness only)")
    want = {**_no_launches(), "fwd_save": DP2_STEPS, "bwd": DP2_STEPS}
    for r, o in enumerate(outs):
        if o["dp"]["launches"] != want or o["dp"]["count"] != 2 * TRAIN_B:
            raise AssertionError(f"{tag}: rank {r} launches "
                                 f"{o['dp']['launches']}, count "
                                 f"{o['dp']['count']}; want {want}")
    log(f"{tag}: each rank's data-parallel run launched "
        f"{outs[0]['dp']['launches']} ({DP2_STEPS} step: one saving "
        f"forward and one backward per step), global count "
        f"{outs[0]['dp']['count']}")
    p0 = {k: v.cpu().clone() for k, v in state.items()}
    refs = {}
    for name, rows in (("joined", slice(0, 2 * TRAIN_B)),
                       ("first half", slice(0, TRAIN_B))):
        st, step = trainer(DP_CFG, state, device, False, 2, 10)
        losses = [float(step(st, x[rows].to(device), y[rows].to(device))
                         ["loss"]) for _ in range(DP2_STEPS)]
        refs[name] = (st.model.cpu(), losses)
        del st, step
        torch.cuda.empty_cache()

    def module(sd):
        m = Classifier(DP_CFG, device="cpu")
        m.load_state_dict(sd)
        return m

    for r in range(2):
        if any(not torch.equal(v, outs[1]["dp"]["sd"][k])
               for k, v in outs[r]["dp"]["sd"].items()):
            raise AssertionError(f"{tag}: the replicas differ")
    _compare_runs(f"{tag} data-parallel step on the halves vs the plain "
                  f"step on the joined {2 * TRAIN_B}",
                  module(outs[0]["dp"]["sd"]), refs["joined"][0], p0,
                  outs[0]["dp"]["losses"], refs["joined"][1],
                  loss_tol=DP_LOSS_TOL, stats_tol=DP_STATS_TOL,
                  front_tol=FRONTEND_GRAD_TOL)
    _compare_runs(f"{tag} per-replica step on the same {TRAIN_B} rows on "
                  f"both ranks vs the plain step on them",
                  module(outs[0]["shard_same"]["sd"]),
                  refs["first half"][0], p0,
                  outs[0]["shard_same"]["losses"], refs["first half"][1],
                  loss_tol=DP_LOSS_TOL, stats_tol=DP_STATS_TOL,
                  front_tol=FRONTEND_GRAD_TOL)
    miss = _stats_error(module(outs[0]["per_replica"]["sd"]),
                        refs["joined"][0])
    log(f"{tag}: per-replica BatchNorm on the halves vs the joined batch: "
        f"BN stats mean/sd {miss[0]:.3e}, var/var {miss[1]:.3e} (the "
        f"global-batch check's tol {DP_STATS_TOL:g}: it must miss)")
    if max(miss) <= DP_STATS_TOL:
        raise AssertionError(f"{tag}: per-replica statistics pass the "
                             "global-batch check: it cannot see the fault")


def phase_dp_cli(tmp: str) -> None:
    """[cli]'s tone task through ``torchrun --nproc_per_node 1``: train
    --n_devices 1 --multihost --steps_per_call 4 for 2 epochs (epoch 0
    captures the data-parallel graph with its NCCL calls, epoch 1 replays
    it), evaluate --n_devices 1, and the one-device evaluate of the same
    checkpoint (the same accuracy); then ``python -m leaf_tpu_torch.dryrun
    1`` on the card."""
    cfg_file = os.path.join(tmp, "flagship.cfg")
    exp = os.path.join(tmp, "exp_dp")
    steps = CLI_TRAIN // TRAIN_B
    out, _ = _cli("train", ["--cfg_file", cfg_file, "--expdir", exp,
                            "--num_workers", "4", "--epochs", "2",
                            "--steps_per_call", str(DP_K), "--n_devices",
                            "1", "--multihost"],
                  "torchrun train --n_devices 1 --multihost "
                  f"--steps_per_call {DP_K} --epochs 2", torchrun=1)
    epochs = _epoch_lines(out)
    counts = epochs[-1][4] if epochs else {}
    if ("devices: 1 |" not in out or len(epochs) != 2
            or not all(np.isfinite(e[1]) for e in epochs)
            or counts.get("fwd_save") != 2 * steps
            or counts.get("bwd") != 2 * steps):
        raise AssertionError(f"data-parallel train CLI: {epochs}")
    ev = ["--exp_dir", exp, "--meta_dir", tmp, "--test_csv_name",
          "test.csv"]
    out_dp, _ = _cli("evaluate", ev + ["--n_devices", "1"],
                     "torchrun evaluate --n_devices 1", torchrun=1)
    os.remove(os.path.join(exp, "results.txt"))
    out_one, _ = _cli("evaluate", ev, "evaluate (one device, no launcher)")
    accs = [re.search(r"Accuracy: (\S+)", o) for o in (out_dp, out_one)]
    if not all(accs) or accs[0].group(1) != accs[1].group(1):
        raise AssertionError(f"evaluate --n_devices 1 and the one-device "
                             f"evaluate disagree: {accs}")
    log(f"[cli] data parallel: 2 epochs of {steps} steps under torchrun "
        f"at K={DP_K} (launches {counts}, the replay's included; losses "
        f"{[e[1] for e in epochs]}); evaluate --n_devices 1 and the "
        f"one-device evaluate of its checkpoint: Accuracy "
        f"{accs[0].group(1)} both")
    # the dry run's program on one NCCL rank: its default device is the
    # card (K = 2 as a CUDA graph with the collectives captured)
    out, _ = _cli("dryrun", ["1"], "dryrun 1 (one NCCL rank on the card)")
    if "dryrun_multichip(1): ok" not in out:
        raise AssertionError(f"dryrun 1: {out[-2000:]}")


# ------------------------------------------------------------------ [zoo]
# The rest of the model zoo on the fused frontend kernels. The ResNet-18
# recipes are read from the checkout's cfgs as the CLIs read them.
R18_CFG_FILE = "speechcommands/resnet-18-leaf-default.cfg"
AUDIOSET_CFG_FILE = "audioset/resnet-18-leaf-default.cfg"
# AudioSet's balanced train split (~22 k clips) at the cfg's B=128
AUDIOSET_STEPS_PER_EPOCH, AUDIOSET_EPOCHS = 22160 // AUDIOSET_B, 60
ZOO_B = 32
# remat / memory_efficient on against off on the card, one train step from
# the same weights and generator state: each gradient and running stat
# within REMAT_TOL of its norm (cuDNN's weight gradients sum in no fixed
# order; the recompute repeats the forward's kernels on the same inputs)
REMAT_TOL = 1e-5
# fused vs 'off' through a ReLU backbone: one step's gradients from the
# same weights (Adam's first updates are lr·sign(g) and would turn float
# noise into whole-step differences). A relu or max-pool input that sits
# within float noise of its kink takes the other branch under the other
# frontend's last bits, and moves the gradient of every layer below it.
# On the H100 the worst frontend leaf reads 1.16e-2 (speechcommands) and
# 1.55e-2 (AudioSet shape); 'off' against 'off' with the input scaled by
# 1 + 1e-6·N(0, 1) reads 6.6e-3 and 1.45e-2; d_bank or d_windows scaled
# by 1.05 reads 4.9e-2 to 5.5e-2 on its leaf, zeroed 1.0. The whole model's gradient
# and the running stats after the step's forward keep UPDATE_TOL and
# STATS_TOL.
FRONTEND_GRAD_TOL = 4e-2
ZOO_REST = (
    ("resnet50", {"arch": "resnet", "model_depth": 50}),
    ("resnet18 vlad", {"arch": "resnet", "model_depth": 18, "pool": "vlad"}),
    ("cifar_resnet20", {"arch": "cifar_resnet", "model_depth": 20}),
    # memory_efficient is a constructor argument only (not read from the
    # cfg, as in the JAX package): set on the built model, see _set_remat
    ("densenet121 memory_efficient", {"arch": "densenet",
                                      "model_depth": 121}),
    ("efficientnet-b0 remat", {"arch": "efficientnet", "model_depth": "b0",
                               "remat": True}),
)


def _cfg(name: str) -> dict:
    """``cfgs/<name>`` of the checkout, as the CLIs read it."""
    from leaf_tpu_torch.training.config import get_config
    here = os.path.dirname(os.path.abspath(__file__))
    return get_config(os.path.join(here, "cfgs", name))


def _off(cfg: dict) -> dict:
    return {**cfg, "frontend": {**cfg["frontend"], "use_fused_kernel": "off"}}


def phase_zoo_serving(device, tmp):
    """The speechcommands ResNet-18 cfg through ``ServingModel`` (buckets
    8, 64), f32 and bf16, and from ``save_exported`` artifacts (f32):
    one primal launch of the dtype's kernel per bucket forward; logits
    against 'off' on the card and the CPU (f32), against f32 (bf16, unit
    BN statistics) and against the live module (artifact); latency per
    bucket, live and artifact in turns. Returns the BN-calibrated
    weights."""
    from leaf_tpu_torch.models import Classifier
    from leaf_tpu_torch.models.common import set_batch_norm_stats_
    from leaf_tpu_torch.serving import ServingModel, save_exported
    cfg = _cfg(R18_CFG_FILE)
    rng = np.random.RandomState(21)
    clf = Classifier(cfg, device=device,
                     generator=torch.Generator().manual_seed(0)).eval()
    unit = {k: v.clone() for k, v in clf.state_dict().items()}
    set_batch_norm_stats_(clf, torch.from_numpy(
        (rng.randn(64, 16000) * 0.1).astype(np.float32)).to(device))
    state = {k: v.clone() for k, v in clf.state_dict().items()}
    requests = {n: (rng.randn(n, 16000) * 0.1).astype(np.float32)
                for n in REQUEST_SIZES}
    forwards = sum(-(-n // BUCKETS[-1]) for n in REQUEST_SIZES)
    for dtype, run_cfg, weights, sfx, ref_cfg, tol in (
            ("f32", cfg, state, "", _off(cfg), LOGIT_TOL),
            ("bf16", _bf16(cfg), unit, "_bf16", cfg, BF16_LOGIT_TOL)):
        tag = f"[zoo] resnet-18 serving {dtype}"
        server = ServingModel(run_cfg, state_dict=weights, device=device,
                              batch_sizes=BUCKETS)
        _zero_counts()
        outs = {n: server(requests[n]) for n in REQUEST_SIZES}
        torch.cuda.synchronize()
        counts = _counts()
        log(f"{tag}: requests {REQUEST_SIZES} -> {forwards} bucket "
            f"forwards, kernel launches {counts}")
        if counts != {**_no_launches(), "fwd" + sfx: forwards}:
            raise AssertionError(f"{tag}: expected one primal launch per "
                                 f"forward ({forwards}), counted {counts}")
        ref = ServingModel(ref_cfg, state_dict=weights, device=device,
                           batch_sizes=BUCKETS)
        cpu = (ServingModel(_off(cfg), state_dict=weights, device="cpu",
                            batch_sizes=BUCKETS) if dtype == "f32" else None)
        for n in REQUEST_SIZES:
            got, want = outs[n], ref(requests[n])
            if (got.shape != (n, 35) or got.dtype != np.float32
                    or not np.isfinite(got).all()):
                raise AssertionError(f"{tag}: bad logits for {n} clips")
            rel = float(np.abs(got - want).max() / np.abs(want).max())
            line = (f"{tag} n={n}: max|logit| {np.abs(want).max():.3e}, "
                    f"vs {'off' if dtype == 'f32' else 'f32'} rel "
                    f"{rel:.3e}")
            if cpu is not None and n == REQUEST_SIZES[0]:
                cpu_rel = float(np.abs(got - cpu(requests[n])).max()
                                / np.abs(want).max())
                line += f", card vs CPU rel {cpu_rel:.3e}"
                rel = max(rel, cpu_rel)
            log(line + f" (tol {tol:g})")
            if rel > tol:
                raise AssertionError(f"{tag}: logits disagree for {n} "
                                     f"clips: {rel}")
        del server, ref, cpu

    out = os.path.join(tmp, "serving_resnet18")
    t0 = time.perf_counter()
    save_exported(out, cfg, state_dict=state, device=device,
                  batch_sizes=BUCKETS)
    t_export = time.perf_counter() - t0
    art = ServingModel.load(out, device=device)
    live = ServingModel(cfg, state_dict=state, device=device,
                        batch_sizes=BUCKETS)
    _zero_counts()
    outs = {n: art(requests[n]) for n in REQUEST_SIZES}
    torch.cuda.synchronize()
    counts = _counts()
    worst = max(float(np.abs(outs[n] - live(requests[n])).max()
                      / np.abs(outs[n]).max()) for n in REQUEST_SIZES)
    log(f"[zoo] resnet-18 export: buckets {BUCKETS} in {t_export:.1f} s; "
        f"kernel launches {counts}; artifact vs live max|a-b|/max|a| "
        f"{worst:.3e} (tol {ARTIFACT_TOL:g})")
    if counts != {**_no_launches(), "fwd": forwards} or worst > ARTIFACT_TOL:
        raise AssertionError("[zoo] resnet-18 artifact disagrees")
    _serve_in_turns("[zoo] resnet-18 f32", {"artifact": art, "live": live},
                    rng, device)
    return state


def phase_zoo_train(device, state):
    """The speechcommands ResNet-18 recipe at B=256: 5 steps f32 and
    bf16 (one saving-forward and one backward launch per step), 3 steps
    fused against 'off' on the card, a K=4 graph against 4 eager steps,
    and ms per step eager and at K=4 with the device's busy time, idle
    share and the frontend kernels' share."""
    cfg = _cfg(R18_CFG_FILE)
    x, y = _batch(np.random.RandomState(22), TRAIN_B, device)
    for dtype, run_cfg, sfx in (("f32", cfg, ""), ("bf16", _bf16(cfg),
                                                   "_bf16")):
        st, step = trainer(run_cfg, state, device, True, STEPS_PER_EPOCH,
                           EPOCHS)
        gen = torch.Generator(device=device).manual_seed(22)
        _zero_counts()
        losses = [float(step(st, x, y, gen)["loss"])
                  for _ in range(TRAIN_STEPS)]
        counts = _counts()
        log(f"[zoo] resnet-18 train {dtype} B={TRAIN_B} x 16000, "
            f"{TRAIN_STEPS} steps (augment on): losses "
            f"{', '.join(f'{v:.6f}' for v in losses)}; kernel launches "
            f"{counts}")
        if (not all(np.isfinite(losses)) or counts != {
                **_no_launches(), "fwd_save" + sfx: TRAIN_STEPS,
                "bwd" + sfx: TRAIN_STEPS}):
            raise AssertionError(f"[zoo] resnet-18 train {dtype} failed")
        del st, step
    torch.cuda.empty_cache()
    _fused_vs_off("[zoo] resnet-18", {**cfg, "opt": {**cfg["opt"],
                                                      "warmup_epochs": 1}},
                  state, x, y, 3, 2, 10)
    torch.cuda.empty_cache()
    _multistep_check(device, state, cfg, "", "[zoo] resnet-18 multistep f32")
    torch.cuda.empty_cache()
    timing = {dtype: scan_ab.multistep_timing(
        run_cfg, state, device, ks=(1, 4), calls=TIMED_STEPS, batch=TRAIN_B,
        log=log, tag=f"[zoo] resnet-18 {dtype}")
        for dtype, run_cfg in (("f32", cfg), ("bf16", _bf16(cfg)))}
    st, step = trainer(cfg, state, device, True, STEPS_PER_EPOCH, EPOCHS)
    gen = torch.Generator(device=device).manual_seed(8)
    _log_profile("[zoo] resnet-18 f32 eager step", measure_program(
        lambda: step(st, x, y, gen), device, 1)["profile"])
    return timing


def _fused_vs_off(tag: str, cfg, state, x, y, steps: int,
                  steps_per_epoch: int, epochs: int) -> None:
    """``steps`` train steps (augment off) of ``cfg`` with the fused
    kernels and with ``use_fused_kernel='off'`` from the weights
    ``state`` on the batch (x, y): each step's loss within LOSS_TOL; the
    first step's gradients (whole model within UPDATE_TOL, each frontend
    leaf within FRONTEND_GRAD_TOL) and running stats (STATS_TOL of each
    one's norm), all of the same weights."""
    runs = []
    for run_cfg in (cfg, _off(cfg)):
        st, step = trainer(run_cfg, state, x.device, False, steps_per_epoch,
                           epochs)
        losses = [float(step(st, x, y)["loss"])]
        first = _grads_and_stats(st.model)
        losses += [float(step(st, x, y)["loss"]) for _ in range(steps - 1)]
        runs.append((losses,) + first)
        del st, step
        torch.cuda.empty_cache()
    (la, ga, sa), (lb, gb, sb) = runs
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(la, lb))
    front = _rel_by_leaf({k: v for k, v in ga.items()
                          if k.startswith("features.")},
                         {k: v for k, v in gb.items()
                          if k.startswith("features.")})
    worst = max(front, key=front.get)
    num = sum(float((ga[k] - gb[k]).norm() ** 2) for k in gb)
    den = sum(float(gb[k].norm() ** 2) for k in gb)
    grad_rel = (num / den) ** 0.5
    stats = _rel_by_leaf(sa, sb)
    stats_key = max(stats, key=stats.get)
    ok = (loss_rel <= LOSS_TOL and len(front) == 7
          and front[worst] <= FRONTEND_GRAD_TOL and grad_rel <= UPDATE_TOL
          and stats[stats_key] <= STATS_TOL)
    log(f"{tag} fused vs 'off' on the card, B={x.shape[0]}, {steps} "
        f"step(s): losses {', '.join(f'{v:.6f}' for v in la)} vs "
        f"{', '.join(f'{v:.6f}' for v in lb)} (max rel {loss_rel:.3e}, tol "
        f"{LOSS_TOL:g}); first step's gradient rel-norm {grad_rel:.3e} "
        f"(tol {UPDATE_TOL:g}), worst frontend leaf {worst} "
        f"{front[worst]:.3e} (tol {FRONTEND_GRAD_TOL:g}); running stats "
        f"worst {stats_key} {stats[stats_key]:.3e} of its norm (tol "
        f"{STATS_TOL:g}) -> {'ok' if ok else 'FAIL'}")
    log(f"{tag} frontend leaves' gradients: " + ", ".join(
        f"{k[len('features.'):]} {v:.3e}" for k, v in front.items()))
    if not ok:
        raise AssertionError(f"{tag}: fused and 'off' disagree")


def _grads_and_stats(model) -> tuple:
    grads = {k: p.grad.detach().clone() for k, p in model.named_parameters()
             if p.grad is not None}
    stats = {k: t.clone() for k, t in model.state_dict().items()
             if "running" in k}
    return grads, stats


def _rel_by_leaf(a: dict, b: dict) -> dict:
    """‖a − b‖ / ‖b‖ for each key (both dicts hold the same keys)."""
    if a.keys() != b.keys():
        raise AssertionError(f"different leaves: {set(a) ^ set(b)}")
    return {k: float((a[k].float() - b[k].float()).norm()
                     / max(float(b[k].float().norm()), 1e-30)) for k in b}


def _worst_rel(a: dict, b: dict) -> tuple:
    """(worst ‖a − b‖ / ‖b‖ over the keys, its key)."""
    rel = _rel_by_leaf(a, b)
    key = max(rel, key=rel.get)
    return rel[key], key


def phase_zoo_audioset(device):
    """The AudioSet ResNet-18 cfg (64 filters, 5 s clips, B=128,
    multilabel, 'step' schedule): 3 steps with finite losses and one
    saving-forward and one backward launch each; 1 step fused against
    'off' on the card (``_fused_vs_off``)."""
    from leaf_tpu_torch.models import Classifier
    cfg = _cfg(AUDIOSET_CFG_FILE)
    n_classes = cfg["model"]["num_classes"]
    state = Classifier(cfg, device=device,
                       generator=torch.Generator().manual_seed(0)).state_dict()
    rng = np.random.RandomState(23)
    x = torch.from_numpy((rng.randn(AUDIOSET_B, AUDIOSET_T) * 0.1)
                         .astype(np.float32)).to(device)
    y = np.zeros((AUDIOSET_B, n_classes), np.float32)
    y[np.arange(AUDIOSET_B)[:, None],
      rng.randint(0, n_classes, (AUDIOSET_B, 2))] = 1.0
    y = torch.from_numpy(y).to(device)
    st, step = trainer(cfg, state, device, True, AUDIOSET_STEPS_PER_EPOCH,
                       AUDIOSET_EPOCHS)
    gen = torch.Generator(device=device).manual_seed(23)
    _zero_counts()
    t0 = time.perf_counter()
    losses = [float(step(st, x, y, gen)["loss"]) for _ in range(3)]
    wall = (time.perf_counter() - t0) / 3 * 1e3
    counts = _counts()
    log(f"[zoo] audioset resnet-18 B={AUDIOSET_B} x {AUDIOSET_T}, "
        f"F={AUDIOSET_F}, {cfg['model']['type']}, 3 steps (augment on): "
        f"losses {', '.join(f'{v:.6f}' for v in losses)} ({wall:.1f} ms "
        f"per step, host clock, first steps included); kernel launches "
        f"{counts}")
    if (not all(np.isfinite(losses)) or cfg["model"]["type"] != "multilabel"
            or counts != {**_no_launches(), "fwd_save": 3, "bwd": 3}):
        raise AssertionError("[zoo] audioset resnet-18 train failed")
    del st, step
    torch.cuda.empty_cache()
    _fused_vs_off("[zoo] audioset resnet-18", cfg, state, x, y, 1,
                  AUDIOSET_STEPS_PER_EPOCH, AUDIOSET_EPOCHS)


def _set_remat(model, on: bool) -> bool:
    """Turn ``model``'s rematerialisation on or off (EfficientNet's
    ``remat``, DenseNet's ``memory_efficient`` per dense block); False
    if it has none."""
    from leaf_tpu_torch.models.densenet import DenseBlock
    from leaf_tpu_torch.models.efficientnet import EfficientNet
    found = False
    for m in model.modules():
        if isinstance(m, EfficientNet):
            m.remat, found = on, True
        elif isinstance(m, DenseBlock):
            m.memory_efficient, found = on, True
    return found


def phase_zoo_rest(device):
    """ResNet-50, ResNet-18 with NetVLAD, CIFAR-ResNet-20, DenseNet-121
    (memory_efficient) and EfficientNet-b0 (remat) behind the flagship
    Leaf, B=32 x 16000: eval logits on the card against the CPU; one
    train step (remat / memory_efficient on against off on the card where
    the model has it); and b0 with remat as a K=4 CUDA graph against
    eager steps."""
    from leaf_tpu_torch.models import Classifier
    from leaf_tpu_torch.models.common import set_batch_norm_stats_
    rng = np.random.RandomState(24)
    x = torch.from_numpy((rng.randn(ZOO_B, 16000) * 0.1).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 35, ZOO_B))
    for name, spec in ZOO_REST:
        tag = f"[zoo] {name}"
        cfg = {**FLAGSHIP_CFG, "model": {**spec, "num_classes": 35}}
        clf = Classifier(cfg, device=device,
                         generator=torch.Generator().manual_seed(0)).eval()
        set_batch_norm_stats_(clf, x.to(device))
        # copies: the train steps below update the module's own tensors
        state = {k: v.clone() for k, v in clf.state_dict().items()}
        cpu = Classifier(cfg, device="cpu").eval()
        cpu.load_state_dict(state)
        with torch.no_grad():
            got = clf(x.to(device)).cpu()
            want = cpu(x)
        rel = float((got - want).abs().max() / want.abs().max())
        log(f"{tag}: eval logits {tuple(got.shape)} card vs CPU max|a-b|/"
            f"max|b| {rel:.3e} (tol {LOGIT_TOL:g}), max|logit| "
            f"{float(want.abs().max()):.3e}")
        if (tuple(got.shape) != (ZOO_B, 35) or not bool(
                torch.isfinite(got).all()) or rel > LOGIT_TOL):
            raise AssertionError(f"{tag}: card and CPU disagree")
        del cpu
        runs = []
        # remat on against off with cuDNN's deterministic algorithms: its
        # unordered weight-gradient and BatchNorm sums would otherwise
        # differ between any two runs, and a leaf whose gradient is a
        # near-cancelling sum (DenseNet's norm0 scale) shows it at 1e-2
        torch.backends.cudnn.deterministic = True
        for on in ((False, True) if _set_remat(clf, False) else (False,)):
            _set_remat(clf, on)
            clf.load_state_dict(state)
            clf.train()
            clf.zero_grad(set_to_none=True)
            gen = torch.Generator(device=device).manual_seed(7)
            _zero_counts()
            torch.cuda.reset_peak_memory_stats()
            loss = torch.nn.functional.cross_entropy(
                clf(x.to(device), gen).float(), y.to(device))
            loss.backward()
            counts = _counts()
            runs.append((float(loss.detach()), *_grads_and_stats(clf),
                         gen.get_state()))
            log(f"{tag}: train step (remat {'on' if on else 'off'}): loss "
                f"{float(loss):.6f}; kernel launches {counts}; peak "
                f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            if (not np.isfinite(float(loss)) or counts != {
                    **_no_launches(), "fwd_save": 1, "bwd": 1}):
                raise AssertionError(f"{tag}: train step failed")
        torch.backends.cudnn.deterministic = False
        if len(runs) == 2:
            (la, ga, sa, gsa), (lb, gb, sb, gsb) = runs[1], runs[0]
            g_rel, g_key = _worst_rel(ga, gb)
            s_rel, s_key = _worst_rel(sa, sb)
            loss_rel = abs(la - lb) / abs(lb)
            same_gen = torch.equal(gsa, gsb)
            ok = max(g_rel, s_rel, loss_rel) <= REMAT_TOL and same_gen
            log(f"{tag}: remat on vs off: loss rel {loss_rel:.3e}, worst "
                f"gradient {g_key} {g_rel:.3e}, worst running stat {s_key} "
                f"{s_rel:.3e} of its norm (tol {REMAT_TOL:g}); generators "
                f"alike: {same_gen} -> {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{tag}: remat changes the step")
        del clf, runs
        torch.cuda.empty_cache()
    # a checkpointed step captured and replayed as a CUDA graph
    cfg = {**TRAIN_CFG, "model": {**TRAIN_CFG["model"], "remat": True}}
    state = Classifier(cfg, device=device,
                       generator=torch.Generator().manual_seed(0)).state_dict()
    _multistep_check(device, state, cfg, "", "[zoo] efficientnet-b0 remat "
                     "multistep")


# ------------------------------------------------------------------ [cli]
# The synthetic tone task (after scripts/synthetic_convergence.py): class c
# is a tone in the band 200 + 150·c ± 40 Hz with a random gain and phase,
# plus noise. The host pipeline must feed B=256 steps of ~35.1 ms of
# device time (PERF.md §5): 256 / 0.0351 s ≈ 7300 clips/s.
CLI_CLASSES, CLI_TRAIN, CLI_VAL, CLI_TEST = 35, 1024, 256, 48
CLI_TIMEOUT = 400
STEP_DEVICE_CLIPS_PER_S = 7300


def _tone(rng, c, t):
    f0 = 200.0 + 150.0 * c + rng.uniform(-40.0, 40.0)
    amp = rng.uniform(0.1, 0.5)
    phase = rng.uniform(0, 2 * np.pi)
    return amp * np.sin(2 * np.pi * f0 * t + phase)


def _write_tone_task(root: str) -> None:
    """train/val/test manifests of tone WAVs (1 s; the test clips 1–3 s),
    the label map, and the flagship and speechcommands ResNet-18 cfgs
    pointing at them."""
    import csv

    from leaf_tpu_torch.data import write_wav
    sr = 16000
    rng = np.random.RandomState(0)
    for name, n, seconds in (("train", CLI_TRAIN, lambda i: 1.0),
                             ("val", CLI_VAL, lambda i: 1.0),
                             ("test", CLI_TEST, lambda i: 1.0 + (i % 5) / 2)):
        os.makedirs(os.path.join(root, name))
        rows = []
        for i in range(n):
            c = i % CLI_CLASSES
            t = np.arange(int(seconds(i) * sr)) / sr
            x = _tone(rng, c, t) + 0.05 * rng.randn(t.size)
            path = os.path.join(root, name, f"clip{i:05d}.wav")
            write_wav(path, x.astype(np.float32), sr)
            rows.append((path, f"class{c}"))
        with open(os.path.join(root, f"{name}.csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(("files", "labels"))
            w.writerows(rows)
    with open(os.path.join(root, "lbl_map.json"), "w") as f:
        json.dump({f"class{c}": c for c in range(CLI_CLASSES)}, f)
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "cfgs", "speechcommands",
                           "efficientnet-b0-leaf-default.cfg")) as f:
        text = f.read()
    text = text.replace('meta_root: "/data/speech_commands/meta"',
                        f'meta_root: "{root}"')
    with open(os.path.join(root, "flagship.cfg"), "w") as f:
        f.write(text)
    with open(os.path.join(here, "cfgs", R18_CFG_FILE)) as f:
        text = f.read()
    with open(os.path.join(root, "resnet18.cfg"), "w") as f:
        f.write(text.replace('meta_root: "/data/speech_commands/meta"',
                             f'meta_root: "{root}"'))


def _spawn(module: str, args, torchrun: int = 0, stdout=subprocess.PIPE):
    """Start ``python -m leaf_tpu_torch.<module>`` (under ``torchrun
    --standalone --nproc_per_node N`` with ``torchrun`` N) from the
    checkout, stderr into stdout, in a session of its own (so _stop
    reaches the processes it starts)."""
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-u", "-m", f"leaf_tpu_torch.{module}", *args]
    if torchrun:
        cmd[2:3] = ["-m", "torch.distributed.run", "--standalone",
                    "--nproc_per_node", str(torchrun), "-m"]
    env = {**os.environ,
           "PYTHONPATH": here + os.pathsep + os.environ.get("PYTHONPATH", "")}
    return subprocess.Popen(cmd, stdout=stdout, stderr=subprocess.STDOUT,
                            text=True, env=env, cwd=here,
                            start_new_session=True)


def _stop(proc) -> None:
    """Kill ``proc`` and every process of its session, if it still runs."""
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def _cli(module: str, args, tag: str, sigterm_after_steps: int = 0,
         torchrun: int = 0):
    """Run ``python -m leaf_tpu_torch.<module>`` (``_spawn``); returns its
    stdout. With ``sigterm_after_steps`` it is sent SIGTERM after that
    many step lines. Fails on a non-zero exit; never leaves the process,
    or a process it started, running."""
    t0 = time.perf_counter()
    proc = _spawn(module, args, torchrun)
    try:
        lines, steps = [], 0
        if sigterm_after_steps:
            for line in proc.stdout:
                lines.append(line)
                if " step " in line and " rate " in line:
                    steps += 1
                    if steps == sigterm_after_steps:
                        proc.send_signal(signal.SIGTERM)
                        break
        rest, _ = proc.communicate(timeout=CLI_TIMEOUT)
    finally:
        _stop(proc)
    out = "".join(lines) + (rest or "")
    wall = time.perf_counter() - t0
    for line in out.splitlines():
        log(f"[cli]   {line}")
    log(f"[cli] {tag}: exit {proc.returncode}, wall {wall:.1f} s")
    if proc.returncode != 0:
        raise AssertionError(f"{tag} exited {proc.returncode}")
    return out, wall


_EPOCH_LINE = re.compile(r"^epoch (\d+): tr_loss (\S+) .* val_acc (\S+) "
                         r"\((\S+)s, (\S+) ex/s\) kernels (\{.*\})$", re.M)


def _epoch_lines(out: str):
    return [(int(e), float(loss), float(acc), float(rate), json.loads(k))
            for e, loss, acc, _, rate, k in _EPOCH_LINE.findall(out)]


def _check_exported(exp: str, out: str) -> None:
    """The export CLI's artifacts (``out``) against the live model of the
    checkpoint it exported (the best of ``exp``), on the card."""
    from leaf_tpu_torch.serving import ServingModel
    from leaf_tpu_torch.training.checkpoint import (best_checkpoint,
                                                    load_hparams)
    ckpt = best_checkpoint(exp)
    weights = torch.load(os.path.join(ckpt, "state.pt"), map_location="cpu",
                         weights_only=True)["model"]
    live = ServingModel(load_hparams(exp), state_dict=weights,
                        batch_sizes=(8,))
    art = ServingModel.load(out)
    x = (np.random.RandomState(18).randn(20, 16000) * 0.1).astype(np.float32)
    a, b = art(x), live(x)
    rel = float(np.abs(a - b).max() / np.abs(b).max())
    with open(os.path.join(out, "serving_stream.json")) as f:
        roles = sorted(json.load(f)["files"])
    log(f"[cli] export_serving: {sorted(os.listdir(out))}; artifact vs the "
        f"live model of {os.path.basename(ckpt)} on 20 clips: max|a-b|/max|b| "
        f"{rel:.3e} (tol {ARTIFACT_TOL:g}); streaming roles {roles}")
    if rel > ARTIFACT_TOL or roles != ["first", "flush_0", "steady"]:
        raise AssertionError("export_serving's artifact disagrees")


def _train_files(cfg: dict, n: int) -> list:
    from leaf_tpu_torch.data.dataset import read_manifest
    return read_manifest(cfg["data"]["train"])["files"][:n]


def phase_cli(tmp: str) -> dict:
    """The flagship recipe through the CLIs on the synthetic tone task:
    train 2 epochs, preempt and resume, evaluate (and skip), and the host
    loader's throughput on its own."""
    from leaf_tpu_torch.training.config import get_config
    t0 = time.perf_counter()
    _write_tone_task(tmp)
    log(f"[cli] wrote {CLI_TRAIN} + {CLI_VAL} + {CLI_TEST} tone WAVs "
        f"({CLI_CLASSES} classes) in {time.perf_counter() - t0:.1f} s")
    cfg_file = os.path.join(tmp, "flagship.cfg")
    cfg = get_config(cfg_file)
    if (cfg["opt"]["batch_size"] != TRAIN_B or cfg["opt"]["lr"] != "1e-3"
            or cfg["data"]["train"] != os.path.join(tmp, "train.csv")):
        raise AssertionError(f"flagship cfg read wrongly: {cfg}")
    exp = os.path.join(tmp, "exp")
    steps = CLI_TRAIN // TRAIN_B
    val_batches = -(-CLI_VAL // TRAIN_B)
    base = ["--cfg_file", cfg_file, "--expdir", exp, "--num_workers", "4"]
    walls = {}

    out, walls["train 2 epochs"] = _cli("train", base + ["--epochs", "2"],
                                        "train --epochs 2")
    epochs = _epoch_lines(out)
    missing = [p for p in ("hparams.json", "epoch_000/meta.json",
                           "epoch_000/state.pt", "epoch_001/meta.json",
                           "epoch_001/state.pt")
               if not os.path.exists(os.path.join(exp, p))]
    counts = epochs[-1][4] if len(epochs) == 2 else {}
    if (missing or len(epochs) != 2
            or not all(np.isfinite(e[1]) for e in epochs)
            or counts.get("fwd_save") != 2 * steps
            or counts.get("bwd") != 2 * steps
            or counts.get("fwd", 0) < 2 * val_batches):
        raise AssertionError(f"train CLI: missing {missing}, epochs "
                             f"{epochs}")
    log(f"[cli] train: {len(epochs)} epochs of {steps} steps at "
        f"B={TRAIN_B}; losses {[e[1] for e in epochs]}; kernel launches "
        f"{counts} (saving forward = backward = {2 * steps} steps; primal "
        f"forward >= {2 * val_batches} val batches)")
    log("[cli] train loop: " + ", ".join(
        f"epoch {e[0]} {e[3]:.1f} clips/s" for e in epochs)
        + " (RateTracker.global_rate over the epoch's steps, read after "
        "the last step's loss)")

    # the export CLI on this experiment: its artifacts against the live
    # model of the checkpoint it read
    out, walls["export_serving"] = _cli(
        "export_serving", ["--exp_dir", exp, "--out_dir",
                           os.path.join(tmp, "serving"), "--batch_sizes",
                           "8", "--streaming_chunk", "1600",
                           "--streaming_streams", "8"],
        "export_serving --batch_sizes 8 --streaming_chunk 1600")
    _check_exported(exp, os.path.join(tmp, "serving"))
    k1_rate = epochs[-1][3]

    # preempt mid-epoch, then resume. The host enqueues steps ahead of the
    # card, so the signal lands in epoch 2 or later: read which.
    out, walls["train preempted"] = _cli(
        "train", base + ["--epochs", "6", "--log_steps", "1",
                         "--continue_from_ckpt", "latest"],
        "train --epochs 6 (SIGTERM after 2 step lines)",
        sigterm_after_steps=2)
    hit = re.search(r"SIGTERM: checkpointed mid-epoch (\d+) step (\d+)", out)
    if "resumed from" not in out or not hit:
        raise AssertionError("no preempt save")
    stop = int(hit.group(1))
    with open(os.path.join(exp, f"epoch_{stop:03d}_preempt",
                           "meta.json")) as f:
        meta = json.load(f)
    if stop < 2 or meta["epoch"] != stop - 1:
        raise AssertionError(f"preempted in epoch {stop}, meta {meta}")
    out, walls["train resumed"] = _cli(
        "train", base + ["--epochs", str(stop + 1),
                         "--continue_from_ckpt", "latest"],
        f"train --epochs {stop + 1} --continue_from_ckpt latest")
    resumed = _epoch_lines(out)
    if (f"_preempt at epoch {stop}" not in out
            or [e[0] for e in resumed] != [stop]
            or not os.path.exists(os.path.join(exp, f"epoch_{stop:03d}",
                                               "state.pt"))):
        raise AssertionError(f"resume did not redo the interrupted epoch "
                             f"{stop}")
    log(f"[cli] preempt: SIGTERM landed in epoch {stop} at step "
        f"{hit.group(2)}; epoch_{stop:03d}_preempt has meta epoch "
        f"{meta['epoch']}; the resume redid epoch {stop} and saved it")

    ev = ["--exp_dir", exp, "--meta_dir", tmp, "--test_csv_name",
          "test.csv", "--bn_recalibrate", "2"]
    out, walls["evaluate"] = _cli("evaluate", ev, "evaluate --bn_recalibrate 2")
    res_path = os.path.join(exp, "results.txt")
    with open(res_path) as f:
        body = f.read()
    rows = body.splitlines()
    if (len(rows) != 2 or rows[0] != "model,acc,ckpt"
            or not rows[1].startswith("efficientnet,")
            or not 0.0 <= float(rows[1].split(",")[1]) <= 1.0
            or "recalibrating BN stats on 2 batches" not in out):
        raise AssertionError(f"results.txt malformed: {body!r}")
    log(f"[cli] results.txt: {rows[1]}")
    out, walls["evaluate (skips)"] = _cli("evaluate", ev, "evaluate again")
    with open(res_path) as f:
        if "skipping" not in out or f.read() != body:
            raise AssertionError("the second evaluate did not skip")

    # bf16: train --bf16 saves compute_dtype bfloat16 in hparams.json,
    # runs the bf16 kernels only; evaluate reads bf16 from it
    bexp = os.path.join(tmp, "exp_bf16")
    out, walls["train --bf16"] = _cli(
        "train", ["--cfg_file", cfg_file, "--expdir", bexp, "--num_workers",
                  "4", "--epochs", "1", "--bf16"], "train --bf16 --epochs 1")
    epochs = _epoch_lines(out)
    counts = epochs[-1][4] if len(epochs) == 1 else {}
    with open(os.path.join(bexp, "hparams.json")) as f:
        hp = json.load(f)
    dtypes = (hp["frontend"].get("compute_dtype"),
              hp["model"].get("compute_dtype"))
    if (len(epochs) != 1 or not np.isfinite(epochs[0][1])
            or dtypes != ("bfloat16", "bfloat16")
            or counts.get("fwd_save_bf16") != steps
            or counts.get("bwd_bf16") != steps
            or counts.get("fwd_bf16", 0) < val_batches
            or any(counts.get(k) for k in ("fwd", "fwd_save", "bwd"))):
        raise AssertionError(f"train --bf16: epochs {epochs}, hparams "
                             f"compute dtypes {dtypes}")
    log(f"[cli] train --bf16: hparams.json compute_dtype {dtypes}; loss "
        f"{epochs[0][1]}; kernel launches {counts}")
    out, walls["evaluate (bf16)"] = _cli(
        "evaluate", ["--exp_dir", bexp, "--meta_dir", tmp, "--test_csv_name",
                     "test.csv"], "evaluate (the bf16 run)")
    ev_counts = re.findall(r"^kernels (\{.*\})$", out, re.M)
    ev_counts = json.loads(ev_counts[-1]) if ev_counts else {}
    with open(os.path.join(bexp, "results.txt")) as f:
        rows = f.read().splitlines()
    if ("compute dtype: frontend torch.bfloat16, model torch.bfloat16"
            not in out or len(rows) != 2 or not ev_counts.get("fwd_bf16")
            or any(ev_counts.get(k) for k in ("fwd", "fwd_save", "bwd"))):
        raise AssertionError(f"evaluate of the bf16 run: {rows}, "
                             f"{ev_counts}")
    log(f"[cli] evaluate (bf16 from hparams.json): {rows[1]}; kernel "
        f"launches {ev_counts}")

    # K = 4 steps per call: epoch 0 runs its one group eagerly and
    # captures, epoch 1 replays; the epoch line adds the replays' launches
    kexp = os.path.join(tmp, "exp_k4")
    out, walls["train --steps_per_call 4"] = _cli(
        "train", ["--cfg_file", cfg_file, "--expdir", kexp, "--num_workers",
                  "4", "--epochs", "2", "--steps_per_call", "4"],
        "train --steps_per_call 4 --epochs 2")
    epochs = _epoch_lines(out)
    counts = epochs[-1][4] if len(epochs) == 2 else {}
    if (len(epochs) != 2 or not all(np.isfinite(e[1]) for e in epochs)
            or counts.get("fwd_save") != 2 * steps
            or counts.get("bwd") != 2 * steps):
        raise AssertionError(f"train --steps_per_call 4: epochs {epochs}")
    log(f"[cli] train --steps_per_call 4: losses {[e[1] for e in epochs]}; "
        f"kernel launches {counts} (saving forward = backward = "
        f"{2 * steps} steps, replays included); train loop epoch 1 "
        f"{epochs[1][3]:.1f} clips/s (K=4, a replay) vs {k1_rate:.1f} "
        f"(K=1, the first run's epoch 1)")

    # the speechcommands ResNet-18 recipe: one epoch, then evaluate
    rexp = os.path.join(tmp, "exp_resnet18")
    out, walls["train resnet-18"] = _cli(
        "train", ["--cfg_file", os.path.join(tmp, "resnet18.cfg"),
                  "--expdir", rexp, "--num_workers", "4", "--epochs", "1"],
        "train resnet-18 --epochs 1")
    repochs = _epoch_lines(out)
    counts = repochs[-1][4] if len(repochs) == 1 else {}
    if (len(repochs) != 1 or not np.isfinite(repochs[0][1])
            or counts.get("fwd_save") != steps or counts.get("bwd") != steps
            or counts.get("fwd", 0) < val_batches):
        raise AssertionError(f"train resnet-18: epochs {repochs}")
    log(f"[cli] train resnet-18: loss {repochs[0][1]}; kernel launches "
        f"{counts} (saving forward = backward = {steps} steps); train loop "
        f"{repochs[0][3]:.1f} clips/s")
    out, walls["evaluate resnet-18"] = _cli(
        "evaluate", ["--exp_dir", rexp, "--meta_dir", tmp, "--test_csv_name",
                     "test.csv"], "evaluate (the resnet-18 run)")
    with open(os.path.join(rexp, "results.txt")) as f:
        rows = f.read().splitlines()
    if (len(rows) != 2 or not rows[1].startswith("resnet,")
            or not 0.0 <= float(rows[1].split(",")[1]) <= 1.0):
        raise AssertionError(f"evaluate of the resnet-18 run: {rows}")
    log(f"[cli] evaluate (resnet-18): {rows[1]}")

    # the loader timers are e2e_gap's (python -m leaf_tpu_torch.scripts
    # .e2e_gap measures the float32 wire, the copies and the step too)
    loader = {(mem, w): e2e_gap.loader_rates(e2e_gap.build_loader(
        cfg["data"]["train"], cfg["data"]["labels"], TRAIN_B, "int16", mem,
        w, cfg["audio_config"]), 3)
        for mem, w in ((False, 1), (False, 4), (True, 4))}
    for (mem, w), rates in loader.items():
        log(f"[cli] train DataLoader alone (num_workers {w}, in_memory "
            f"{mem}, int16 wire, B={TRAIN_B}): " + ", ".join(
                f"epoch {i} {r:.0f} clips/s" for i, r in enumerate(rates))
            + f"; the step needs ~{STEP_DEVICE_CLIPS_PER_S} clips/s")
    log(f"[cli] load_audio alone, one thread, files in {tmp}: "
        f"{e2e_gap.decode_us(_train_files(cfg, 256)):.1f} us per clip")
    log("[cli] wall times: " + ", ".join(f"{k} {v:.1f} s"
                                         for k, v in walls.items()))
    return {"loop": [e[3] for e in epochs], "loader": loader, "walls": walls}


# ---------------------------------------------------------------- [packed]
# [cli]'s tone task packed into shards of 64 records; a batch is 4 shards
# (the packed cfgs' batch_size counts shards): B = 256 one-second clips.
PACKED_RECORDS, PACKED_SHARDS = 64, 4
PACKED_SEED = 8881   # train.py's default --random_seed


def _load_script(name: str):
    """A file of the repository's scripts/ as a module (the converter
    below imports numpy only)."""
    import importlib.util
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(here, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _check_packed_items(tmp: str, packed_dir: str) -> None:
    """Every record's bytes are its WAV file's; the packed val items equal
    the CSV dataset's items of the same files exactly."""
    from leaf_tpu_torch.data import PackedDataset, RawWaveformDataset
    from leaf_tpu_torch.data import msgpack_lite
    from leaf_tpu_torch.data.dataset import read_manifest
    n_records = 0
    for split in ("train", "val"):
        files = iter(read_manifest(os.path.join(tmp, f"{split}.csv"))["files"])
        shards = read_manifest(os.path.join(packed_dir,
                                            f"{split}_packed.csv"))["files"]
        for shard in shards:
            with open(shard, "rb") as f:
                records = msgpack_lite.unpackb(f.read())
            for rec in records:
                with open(next(files), "rb") as f:
                    if rec["audio"] != f.read():
                        raise AssertionError(f"{shard}: record bytes differ")
                n_records += 1
        if next(files, None) is not None:
            raise AssertionError(f"{split}: records missing from the shards")
    ac = {"sample_rate": 16000, "min_duration": 1}
    labels = os.path.join(tmp, "lbl_map.json")
    raw = RawWaveformDataset(os.path.join(tmp, "val.csv"), labels, ac,
                             mode="multiclass", is_val=True)
    packed = PackedDataset(os.path.join(packed_dir, "val_packed.csv"), labels,
                           ac, mode="multiclass", is_val=True)
    i = 0
    for s in range(len(packed)):
        for wave, label in zip(*packed[s]):
            rw, rl = raw[i]
            if (wave.dtype != rw.dtype or not np.array_equal(wave, rw)
                    or label != rl):
                raise AssertionError(f"packed val item {i} differs")
            i += 1
    if i != len(raw):
        raise AssertionError(f"{i} packed val items, {len(raw)} in the CSV")
    log(f"[packed] {n_records} records: bytes equal their WAV files; the "
        f"{i} packed val items equal RawWaveformDataset's exactly")


def _packed_cfg(tmp: str, packed_dir: str, pretrained: str) -> str:
    """The flagship cfg on the packed manifests, 4 shards per batch, with
    ``frontend.pretrained``; returns its path."""
    with open(os.path.join(tmp, "flagship.cfg")) as f:
        text = f.read()
    for old, new in (
            ("batch_size: 256", f"batch_size: {PACKED_SHARDS}"),
            ('train_manifest: "train.csv"',
             f'train_manifest: "{packed_dir}/train_packed.csv"'),
            ('val_manifest: "val.csv"',
             f'val_manifest: "{packed_dir}/val_packed.csv"'),
            ("    default_args: True\n",
             f'    default_args: True\n    pretrained: "{pretrained}"\n')):
        if text.count(old) != 1:
            raise AssertionError(f"flagship cfg: {old!r} not found once")
        text = text.replace(old, new)
    path = os.path.join(tmp, f"packed_{os.path.basename(pretrained)}.cfg")
    with open(path, "w") as f:
        f.write(text)
    return path


def _train_packed(cfg_file: str, expdir: str, want_features: dict,
                  tag: str) -> dict:
    """``leaf_tpu_torch.train`` with --use_packed_dataset, in this process
    (TF32 off, the kernels loaded); the model is read right after its
    frontend is loaded, before the optimizer exists and before step 0."""
    from leaf_tpu_torch import train
    from leaf_tpu_torch.models import Classifier
    from leaf_tpu_torch.training.config import get_config
    seen = {}
    real = train.apply_pretrained_frontend

    def spy(cfg, model):
        out = real(cfg, model)
        seen.update({k: v.detach().cpu().clone()
                     for k, v in model.state_dict().items()})
        seen["device"] = next(model.parameters()).device
        return out

    steps = CLI_TRAIN // (PACKED_RECORDS * PACKED_SHARDS)
    val_batches = -(-CLI_VAL // (PACKED_RECORDS * PACKED_SHARDS))
    train.apply_pretrained_frontend = spy
    _zero_counts()
    t0 = time.perf_counter()
    try:
        train.main(["--cfg_file", cfg_file, "--expdir", expdir, "--epochs",
                    "1", "--num_workers", "4", "--use_packed_dataset"])
    finally:
        train.apply_pretrained_frontend = real
    wall = time.perf_counter() - t0
    counts = _counts()
    fresh = Classifier(get_config(cfg_file), device=seen.pop("device"),
                       generator=torch.Generator().manual_seed(PACKED_SEED))
    fresh = {k: v.cpu() for k, v in fresh.state_dict().items()
             if k.startswith("model.")}
    feats = {k: v for k, v in seen.items() if k.startswith("features.")}
    with open(os.path.join(expdir, "epoch_000", "meta.json")) as f:
        meta = json.load(f)
    if (sorted(feats) != sorted(want_features)
            or not all(torch.equal(feats[k], want_features[k].cpu())
                       for k in feats)):
        raise AssertionError(f"{tag}: the loaded frontend differs")
    if (sorted(fresh) != sorted(k for k in seen if k.startswith("model."))
            or not all(torch.equal(seen[k], v) for k, v in fresh.items())):
        raise AssertionError(f"{tag}: the backbone is not the seed's init")
    if (counts["fwd_save"] != steps or counts["bwd"] != steps
            or counts["fwd"] < val_batches
            or any(counts[k] for k in counts if k.endswith("bf16"))
            or not np.isfinite(meta["tr_loss"])):
        raise AssertionError(f"{tag}: kernel launches {counts}, meta {meta}")
    log(f"[packed] {tag}: {len(feats)} frontend tensors equal the source's "
        f"exactly before step 0, the backbone the seed's init; 1 epoch of "
        f"{steps} steps at B={PACKED_SHARDS} shards x {PACKED_RECORDS}; "
        f"tr_loss {meta['tr_loss']}; kernel launches {counts} (saving "
        f"forward = backward = {steps} steps; primal forward >= "
        f"{val_batches} val batches); wall {wall:.1f} s")
    return counts


def phase_packed(tmp: str, cli: dict) -> None:
    """[cli]'s tone task as packed shards: pack it with the CLI, check the
    shards, and train the flagship on them from a pretrained frontend (the
    [cli] run's epoch_001 checkpoint, then a converted npz)."""
    packed_dir = os.path.join(tmp, "packed")
    for split in ("train", "val"):
        _cli("pack_dataset", [os.path.join(tmp, f"{split}.csv"), packed_dir,
                              "--records-per-shard", str(PACKED_RECORDS),
                              "--prefix", split],
             f"pack_dataset {split}.csv")
    _check_packed_items(tmp, packed_dir)

    ckpt = os.path.join(tmp, "exp", "epoch_001")
    weights = torch.load(os.path.join(ckpt, "state.pt"), map_location="cpu",
                         weights_only=True)["model"]
    want = {k: v for k, v in weights.items() if k.startswith("features.")}
    _train_packed(_packed_cfg(tmp, packed_dir, ckpt),
                  os.path.join(tmp, "exp_packed"), want,
                  "train --use_packed_dataset, frontend.pretrained = "
                  "epoch_001")

    # the same from the converter's npz (scripts/convert_torch_checkpoint.py
    # imports numpy only), the checkpoint's frontend moved off its values
    convert = _load_script("convert_torch_checkpoint")
    moved = {k: v * 1.01 for k, v in want.items()}
    flat = convert.convert_frontend_state_dict(moved)
    npz_dir = os.path.join(tmp, "npz")
    os.makedirs(npz_dir)
    np.savez(os.path.join(npz_dir, "frontend_params.npz"), **flat)
    _train_packed(_packed_cfg(tmp, packed_dir, npz_dir),
                  os.path.join(tmp, "exp_packed_npz"), moved,
                  "train --use_packed_dataset, frontend.pretrained = npz")

    from leaf_tpu_torch.data import (PackedDataset, leaf_host_crop_transforms,
                                     setup_dataloaders)
    ds = PackedDataset(os.path.join(packed_dir, "train_packed.csv"),
                       os.path.join(tmp, "lbl_map.json"),
                       {"sample_rate": 16000, "min_duration": 1},
                       mode="multiclass",
                       transform=leaf_host_crop_transforms(True, 16000))
    loader, _ = setup_dataloaders(ds, None, PACKED_SHARDS, target_len=16000,
                                  num_workers=4, need_val=False, packed=True)
    rates = e2e_gap.loader_rates(loader, 3)
    csv_rates = cli["loader"][(False, 4)]
    log(f"[packed] train DataLoader alone (num_workers 4, B={PACKED_SHARDS} "
        f"shards x {PACKED_RECORDS}, float32 wire): " + ", ".join(
            f"epoch {i} {r:.0f} clips/s" for i, r in enumerate(rates))
        + "; the CSV/WAV loader ([cli], num_workers 4, int16 wire): "
        + ", ".join(f"epoch {i} {r:.0f}" for i, r in enumerate(csv_rates)))


# ------------------------------------------------------------- [converge]
# Two rows of CONVERGENCE.md through the port's harness at its defaults
# (2560 train clips, 320 val and 320 test, B=256, bf16): (arch, epochs,
# --bn_recalibrate). The flagship's short horizon is scored after BN
# recalibration (its raw val accuracy lags with the 0.99 EMA and is only
# logged); ResNet-18's BN (momentum 0.9) needs none. The rows run side by
# side, beside [dp-cli], which times nothing: each is a process with its
# own launch counts, and the script's hosts vary ~2× in speed, so in turn
# they would take [done] to the 1200 s limit.
CONVERGE_ROWS = (("efficientnet:b0", 40, 400), ("resnet:18", 40, 0))
CONVERGE_CLIPS, CONVERGE_B = 2560, 256
CONVERGE_BAR = 0.95       # scripts/synthetic_convergence.py's bar
CONVERGE_TIMEOUT = 600    # seconds for both rows, data and evaluation included


def converge_start(tmp: str) -> list:
    """Start ``python -m leaf_tpu_torch.synthetic_convergence`` for each row
    of CONVERGE_ROWS, each in a --root of its own, output to a file;
    returns [(row, process, output path)]."""
    runs = []
    try:
        for arch, epochs, recal in CONVERGE_ROWS:
            name = arch.replace(":", "")
            path = os.path.join(tmp, f"{name}.log")
            with open(path, "w") as out:
                proc = _spawn("synthetic_convergence", [
                    "--arch", arch, "--epochs", str(epochs), "--root",
                    os.path.join(tmp, name), "--bn_recalibrate", str(recal)],
                    stdout=out)
            runs.append(((arch, epochs, recal), proc, path))
    except BaseException:
        for _, proc, _ in runs:
            _stop(proc)
        raise
    return runs


def converge_finish(runs: list, deadline: float) -> None:
    """Wait for the rows (killed at ``deadline``, perf_counter time); each
    reaches test accuracy CONVERGE_BAR, and its train run launched the
    bf16 saving forward and backward once per step, a bf16 primal forward
    per val batch, and no f32 kernel."""
    try:
        for (arch, epochs, recal), proc, path in runs:
            tag = (f"synthetic_convergence --arch {arch} --epochs {epochs} "
                   f"--bn_recalibrate {recal}")
            try:
                proc.wait(timeout=max(0.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"{tag}: not done in "
                                     f"{CONVERGE_TIMEOUT} s")
            with open(path) as f:
                out = f.read()
            for ln in out.splitlines():
                log(f"[converge]   {ln}")
            log(f"[converge] {tag}: exit {proc.returncode}")
            if proc.returncode != 0:
                raise AssertionError(f"{tag} exited {proc.returncode}")
            line = json.loads([ln for ln in out.splitlines()
                               if ln.startswith('{"metric"')][-1])
            k, steps = line["kernels"], epochs * (CONVERGE_CLIPS // CONVERGE_B)
            log(f"[converge] {arch}, {epochs} epochs ({steps} steps at "
                f"B={CONVERGE_B}, bf16): test accuracy {line['value']} (bar "
                f"{CONVERGE_BAR}; BN recalibrated on {recal} batches), raw "
                f"final val accuracy {line['final_val_metric']}, train wall "
                f"{line['train_wall_s']} s, kernels {json.dumps(k)}")
            if (k["fwd_save_bf16"] != steps or k["bwd_bf16"] != steps
                    or k["fwd_bf16"] < epochs
                    or k["fwd"] or k["fwd_save"] or k["bwd"]):
                raise AssertionError(f"{tag}: launches {k}, {steps} steps")
            if not line["value"] >= CONVERGE_BAR:
                raise AssertionError(f"{tag}: test accuracy {line['value']} "
                                     f"< {CONVERGE_BAR}")
    finally:
        for _, proc, _ in runs:
            _stop(proc)


def _fields(r: dict) -> dict:
    """A kernel's timing fields of the ``kernels`` line."""
    return {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms")}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()

    def timed(phase, fn, *args, **kw):
        start = time.perf_counter()
        out = fn(*args, **kw)
        log(f"[{phase}] phase took {time.perf_counter() - start:.1f} s")
        return out

    timed("build", phase_build)
    max_abs_err = timed("parity", phase_parity, device)
    fwd_save_err, bwd_err = timed("parity-train", phase_parity_train, device)
    bf16_err = timed("parity-bf16", phase_parity_bf16, device)
    timed("smoke-leaf", phase_smoke_leaf, device)
    launches, server, state = timed("serving", phase_serving, device)
    bf16_launches, server_bf16 = timed("serving-bf16", phase_serving_bf16,
                                       device)
    train_counts = timed("train", phase_train, device, state)
    bf16_counts = timed("train-bf16", phase_train, device, state, bf16=True)
    timed("train-parity", phase_train_parity, device, state)
    timed("trajectory", phase_trajectory, device, state)
    timing = timed("timing", phase_timings, device,
                   {"f32": server, "bf16": server_bf16})
    timed("timing-audioset", phase_timing_audioset, device)
    timed("train-timing", phase_train_timing, device, state)
    del server, server_bf16
    torch.cuda.empty_cache()
    leaf = timed("stream", phase_stream, device)
    with tempfile.TemporaryDirectory(prefix="leaf_export_") as tmp:
        timed("export", phase_export, device, state, leaf, tmp)
    del leaf
    multistep = timed("multistep", phase_multistep, device, state)
    timed("dp", phase_dp, device, state, multistep)
    del state
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="leaf_zoo_") as tmp:
        r18_state = timed("zoo-serving", phase_zoo_serving, device, tmp)
    timed("zoo-train", phase_zoo_train, device, r18_state)
    del r18_state
    torch.cuda.empty_cache()
    timed("zoo-audioset", phase_zoo_audioset, device)
    timed("zoo-rest", phase_zoo_rest, device)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="leaf_cli_") as tmp:
        cli = timed("cli", phase_cli, tmp)
        timed("packed", phase_packed, tmp, cli)
        with tempfile.TemporaryDirectory(prefix="leaf_converge_") as ctmp:
            start = time.perf_counter()
            runs = converge_start(ctmp)
            try:
                timed("dp-cli", phase_dp_cli, tmp)
            except BaseException:
                for _, proc, _ in runs:
                    _stop(proc)
                raise
            converge_finish(runs, start + CONVERGE_TIMEOUT)
            log(f"[converge] phase took {time.perf_counter() - start:.1f} s "
                f"(beside [dp-cli])")

    smi = _measure.smi_line()
    if smi is None:
        raise AssertionError("nvidia-smi did not report the card")
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    log(smi)
    src = "leaf_tpu_torch/ops/csrc/"
    log(json.dumps({"kernels": [
        {"name": "fused_gabor_sqmod_lowpass_fwd", "route": "cuda",
         "source": src + "fused_frontend.cu",
         "replaces": "leaf_tpu/ops/fused_frontend.py:325",
         "launches": launches, "max_abs_err": max_abs_err,
         **_fields(timing["fwd"])},
        {"name": "fused_gabor_sqmod_lowpass_fwd_saving", "route": "cuda",
         "source": src + "fused_frontend.cu",
         "replaces": "leaf_tpu/ops/fused_frontend.py:336",
         "launches": train_counts["fwd_save"], "max_abs_err": fwd_save_err,
         **_fields(timing["fwd_save"])},
        {"name": "fused_gabor_sqmod_lowpass_bwd", "route": "cuda",
         "source": src + "fused_frontend_bwd.cu",
         "replaces": "leaf_tpu/ops/fused_frontend.py:422",
         "launches": train_counts["bwd"], "max_abs_err": bwd_err,
         **_fields(timing["bwd"])},
        {"name": "fused_gabor_sqmod_lowpass_fwd_bf16", "route": "cuda",
         "source": src + "fused_frontend_bf16.cu",
         "replaces": "leaf_tpu/ops/fused_frontend.py:325",
         "launches": bf16_launches, "max_abs_err": bf16_err["fwd"],
         **_fields(timing["fwd_bf16"])},
        {"name": "fused_gabor_sqmod_lowpass_fwd_saving_bf16", "route": "cuda",
         "source": src + "fused_frontend_bf16.cu",
         "replaces": "leaf_tpu/ops/fused_frontend.py:336",
         "launches": bf16_counts["fwd_save_bf16"],
         "max_abs_err": bf16_err["fwd_save"], **_fields(timing["fwd_save_bf16"])},
        {"name": "fused_gabor_sqmod_lowpass_bwd_bf16", "route": "cuda",
         "source": src + "fused_frontend_bwd_bf16.cu",
         "replaces": "leaf_tpu/ops/fused_frontend.py:422",
         "launches": bf16_counts["bwd_bf16"], "max_abs_err": bf16_err["bwd"],
         **_fields(timing["bwd_bf16"])},
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
