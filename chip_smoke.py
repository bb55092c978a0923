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
                  at B=128, T=80000, F=64 (``[timing-audioset]``);
                  serving latency per bucket, f32 and bf16; the train step
                  fused, 'off' and bf16, with a torch.profiler split
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
                  profiler, host ms per step at K = 1 (eager), 4 and 8
                  (graph) with device-busy time, idle share and pool size
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
12. report       — card name and power limit, the ``kernels`` JSON line (six
                  kernels: f32 and bf16), and the last line
                  ``{"ok": true, "device": {...}}``

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

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
# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W)
F32_PEAK_FLOPS = 67e12
TF32_PEAK_FLOPS = 494.7e12  # tensor cores
BF16_PEAK_FLOPS = 989e12    # tensor cores
HBM_BYTES_PER_S = 3.35e12


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


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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


def leaf_operands(device, n_filters: int = PARITY_F):
    """(bank, windows) of a Leaf of ``n_filters`` (the flagship's 40 by
    default) at its mel init, on ``device``."""
    from leaf_tpu_torch.frontend import Leaf
    leaf = Leaf(n_filters=n_filters, device=device)
    with torch.no_grad():
        bank = leaf._complex_conv.emit_filters().contiguous()
        windows = leaf._pooling.emit_windows()[0].contiguous()
    return bank, windows


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


def _trainer(cfg, state, device, augment: bool, steps_per_epoch: int,
             epochs: int, capturable: bool = False):
    """(TrainState, train step) for ``cfg`` from the weights ``state``;
    the step's loss is the cfg's ``model.type`` (multiclass unless
    named)."""
    from leaf_tpu_torch.data import leaf_device_augment
    from leaf_tpu_torch.models import Classifier
    from leaf_tpu_torch.training import (TrainState, make_train_step,
                                         optimization_helper)
    clf = Classifier(cfg, device=device)
    clf.load_state_dict(state)
    opt, sched, _, _ = optimization_helper(
        cfg, clf.parameters(), num_tr_steps_per_epoch=steps_per_epoch,
        num_epochs=epochs, capturable=capturable)
    return (TrainState(clf, opt, sched),
            make_train_step(cfg["model"].get("type", "multiclass"),
                            augment_fn=leaf_device_augment if augment
                            else None))


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
    st, step = _trainer(cfg, state, device, True, STEPS_PER_EPOCH, EPOCHS)
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


def _compare_runs(tag: str, a, b, p0: dict, losses_a, losses_b) -> None:
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
    ok = (loss_rel <= LOSS_TOL and upd <= UPDATE_TOL
          and len(front) == 7 and front[worst] <= FRONTEND_TOL
          and max(mean_err, var_err) <= STATS_TOL)
    log(f"[train] {tag}: losses {', '.join(f'{v:.6f}' for v in losses_a)} "
        f"vs {', '.join(f'{v:.6f}' for v in losses_b)} (max rel "
        f"{loss_rel:.3e}, tol {LOSS_TOL:g}); update rel-norm {upd:.3e} (tol "
        f"{UPDATE_TOL:g}); worst of {len(front)} frontend leaves {worst} "
        f"{front[worst]:.3e} (tol {FRONTEND_TOL:g}); BN stats mean/sd "
        f"{mean_err:.3e}, var/var {var_err:.3e} (tol {STATS_TOL:g}) -> "
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
            st, step = _trainer(cfg, state, dev, False, 2, 10)
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
        st, step = _trainer(cfg, state, device, False, TRAJ_WARMUP,
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


def _is_device_work(event) -> bool:
    """A kernel or copy on the card; not a user annotation (such as
    ``Optimizer.step#Adam.step``), whose span covers kernels already
    counted."""
    from torch.autograd import DeviceType
    return (event.device_type == DeviceType.CUDA
            and not getattr(event, "is_user_annotation", False))


def profile_requests(server, req, latency_ms: float, tag: str,
                     n: int = 5) -> None:
    """Device time per request by kernel (torch.profiler), and the share of
    the unprofiled median latency the device sits idle."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            server(req)
    kernels = sorted(((e.self_device_time_total / 1e3 / n, e.count // n, e.key)
                      for e in prof.key_averages() if _is_device_work(e)),
                     reverse=True)
    busy = sum(k[0] for k in kernels)
    if not busy:
        log("[profile] no device time in the trace: not measured")
        return
    launches = sum(k[1] for k in kernels)
    fused = sum(k[0] for k in kernels if "fused_fwd" in k[2])
    log(f"[profile] {tag}: device busy {busy:.3f} ms per request "
        f"({launches} kernels), idle {1 - busy / latency_ms:.1%} of the "
        f"{latency_ms:.3f} ms median; fused frontend kernel {fused:.3f} ms "
        f"({fused / busy:.1%} of device time)")
    for ms, count, name in kernels[:5]:
        log(f"[profile]   {ms:.3f} ms  x{count}  {name[:90]}")


def _bound(flops: float, nbytes: float, tc_flops: float = 0.0,
           tc_peak: float = TF32_PEAK_FLOPS) -> dict:
    """Least time for ``flops`` f32 operations on the CUDA cores plus
    ``tc_flops`` tensor-core operations at ``tc_peak`` (TF32 unless
    named), or for ``nbytes``."""
    flop_ms = (flops / F32_PEAK_FLOPS + tc_flops / tc_peak) * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(flop_ms, byte_ms),
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes"}


def _kernel_timings(device, b: int, t: int, f: int, iters: int = 20,
                    tag: str = "[timing]") -> dict:
    """Each kernel (f32 and bf16), its plain version and the cuDNN
    composition at (B, T, F) = (b, t, f), CUDA events over ``iters``
    launches, with the kernel's bound at that shape (``_bound``)."""
    import torch.nn.functional as F

    from leaf_tpu_torch.ops.fused_frontend import (
        fused_backward_bf16_cuda, fused_backward_cuda,
        fused_backward_reference, fused_forward_bf16_cuda,
        fused_forward_cuda, fused_forward_saving_bf16_cuda,
        fused_forward_saving_cuda, fused_forward_saving_reference,
        fused_reference, lowpass_frames_out)
    bank, windows = leaf_operands(device, f)
    rng = np.random.RandomState(2)
    x = torch.from_numpy((rng.randn(b, t) * 0.1).astype(np.float32)).to(device)
    n_frames = lowpass_frames_out(t, 160, 401, (200, 200))
    d_out = torch.from_numpy(
        rng.randn(b, n_frames, f).astype(np.float32)).to(device)
    weight = bank.T[:, None, :].contiguous()
    win = windows[:, None, :].contiguous()

    def timed(fn):
        return cuda_time_ms(fn, iters=iters, warmup=min(3, iters))

    def library(w=weight, wn=win):  # cuDNN: conv1d → |·|² → grouped strided conv1d
        out = F.conv1d(x[:, None, :], w, padding=200)
        s = out[:, :f] ** 2 + out[:, f:] ** 2
        return F.conv1d(s, wn, stride=160, padding=200, groups=f)

    # S positions each frame's window covers inside [0, T): the work of dS
    # and of d_windows depends on it
    covered = sum(min(160 * fr + 201, t) - max(160 * fr - 200, 0)
                  for fr in range(n_frames))
    conv_flops = 2 * b * t * 2 * f * 401
    fwd_flops = conv_flops + 3 * b * t * f + 2 * b * n_frames * f * 401
    in_bytes = 4 * (b * t + 401 * 2 * f + f * 401)
    out_bytes = 4 * b * n_frames * f
    conv_bytes = 4 * b * 2 * f * t
    results = {}

    # each kernel's own bound: the conv correlation three times (3×TF32)
    # on the tensor cores, the rest on the CUDA cores; the f32-FMA bound
    # that any CUDA-core design has is logged beside it
    fwd_bytes = in_bytes + out_bytes
    ms = timed(lambda: fused_forward_cuda(x, bank, windows))
    results["fwd"] = {"ms": ms,
                      "plain_ms": timed(
                          lambda: fused_reference(x, bank, windows)),
                      "library_ms": timed(library),
                      **_bound(fwd_flops - conv_flops, fwd_bytes,
                               3 * conv_flops)}
    results["fwd_save"] = {
        "ms": timed(lambda: fused_forward_saving_cuda(x, bank, windows)),
        "plain_ms": timed(
            lambda: fused_forward_saving_reference(x, bank, windows)),
        # the composition computes OUT (its conv1d output) on the way
        "library_ms": results["fwd"]["library_ms"],
        **_bound(fwd_flops - conv_flops, fwd_bytes + conv_bytes,
                 3 * conv_flops)}
    _, conv = fused_forward_saving_cuda(x, bank, windows)
    wr = weight.clone().requires_grad_()
    wnr = win.clone().requires_grad_()
    lib_out = library(wr, wnr)
    bwd_flops = conv_flops + 7 * b * t * f + 2 * 2 * b * f * covered
    bwd_bytes = (in_bytes + conv_bytes + out_bytes
                 + 4 * (401 * 2 * f + f * 401))
    results["bwd"] = {
        "ms": timed(lambda: fused_backward_cuda(x, conv, windows,
                                                       d_out)),
        "plain_ms": timed(
            lambda: fused_backward_reference(x, conv, windows, d_out)),
        "library_ms": timed(lambda: torch.autograd.grad(
            lib_out, (wr, wnr), d_out.transpose(1, 2), retain_graph=True)),
        **_bound(bwd_flops - conv_flops, bwd_bytes, 3 * conv_flops)}
    del conv, lib_out

    # bf16: x, the bank and OUT in bf16 (2 bytes), the windows, out, dY and
    # d_windows in f32; the conv correlation once on the tensor cores at
    # the bf16 rate. The library is the same cuDNN composition in bf16
    # (conv1d → square → grouped strided conv1d), which rounds the conv
    # output and S to bf16 where the kernels keep them in f32: not the
    # same rounding, the same work.
    xb, bankb = x.bfloat16(), bank.bfloat16()
    weightb, winb = weight.bfloat16(), win.bfloat16()

    def library_bf16(w=weightb, wn=winb):
        out = F.conv1d(xb[:, None, :], w, padding=200)
        s = out[:, :f] ** 2 + out[:, f:] ** 2
        return F.conv1d(s, wn, stride=160, padding=200, groups=f)

    in_b16 = 2 * (b * t + 401 * 2 * f) + 4 * f * 401
    conv_b16 = 2 * b * 2 * f * t
    fwd_b16 = in_b16 + out_bytes
    results["fwd_bf16"] = {
        "ms": timed(lambda: fused_forward_bf16_cuda(xb, bankb,
                                                           windows)),
        "plain_ms": timed(
            lambda: fused_reference(xb, bankb, windows)),
        "library_ms": timed(library_bf16),
        **_bound(fwd_flops - conv_flops, fwd_b16, conv_flops,
                 BF16_PEAK_FLOPS)}
    results["fwd_save_bf16"] = {
        "ms": timed(lambda: fused_forward_saving_bf16_cuda(
            xb, bankb, windows)),
        "plain_ms": timed(
            lambda: fused_forward_saving_reference(xb, bankb, windows)),
        "library_ms": results["fwd_bf16"]["library_ms"],
        **_bound(fwd_flops - conv_flops, fwd_b16 + conv_b16, conv_flops,
                 BF16_PEAK_FLOPS)}
    _, conv = fused_forward_saving_bf16_cuda(xb, bankb, windows)
    wr = weightb.clone().requires_grad_()
    wnr = winb.clone().requires_grad_()
    lib_out = library_bf16(wr, wnr)
    d_out_b = d_out.bfloat16().transpose(1, 2)
    results["bwd_bf16"] = {
        "ms": timed(lambda: fused_backward_bf16_cuda(
            xb, conv, windows, d_out)),
        "plain_ms": timed(
            lambda: fused_backward_reference(xb, conv, windows, d_out)),
        "library_ms": timed(lambda: torch.autograd.grad(
            lib_out, (wr, wnr), d_out_b, retain_graph=True)),
        **_bound(bwd_flops - conv_flops,
                 in_b16 + conv_b16 + out_bytes + 2 * 401 * 2 * f
                 + 4 * f * 401, conv_flops, BF16_PEAK_FLOPS)}
    del conv, lib_out, xb, x, d_out
    torch.cuda.empty_cache()
    for name, r in results.items():
        dtype = "bf16" if name.endswith("_bf16") else "f32"
        log(f"{tag} {name} kernel B={b} T={t} F={f} {dtype}: "
            f"{r['ms']:.4f} ms ({r['bound_ms'] / r['ms']:.1%} of the "
            f"{r['bound_by']} bound {r['bound_ms']:.4f} ms); plain version "
            f"{r['plain_ms']:.4f} ms; cuDNN composition (library) "
            f"{r['library_ms']:.4f} ms ({iters} launches each)")
    # each f32 kernel against both bounds: its conv correlation in f32 on
    # the CUDA cores, or three times (3×TF32) on the tensor cores
    fma_bounds = {"fwd": _bound(fwd_flops, fwd_bytes),
                  "fwd_save": _bound(fwd_flops, fwd_bytes + conv_bytes),
                  "bwd": _bound(bwd_flops, bwd_bytes)}
    for name, r in results.items():
        if name not in fma_bounds:
            continue
        ms, tc_ms = r["ms"], r["bound_ms"]
        fma_ms = fma_bounds[name]["bound_ms"]
        log(f"{tag} {name} bounds: f32 FMA {fma_ms:.4f} ms "
            f"({fma_ms / ms:.1%} of the kernel's time), 3×TF32 tensor cores "
            f"{tc_ms:.4f} ms ({tc_ms / ms:.1%})")
    return results


def phase_timing_audioset(device):
    """The six kernels, their plain versions and the cuDNN composition at
    the AudioSet ResNet-18 cfg's shape (B=128, T=80000, F=64)."""
    _kernel_timings(device, AUDIOSET_B, AUDIOSET_T, AUDIOSET_F, iters=5,
                    tag="[timing-audioset]")


def phase_timings(device, servers):
    results = _kernel_timings(device, 256, 16000, PARITY_F)
    rng = np.random.RandomState(2)
    for dtype, server in servers.items():
        for bucket in BUCKETS:
            req = (rng.randn(bucket, 16000) * 0.1).astype(np.float32)
            for _ in range(3):
                server(req)
            lat = []
            for _ in range(20):
                t0 = time.perf_counter()
                server(req)  # returns host numpy: ends in a device sync
                lat.append((time.perf_counter() - t0) * 1e3)
            log(f"[timing] serving {dtype} bucket {bucket}: median "
                f"{np.median(lat):.3f} ms, p90 {np.percentile(lat, 90):.3f} "
                f"ms per request of {bucket} clips (host clock, 20 "
                f"requests)")
            profile_requests(server, req, float(np.median(lat)),
                             f"{dtype} bucket {bucket}")
    return results


def phase_train_timing(device, state):
    """Train step time, fused vs 'off', and a profiler split of one step."""
    from torch.profiler import ProfilerActivity, profile

    off_cfg = {**TRAIN_CFG, "frontend": {**TRAIN_CFG["frontend"],
                                         "use_fused_kernel": "off"}}
    x, y = _batch(np.random.RandomState(7), TRAIN_B, device)
    medians = {}
    for tag, cfg in (("fused", TRAIN_CFG), ("off", off_cfg),
                     ("bf16", _bf16(TRAIN_CFG))):
        st, step = _trainer(cfg, state, device, True, STEPS_PER_EPOCH, EPOCHS)
        gen = torch.Generator(device=device).manual_seed(8)
        for _ in range(3):
            step(st, x, y, gen)
        times = []
        for _ in range(TIMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(st, x, y, gen)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        medians[tag] = float(np.median(times))
        log(f"[timing] train step B={TRAIN_B} {tag}: median "
            f"{medians[tag]:.3f} ms/step ({TRAIN_B / medians[tag] * 1e3:.1f} "
            f"clips/s), min {min(times):.3f}, max {max(times):.3f} "
            f"({TIMED_STEPS} steps after 3 warm-up, host clock, TF32 off)")
        if tag == "off":
            continue
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(st, x, y, gen)
            torch.cuda.synchronize()
        kernels = [(e.self_device_time_total / 1e3, e.key)
                   for e in prof.key_averages() if _is_device_work(e)]
        busy = sum(k[0] for k in kernels)
        if not busy:
            log("[profile] train step: no device time in the trace: not "
                "measured")
            continue
        front = sum(ms for ms, k in kernels
                    if "fused_fwd" in k or "fused_bwd" in k)
        log(f"[profile] train step ({tag}): device busy {busy:.3f} ms of the "
            f"{medians[tag]:.3f} ms median (idle {1 - busy / medians[tag]:.1%}); "
            f"frontend kernels {front:.3f} ms ({front / busy:.1%} of busy), "
            f"everything else (backbone, optimizer, PCEN, augment, loss) "
            f"{busy - front:.3f} ms")
        for ms, name in sorted(kernels, reverse=True)[:8]:
            log(f"[profile]   {ms:.3f} ms  {name[:90]}")
    return medians


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


def _stream(streamer, wave, chunk: int, sync_times=None):
    """Stream ``wave`` (B, T) in chunks, the remainder to ``flush``;
    returns the frames (numpy). With ``sync_times`` (a list) each
    process() call's host-clock ms, synchronised, is appended."""
    n = wave.shape[1] // chunk
    outs = []
    for i in range(n):
        t0 = time.perf_counter()
        outs.append(streamer.process(wave[:, i * chunk:(i + 1) * chunk]))
        if sync_times is not None:
            torch.cuda.synchronize()
            sync_times.append((time.perf_counter() - t0) * 1e3)
    rem = wave[:, n * chunk:]
    outs.append(streamer.flush(rem if rem.shape[1] else None))
    return torch.cat(outs, dim=1).float().cpu().numpy()


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
        got = _stream(LeafStreamer(leaf, STREAM_CHUNK), wave, STREAM_CHUNK,
                      latencies if name == "1 s" else None)
        with torch.no_grad():
            ref, fused = off(x).cpu().numpy(), leaf(x).cpu().numpy()
            ref_b = off_b(x).cpu().numpy()
        got_b = _stream(LeafStreamer(off_b, STREAM_CHUNK), wave,
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


def _latency(server, req, n: int = 20) -> float:
    for _ in range(3):
        server(req)
    lat = []
    for _ in range(n):
        t0 = time.perf_counter()
        server(req)  # returns host numpy: ends in a device sync
        lat.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(lat))


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
        for bucket in BUCKETS:
            req = (rng.randn(bucket, 16000) * 0.1).astype(np.float32)
            lat = {}
            for name, server in (("artifact", art), ("live", live),
                                 ("live ", live), ("artifact ", art)):
                lat.setdefault(name.strip(), []).append(_latency(server, req))
            log(f"[export] {dtype} bucket {bucket}: median latency artifact "
                f"{' / '.join(f'{v:.3f}' for v in lat['artifact'])} ms, live "
                f"{' / '.join(f'{v:.3f}' for v in lat['live'])} ms (host "
                f"clock, 20 requests each, artifact-live-live-artifact)")
            for name, server in (("artifact", art), ("live", live)):
                profile_requests(server, req, float(np.mean(lat[name])),
                                 f"{name} {dtype} bucket {bucket}")
        del art, live
    out = os.path.join(tmp, "serving_stream")
    save_exported_streaming(out, leaf, STREAM_CHUNK, STREAM_N)
    served = StreamingServingModel.load(out, device=device)
    wave = (rng.randn(STREAM_N, 16000) * 0.1).astype(np.float32)
    lat_art, lat_live = [], []
    a = _stream(served, wave, STREAM_CHUNK, lat_art)
    b = _stream(LeafStreamer(leaf, STREAM_CHUNK), wave, STREAM_CHUNK,
                lat_live)
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


def _profiled(fn) -> tuple:
    """(device-busy ms, kernel launches by KERNEL_SYMBOLS name, the fused
    frontend kernels' device ms) of one ``fn()`` under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if _is_device_work(e)]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    seen = {name: sum(e.count for e in events if sym in e.key)
            for name, sym in KERNEL_SYMBOLS.items()}
    front = sum(e.self_device_time_total for e in events
                if "fused_fwd" in e.key or "fused_bwd" in e.key) / 1e3
    return busy, seen, front


def _stacked(rng, k: int, device):
    xs = torch.from_numpy((rng.randn(k, TRAIN_B, 16000) * 0.1)
                          .astype(np.float32)).to(device)
    ys = torch.from_numpy(rng.randint(0, 35, (k, TRAIN_B))).to(device)
    return xs, ys


def _twin(cfg, st, gen, device):
    """A second train state with copies of ``st``'s weights, buffers,
    optimizer and schedule, and a generator at ``gen``'s state."""
    import copy

    from leaf_tpu_torch.training import TrainState
    twin, step = _trainer(cfg, st.model.state_dict(), device, True,
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
    and host ms per step at K = 1 (eager), 4 and 8 (graph)."""
    results = {}
    for dtype, cfg, sfx in (("f32", TRAIN_CFG, ""),
                            ("bf16", _bf16(TRAIN_CFG), "_bf16")):
        tag = f"[multistep] {dtype}"
        results[dtype] = {"per_replay": _multistep_check(device, state, cfg,
                                                         sfx, tag)}
        torch.cuda.empty_cache()
        results[dtype]["timing"] = _multistep_timing(device, state, cfg, tag)
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
    st, _ = _trainer(cfg, state, device, True, STEPS_PER_EPOCH, EPOCHS,
                     capturable=True)
    gen = torch.Generator(device=device).manual_seed(16)
    multi = make_train_multistep(k, augment_fn=leaf_device_augment)
    groups = [_stacked(rng, k, device) for _ in range(3)]
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
    busy, seen, _ = _profiled(lambda: multi(st, *groups[2], gen))
    log(f"{tag}: profiler, one replay: {seen} kernel launches, device "
        f"busy {busy:.3f} ms")
    if {name: v for name, v in seen.items() if v} != want:
        raise AssertionError(f"{tag}: the profiler saw {seen}, want "
                             f"{want} per replay")
    return multi.per_replay


def _multistep_timing(device, state, cfg, tag: str, ks=(1, 4, 8)) -> dict:
    """Host-clock ms per step, device-busy ms per step, the idle share and
    the fused frontend kernels' share of the device time at K = 1 (eager
    make_train_step) and the other ``ks`` (graph)."""
    from leaf_tpu_torch.data import leaf_device_augment
    from leaf_tpu_torch.training import make_train_multistep
    out = {}
    for k in ks:
        st, step = _trainer(cfg, state, device, True, STEPS_PER_EPOCH,
                            EPOCHS, capturable=k > 1)
        gen = torch.Generator(device=device).manual_seed(17)
        xs, ys = _stacked(np.random.RandomState(17), k, device)
        if k == 1:
            def call(st=st, step=step, gen=gen, xs=xs, ys=ys):
                step(st, xs[0], ys[0], gen)
            pool = 0
        else:
            multi = make_train_multistep(k, augment_fn=leaf_device_augment)

            def call(st=st, multi=multi, gen=gen, xs=xs, ys=ys):
                multi(st, xs, ys, gen)
        for _ in range(3):
            call()
        pool = 0 if k == 1 else multi.pool_bytes
        times = []
        for _ in range(TIMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3 / k)
        busy, _, front = _profiled(call)
        med = float(np.median(times))
        out[k] = {"ms": med, "busy_ms": busy / k, "pool_bytes": pool,
                  "frontend_ms": front / k}
        log(f"{tag} timing K={k} ({'eager' if k == 1 else 'graph'}): "
            f"median {med:.3f} ms/step ({TRAIN_B / med * 1e3:.1f} clips/s), "
            f"min {min(times):.3f}, max {max(times):.3f} ({TIMED_STEPS} "
            f"calls after 3, host clock); device busy {busy / k:.3f} "
            f"ms/step, idle {1 - busy / k / med:.1%}; frontend kernels "
            f"{front / k:.3f} ms/step ({front / busy:.1%} of busy); graph "
            f"pool {pool / 2**30:.2f} GiB")
        del st, step, call
        if k > 1:
            del multi
        torch.cuda.empty_cache()
    return out


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
    for bucket in BUCKETS:
        req = (rng.randn(bucket, 16000) * 0.1).astype(np.float32)
        lat = {}
        for name, server in (("artifact", art), ("live", live),
                             ("live ", live), ("artifact ", art)):
            lat.setdefault(name.strip(), []).append(_latency(server, req))
        log(f"[zoo] resnet-18 f32 bucket {bucket}: median latency artifact "
            f"{' / '.join(f'{v:.3f}' for v in lat['artifact'])} ms, live "
            f"{' / '.join(f'{v:.3f}' for v in lat['live'])} ms (host clock, "
            f"20 requests each, artifact-live-live-artifact)")
        for name, server in (("artifact", art), ("live", live)):
            profile_requests(server, req, float(np.mean(lat[name])),
                             f"resnet-18 {name} f32 bucket {bucket}")
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
        st, step = _trainer(run_cfg, state, device, True, STEPS_PER_EPOCH,
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
    timing = {dtype: _multistep_timing(device, state, run_cfg,
                                       f"[zoo] resnet-18 {dtype}", ks=(1, 4))
              for dtype, run_cfg in (("f32", cfg), ("bf16", _bf16(cfg)))}
    _profile_step("[zoo] resnet-18 f32 eager step", cfg, state, x, y)
    return timing


def _profile_step(tag: str, cfg, state, x, y) -> None:
    """The kernels that take the most device time in one eager train step
    (augment on), by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    st, step = _trainer(cfg, state, x.device, True, STEPS_PER_EPOCH, EPOCHS)
    gen = torch.Generator(device=x.device).manual_seed(8)
    for _ in range(3):
        step(st, x, y, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(st, x, y, gen)
        torch.cuda.synchronize()
    kernels = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                      for e in prof.key_averages() if _is_device_work(e)),
                     reverse=True)
    log(f"{tag}: device busy {sum(k[0] for k in kernels):.3f} ms in "
        f"{sum(k[1] for k in kernels)} kernels; the largest:")
    for ms, count, name in kernels[:8]:
        log(f"[profile]   {ms:.3f} ms  x{count}  {name[:90]}")


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
        st, step = _trainer(run_cfg, state, x.device, False, steps_per_epoch,
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
    st, step = _trainer(cfg, state, device, True, AUDIOSET_STEPS_PER_EPOCH,
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


def _cli(module: str, args, tag: str, sigterm_after_steps: int = 0):
    """Run ``python -m leaf_tpu_torch.<module>``; returns its stdout. With
    ``sigterm_after_steps`` it is sent SIGTERM after that many step lines.
    Fails on a non-zero exit; never leaves the process running."""
    import signal
    here = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-u", "-m", f"leaf_tpu_torch.{module}", *args]
    env = {**os.environ,
           "PYTHONPATH": here + os.pathsep + os.environ.get("PYTHONPATH", "")}
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env,
                            cwd=here)
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
        if proc.poll() is None:
            proc.kill()
            proc.wait()
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


def _time_loader(cfg: dict, in_memory: bool, workers: int,
                 epochs: int = 3) -> list:
    """clips/s of the train DataLoader alone (no model), per epoch."""
    from leaf_tpu_torch.data import (RawWaveformDataset,
                                     leaf_host_crop_transforms,
                                     setup_dataloaders)
    ds = RawWaveformDataset(cfg["data"]["train"], cfg["data"]["labels"],
                            cfg["audio_config"], mode="multiclass",
                            transform=leaf_host_crop_transforms(True, 16000),
                            in_memory=in_memory, wire_dtype="int16")
    loader, _ = setup_dataloaders(ds, None, TRAIN_B, target_len=16000,
                                  num_workers=workers, need_val=False)
    rates = []
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        t0 = time.perf_counter()
        n = sum(x.shape[0] for x, _ in loader)
        rates.append(n / (time.perf_counter() - t0))
    return rates


def _time_decode(cfg: dict, n: int = 256) -> float:
    """µs per clip of ``load_audio`` alone, one thread, over n train files
    (read once before, so the OS cache holds them)."""
    from leaf_tpu_torch.data.audio import load_audio
    from leaf_tpu_torch.data.dataset import read_manifest
    files = read_manifest(cfg["data"]["train"])["files"][:n]
    for f in files:
        load_audio(f, 16000, 1.0, dtype="int16")
    t0 = time.perf_counter()
    for f in files:
        load_audio(f, 16000, 1.0, dtype="int16")
    return (time.perf_counter() - t0) / n * 1e6


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

    loader = {(mem, w): _time_loader(cfg, mem, w)
              for mem, w in ((False, 1), (False, 4), (True, 4))}
    for (mem, w), rates in loader.items():
        log(f"[cli] train DataLoader alone (num_workers {w}, in_memory "
            f"{mem}, int16 wire, B={TRAIN_B}): " + ", ".join(
                f"epoch {i} {r:.0f} clips/s" for i, r in enumerate(rates))
            + f"; the step needs ~{STEP_DEVICE_CLIPS_PER_S} clips/s")
    log(f"[cli] load_audio alone, one thread, files in {tmp}: "
        f"{_time_decode(cfg):.1f} us per clip")
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


def _time_packed_loader(tmp: str, packed_dir: str, workers: int,
                        epochs: int = 3) -> list:
    """clips/s of the packed train DataLoader alone (no model), per epoch."""
    from leaf_tpu_torch.data import (PackedDataset, leaf_host_crop_transforms,
                                     setup_dataloaders)
    ds = PackedDataset(os.path.join(packed_dir, "train_packed.csv"),
                       os.path.join(tmp, "lbl_map.json"),
                       {"sample_rate": 16000, "min_duration": 1},
                       mode="multiclass",
                       transform=leaf_host_crop_transforms(True, 16000))
    loader, _ = setup_dataloaders(ds, None, PACKED_SHARDS, target_len=16000,
                                  num_workers=workers, need_val=False,
                                  packed=True)
    rates = []
    for epoch in range(epochs):
        loader.set_epoch(epoch)
        t0 = time.perf_counter()
        n = sum(x.shape[0] for x, _ in loader)
        rates.append(n / (time.perf_counter() - t0))
    return rates


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

    rates = _time_packed_loader(tmp, packed_dir, workers=4)
    csv_rates = cli["loader"][(False, 4)]
    log(f"[packed] train DataLoader alone (num_workers 4, B={PACKED_SHARDS} "
        f"shards x {PACKED_RECORDS}, float32 wire): " + ", ".join(
            f"epoch {i} {r:.0f} clips/s" for i, r in enumerate(rates))
        + "; the CSV/WAV loader ([cli], num_workers 4, int16 wire): "
        + ", ".join(f"epoch {i} {r:.0f}" for i, r in enumerate(csv_rates)))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        import leaf_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the leaf_tpu_torch package is not importable "
              f"({e}); run from the repository root", file=sys.stderr)
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
    timed("multistep", phase_multistep, device, state)
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

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    log(smi[0])
    src = "leaf_tpu_torch/ops/csrc/"
    log(json.dumps({"kernels": [
        {"name": "fused_gabor_sqmod_lowpass_fwd", "route": "cuda",
         "source": src + "fused_frontend.cu",
         "replaces": "leaf_tpu/ops/fused_frontend.py:325",
         "launches": launches, "max_abs_err": max_abs_err,
         **timing["fwd"]},
        {"name": "fused_gabor_sqmod_lowpass_fwd_saving", "route": "cuda",
         "source": src + "fused_frontend.cu",
         "replaces": "leaf_tpu/ops/fused_frontend.py:336",
         "launches": train_counts["fwd_save"], "max_abs_err": fwd_save_err,
         **timing["fwd_save"]},
        {"name": "fused_gabor_sqmod_lowpass_bwd", "route": "cuda",
         "source": src + "fused_frontend_bwd.cu",
         "replaces": "leaf_tpu/ops/fused_frontend.py:422",
         "launches": train_counts["bwd"], "max_abs_err": bwd_err,
         **timing["bwd"]},
        {"name": "fused_gabor_sqmod_lowpass_fwd_bf16", "route": "cuda",
         "source": src + "fused_frontend_bf16.cu",
         "replaces": "leaf_tpu/ops/fused_frontend.py:325",
         "launches": bf16_launches, "max_abs_err": bf16_err["fwd"],
         **timing["fwd_bf16"]},
        {"name": "fused_gabor_sqmod_lowpass_fwd_saving_bf16", "route": "cuda",
         "source": src + "fused_frontend_bf16.cu",
         "replaces": "leaf_tpu/ops/fused_frontend.py:336",
         "launches": bf16_counts["fwd_save_bf16"],
         "max_abs_err": bf16_err["fwd_save"], **timing["fwd_save_bf16"]},
        {"name": "fused_gabor_sqmod_lowpass_bwd_bf16", "route": "cuda",
         "source": src + "fused_frontend_bwd_bf16.cu",
         "replaces": "leaf_tpu/ops/fused_frontend.py:422",
         "launches": bf16_counts["bwd_bf16"], "max_abs_err": bf16_err["bwd"],
         **timing["bwd_bf16"]},
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
