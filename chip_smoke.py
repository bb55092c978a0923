#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``leaf_tpu_torch``).

Needs one CUDA card (an H100 for the ``sm_90a`` build) and the repository
around this file. Phases, in order; any failure exits non-zero and prints
no result. TF32 is off throughout (cuDNN and matmul).

1. build        — compile the port's CUDA kernels from
                  ``leaf_tpu_torch/ops/csrc`` (one nvcc per source, together)
2. parity       — primal forward kernel vs its plain PyTorch version,
                  B=256, F=40, T ∈ {16000, 12345, 48000}
3. parity-train — the residual-saving forward kernel (out and OUT) and the
                  backward kernel (d_bank, d_windows) vs their plain
                  versions and vs autograd through the plain forward, at
                  the same shapes
4. serving      — the flagship LEAF + EfficientNet-b0 classifier (seeded
                  random weights) answers requests of 3, 8, 64 and 100 clips
                  through ``ServingModel`` with buckets (8, 64); one primal
                  kernel launch per bucket forward; logits held against the
                  same weights with ``use_fused_kernel='off'`` on the card
                  and on the CPU
5. train        — the flagship trains at B=256 × 16000 for 5 steps of
                  ``make_train_step`` (augment, dropout, drop-connect on):
                  finite losses, the step counter advances, one saving and
                  one backward kernel launch per step, one primal launch per
                  eval forward; then 3 steps (augment, dropout, drop-connect
                  off) held against ``use_fused_kernel='off'`` on the card,
                  and 2 steps at B=8 held against the CPU
6. timings      — each kernel, its plain version and the cuDNN composition
                  at B=256, T=16000 (CUDA events); serving latency per
                  bucket; the train step fused vs 'off' and a torch.profiler
                  split of one step
7. report       — card name and power limit, the ``kernels`` JSON line, and
                  the last line ``{"ok": true, "device": {...}}``

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import subprocess
import sys
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
# kernel vs plain, elementwise: |k − p| ≤ RTOL·|p| + ATOL_REL·max|p|.
# Both sum the same f32 products in different orders (f32 has ~6e-8
# relative rounding; a 401-tap sum and its square stay well inside 1e-4).
KERNEL_RTOL, KERNEL_ATOL_REL = 1e-4, 1e-6
# logits, fused vs unfused frontend: max|a − b| ≤ LOGIT_TOL·max|b| (the
# kernel's last-bit differences pass through PCEN and 16 MBConv blocks)
LOGIT_TOL = 1e-3
# gradients, backward kernel vs plain: ‖k − p‖ ≤ GRAD_REL_TOL·‖p‖ and
# max|k − p| ≤ GRAD_REL_TOL·max|p|. d_bank sums B·T ≈ 4.1e6 products per
# entry in other orders (per-thread runs of 8192, then 512 partials); the
# expected f32 rounding is a few 1e-6 of the norm.
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
HBM_BYTES_PER_S = 3.35e12


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


def phase_build():
    from leaf_tpu_torch.ops._build import load_library
    lib = load_library()
    log(f"[build] {', '.join(p.name for p in lib.paths.values())}: "
        f"{lib.build_seconds:.2f} s")
    for line in lib.build_log.splitlines():
        if ("registers" in line or "spill" in line or "smem" in line
                or line.startswith("[")):
            log(f"[build] {line.strip()}")


def leaf_operands(device):
    """The flagship Leaf's (bank, windows) at its mel init, on ``device``."""
    from leaf_tpu_torch.frontend import Leaf
    leaf = Leaf(device=device)
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
    bank, windows = leaf_operands(device)
    rng = np.random.RandomState(0)
    x_all = torch.from_numpy(
        (rng.randn(PARITY_B, max(PARITY_T)) * 0.1).astype(np.float32)
    ).to(device)
    worst = 0.0
    for t in PARITY_T:
        x = x_all[:, :t].contiguous()
        got = fused_forward_cuda(x, bank, windows)
        ref = fused_reference(x, bank, windows)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        scale = float(ref.abs().max())
        bound = KERNEL_RTOL * ref.abs() + KERNEL_ATOL_REL * scale
        max_abs = float(err.max())
        max_rel = float((err / ref.abs().clamp_min(1e-30)).max())
        ok = (got.shape == ref.shape and bool(torch.isfinite(got).all())
              and bool((err <= bound).all()))
        log(f"[parity] T={t} B={PARITY_B} F={PARITY_F} shape="
            f"{tuple(got.shape)} max_abs_err={max_abs:.3e} "
            f"max_rel_err={max_rel:.3e} max|ref|={scale:.3e} tol: |d| <= "
            f"{KERNEL_RTOL:g}*|ref| + {KERNEL_ATOL_REL:g}*max|ref| -> "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel disagrees with plain at T={t}")
        worst = max(worst, max_abs)
    return worst


def _check_elementwise(tag: str, got, ref) -> float:
    """|got − ref| ≤ KERNEL_RTOL·|ref| + KERNEL_ATOL_REL·max|ref|, or raise."""
    err = (got - ref).abs()
    scale = float(ref.abs().max())
    ok = (got.shape == ref.shape and bool(torch.isfinite(got).all())
          and bool((err <= KERNEL_RTOL * ref.abs()
                    + KERNEL_ATOL_REL * scale).all()))
    log(f"[parity-train] {tag} shape={tuple(got.shape)} max_abs_err="
        f"{float(err.max()):.3e} max|ref|={scale:.3e} tol: |d| <= "
        f"{KERNEL_RTOL:g}*|ref| + {KERNEL_ATOL_REL:g}*max|ref| -> "
        f"{'ok' if ok else 'FAIL'}")
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
    bank, windows = leaf_operands(device)
    rng = np.random.RandomState(4)
    x_all = torch.from_numpy(
        (rng.randn(PARITY_B, max(PARITY_T)) * 0.1).astype(np.float32)
    ).to(device)
    worst_fwd = worst_bwd = 0.0
    for t in PARITY_T:
        x = x_all[:, :t].contiguous()
        out, conv = fused_forward_saving_cuda(x, bank, windows)
        ref_out, ref_conv = fused_forward_saving_reference(x, bank, windows)
        torch.cuda.synchronize()
        worst_fwd = max(worst_fwd,
                        _check_elementwise(f"saving fwd out T={t}", out,
                                           ref_out),
                        _check_elementwise(f"saving fwd OUT T={t}", conv,
                                           ref_conv))
        del ref_conv
        d_out = torch.from_numpy(
            rng.randn(*out.shape).astype(np.float32)).to(device)
        d_bank, d_win = fused_backward_cuda(x, conv, windows, d_out)
        p_bank, p_win = fused_backward_reference(x, conv, windows, d_out)
        torch.cuda.synchronize()
        # autograd through the plain forward, x not requiring a gradient
        b_ = bank.clone().requires_grad_()
        w_ = windows.clone().requires_grad_()
        a_bank, a_win = torch.autograd.grad(
            fused_reference(x, b_, w_), (b_, w_), d_out)
        for tag, got, ref in (("d_bank", d_bank, p_bank),
                              ("d_windows", d_win, p_win),
                              ("d_bank vs autograd", d_bank, a_bank),
                              ("d_windows vs autograd", d_win, a_win)):
            worst_bwd = max(worst_bwd, _check_grad(f"bwd {tag} T={t}", got,
                                                   ref))
        del conv, p_bank, p_win, a_bank, a_win
    return worst_fwd, worst_bwd


def phase_serving(device):
    from leaf_tpu_torch.models import Classifier
    from leaf_tpu_torch.models.common import set_batch_norm_stats_
    from leaf_tpu_torch.ops.fused_frontend import fused_forward_cuda
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

    fused_forward_cuda.launches = 0
    outs = {n: server(requests[n]) for n in REQUEST_SIZES}
    torch.cuda.synchronize()
    launches = fused_forward_cuda.launches
    forwards = sum(-(-n // BUCKETS[-1]) for n in REQUEST_SIZES)
    log(f"[serving] requests {REQUEST_SIZES} -> {forwards} bucket forwards, "
        f"kernel launches {launches}")
    if launches != forwards:
        raise AssertionError(f"expected one kernel launch per forward "
                             f"({forwards}), counted {launches}")

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


def _counts() -> dict:
    from leaf_tpu_torch.ops import fused_frontend as ff
    return {"fwd": ff.fused_forward_cuda.launches,
            "fwd_save": ff.fused_forward_saving_cuda.launches,
            "bwd": ff.fused_backward_cuda.launches}


def _zero_counts() -> None:
    from leaf_tpu_torch.ops import fused_frontend as ff
    for fn in (ff.fused_forward_cuda, ff.fused_forward_saving_cuda,
               ff.fused_backward_cuda):
        fn.launches = 0


def _trainer(cfg, state, device, augment: bool, steps_per_epoch: int,
             epochs: int):
    """(TrainState, train step) for ``cfg`` from the weights ``state``."""
    from leaf_tpu_torch.data import leaf_device_augment
    from leaf_tpu_torch.models import Classifier
    from leaf_tpu_torch.training import (TrainState, make_train_step,
                                         optimization_helper)
    clf = Classifier(cfg, device=device)
    clf.load_state_dict(state)
    opt, sched, _, _ = optimization_helper(
        cfg, clf.parameters(), num_tr_steps_per_epoch=steps_per_epoch,
        num_epochs=epochs)
    return (TrainState(clf, opt, sched),
            make_train_step(augment_fn=leaf_device_augment if augment
                            else None))


def _batch(rng, b: int, device):
    x = torch.from_numpy((rng.randn(b, 16000) * 0.1).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 35, b).astype(np.int64))
    return x.to(device), y.to(device)


def phase_train(device, state):
    """The main training path: 5 steps, then one eval forward."""
    from leaf_tpu_torch.training import make_eval_step
    st, step = _trainer(TRAIN_CFG, state, device, True, STEPS_PER_EPOCH,
                        EPOCHS)
    x, y = _batch(np.random.RandomState(5), TRAIN_B, device)
    gen = torch.Generator(device=device).manual_seed(5)
    _zero_counts()
    metrics = [step(st, x, y, gen) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    counts = _counts()
    losses = [float(m["loss"]) for m in metrics]
    log(f"[train] B={TRAIN_B} x 16000, {TRAIN_STEPS} steps (augment, "
        f"dropout 0.2, drop-connect 0.2 on): losses "
        f"{', '.join(f'{v:.6f}' for v in losses)}; step counter {st.step}; "
        f"kernel launches {counts}")
    if not (all(np.isfinite(losses)) and st.step == TRAIN_STEPS):
        raise AssertionError(f"train steps failed: {losses}, step {st.step}")
    if counts != {"fwd": 0, "fwd_save": TRAIN_STEPS, "bwd": TRAIN_STEPS}:
        raise AssertionError(f"expected one saving-forward and one backward "
                             f"launch per step, counted {counts}")
    _zero_counts()
    out = make_eval_step()(st, x, y)
    torch.cuda.synchronize()
    eval_counts = _counts()
    log(f"[train] eval forward: loss {float(out['loss']):.6f}, correct "
        f"{int(out['correct'])}/{int(out['count'])}, kernel launches "
        f"{eval_counts}")
    if (eval_counts != {"fwd": 1, "fwd_save": 0, "bwd": 0}
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


def _is_device_work(event) -> bool:
    """A kernel or copy on the card; not a user annotation (such as
    ``Optimizer.step#Adam.step``), whose span covers kernels already
    counted."""
    from torch.autograd import DeviceType
    return (event.device_type == DeviceType.CUDA
            and not getattr(event, "is_user_annotation", False))


def profile_requests(server, req, latency_ms: float, n: int = 5) -> None:
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
    log(f"[profile] bucket {len(req)}: device busy {busy:.3f} ms per request "
        f"({launches} kernels), idle {1 - busy / latency_ms:.1%} of the "
        f"{latency_ms:.3f} ms median; fused frontend kernel {fused:.3f} ms "
        f"({fused / busy:.1%} of device time)")
    for ms, count, name in kernels[:5]:
        log(f"[profile]   {ms:.3f} ms  x{count}  {name[:90]}")


def _bound(flops: float, nbytes: float) -> dict:
    flop_ms = flops / F32_PEAK_FLOPS * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(flop_ms, byte_ms),
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes"}


def phase_timings(device, server):
    import torch.nn.functional as F

    from leaf_tpu_torch.ops.fused_frontend import (
        fused_backward_cuda, fused_backward_reference, fused_forward_cuda,
        fused_forward_saving_cuda, fused_forward_saving_reference,
        fused_reference, lowpass_frames_out)
    b, t = 256, 16000
    bank, windows = leaf_operands(device)
    f = windows.shape[0]
    rng = np.random.RandomState(2)
    x = torch.from_numpy((rng.randn(b, t) * 0.1).astype(np.float32)).to(device)
    n_frames = lowpass_frames_out(t, 160, 401, (200, 200))
    d_out = torch.from_numpy(
        rng.randn(b, n_frames, f).astype(np.float32)).to(device)
    weight = bank.T[:, None, :].contiguous()
    win = windows[:, None, :].contiguous()

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

    ms = cuda_time_ms(lambda: fused_forward_cuda(x, bank, windows))
    results["fwd"] = {"ms": ms,
                      "plain_ms": cuda_time_ms(
                          lambda: fused_reference(x, bank, windows)),
                      "library_ms": cuda_time_ms(library),
                      **_bound(fwd_flops, in_bytes + out_bytes)}
    results["fwd_save"] = {
        "ms": cuda_time_ms(lambda: fused_forward_saving_cuda(x, bank,
                                                             windows)),
        "plain_ms": cuda_time_ms(
            lambda: fused_forward_saving_reference(x, bank, windows)),
        # the composition computes OUT (its conv1d output) on the way
        "library_ms": results["fwd"]["library_ms"],
        **_bound(fwd_flops, in_bytes + out_bytes + conv_bytes)}
    _, conv = fused_forward_saving_cuda(x, bank, windows)
    wr = weight.clone().requires_grad_()
    wnr = win.clone().requires_grad_()
    lib_out = library(wr, wnr)
    bwd_flops = conv_flops + 7 * b * t * f + 2 * 2 * b * f * covered
    results["bwd"] = {
        "ms": cuda_time_ms(lambda: fused_backward_cuda(x, conv, windows,
                                                       d_out)),
        "plain_ms": cuda_time_ms(
            lambda: fused_backward_reference(x, conv, windows, d_out)),
        "library_ms": cuda_time_ms(lambda: torch.autograd.grad(
            lib_out, (wr, wnr), d_out.transpose(1, 2), retain_graph=True)),
        **_bound(bwd_flops, in_bytes + conv_bytes + out_bytes
                 + 4 * (401 * 2 * f + f * 401))}
    del conv, lib_out
    for name, r in results.items():
        log(f"[timing] {name} kernel B={b} T={t} F={f} f32: {r['ms']:.4f} ms "
            f"({r['bound_ms'] / r['ms']:.1%} of the {r['bound_by']} bound "
            f"{r['bound_ms']:.4f} ms); plain version {r['plain_ms']:.4f} ms; "
            f"cuDNN composition (library) {r['library_ms']:.4f} ms")

    for bucket in BUCKETS:
        req = (rng.randn(bucket, 16000) * 0.1).astype(np.float32)
        for _ in range(3):
            server(req)
        lat = []
        for _ in range(20):
            t0 = time.perf_counter()
            server(req)  # returns host numpy: ends in a device sync
            lat.append((time.perf_counter() - t0) * 1e3)
        log(f"[timing] serving bucket {bucket}: median {np.median(lat):.3f} "
            f"ms, p90 {np.percentile(lat, 90):.3f} ms per request of "
            f"{bucket} clips (host clock, 20 requests)")
        profile_requests(server, req, float(np.median(lat)))
    return results


def phase_train_timing(device, state):
    """Train step time, fused vs 'off', and a profiler split of one step."""
    from torch.profiler import ProfilerActivity, profile

    off_cfg = {**TRAIN_CFG, "frontend": {**TRAIN_CFG["frontend"],
                                         "use_fused_kernel": "off"}}
    x, y = _batch(np.random.RandomState(7), TRAIN_B, device)
    medians = {}
    for tag, cfg in (("fused", TRAIN_CFG), ("off", off_cfg)):
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
        if tag != "fused":
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
        log(f"[profile] train step (fused): device busy {busy:.3f} ms of the "
            f"{medians[tag]:.3f} ms median (idle {1 - busy / medians[tag]:.1%}); "
            f"frontend kernels {front:.3f} ms ({front / busy:.1%} of busy), "
            f"everything else (backbone, optimizer, PCEN, augment, loss) "
            f"{busy - front:.3f} ms")
        for ms, name in sorted(kernels, reverse=True)[:8]:
            log(f"[profile]   {ms:.3f} ms  {name[:90]}")
    return medians


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
    phase_build()
    max_abs_err = phase_parity(device)
    fwd_save_err, bwd_err = phase_parity_train(device)
    launches, server, state = phase_serving(device)
    train_counts = phase_train(device, state)
    phase_train_parity(device, state)
    timing = phase_timings(device, server)
    phase_train_timing(device, state)

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
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
