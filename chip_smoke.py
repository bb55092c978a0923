#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``leaf_tpu_torch``).

Needs one CUDA card (an H100 for the ``sm_90a`` build) and the repository
around this file. Phases, in order; any failure exits non-zero and prints
no result:

1. build   — compile the port's CUDA kernel from ``leaf_tpu_torch/ops/csrc``
2. parity  — kernel vs its plain PyTorch version, B=256, F=40,
             T ∈ {16000, 12345, 48000}, TF32 off
3. serving — the flagship LEAF + EfficientNet-b0 classifier (seeded random
             weights) answers requests of 3, 8, 64 and 100 clips through
             ``ServingModel`` with buckets (8, 64); the kernel's launch count
             must rise; logits are held against the same weights with
             ``use_fused_kernel='off'`` on the card and on the CPU
4. timings — kernel, plain version and cuDNN composition at B=256,
             T=16000 (CUDA events), serving latency per bucket
5. report  — card name and power limit, the ``kernels`` JSON line, and the
             last line ``{"ok": true, "device": {...}}``

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
    log(f"[build] {lib.path.name}: {lib.build_seconds:.2f} s")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
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
    return launches, server


def profile_requests(server, req, latency_ms: float, n: int = 5) -> None:
    """Device time per request by kernel (torch.profiler), and the share of
    the unprofiled median latency the device sits idle."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            server(req)
    kernels = sorted(((e.self_device_time_total / 1e3 / n, e.count // n, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
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


def phase_timings(device, server):
    import torch.nn.functional as F

    from leaf_tpu_torch.ops.fused_frontend import (fused_forward_cuda,
                                                   fused_reference,
                                                   lowpass_frames_out)
    b, t = 256, 16000
    bank, windows = leaf_operands(device)
    f = windows.shape[0]
    x = torch.from_numpy((np.random.RandomState(2).randn(b, t) * 0.1)
                         .astype(np.float32)).to(device)
    weight = bank.T[:, None, :].contiguous()
    win = windows[:, None, :].contiguous()

    def library():  # cuDNN: conv1d → |·|² → grouped strided conv1d
        out = F.conv1d(x[:, None, :], weight, padding=200)
        s = out[:, :f] ** 2 + out[:, f:] ** 2
        return F.conv1d(s, win, stride=160, padding=200, groups=f)

    ms = cuda_time_ms(lambda: fused_forward_cuda(x, bank, windows))
    plain_ms = cuda_time_ms(lambda: fused_reference(x, bank, windows))
    library_ms = cuda_time_ms(library)
    n_frames = lowpass_frames_out(t, 160, 401, (200, 200))
    flops = (2 * b * t * 2 * f * 401 + 3 * b * t * f
             + 2 * b * n_frames * f * 401)
    nbytes = 4 * (b * t + 401 * 2 * f + f * 401 + b * n_frames * f)
    flop_ms, byte_ms = flops / F32_PEAK_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(flop_ms, byte_ms)
    log(f"[timing] fused kernel B={b} T={t} F={f} f32: {ms:.4f} ms "
        f"({flops / ms / 1e9:.2f} TFLOP/s, {bound_ms / ms:.1%} of the f32 "
        f"bound {bound_ms:.4f} ms)")
    log(f"[timing] plain version: {plain_ms:.4f} ms; cuDNN composition "
        f"(library): {library_ms:.4f} ms (TF32 off)")

    rng = np.random.RandomState(3)
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
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms,
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes"}


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
    launches, server = phase_serving(device)
    timing = phase_timings(device, server)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    log(smi[0])
    log(json.dumps({"kernels": [{
        "name": "fused_gabor_sqmod_lowpass_fwd",
        "route": "cuda",
        "source": "leaf_tpu_torch/ops/csrc/fused_frontend.cu",
        "replaces": "leaf_tpu/ops/fused_frontend.py:325",
        "launches": launches,
        "max_abs_err": max_abs_err,
        **timing,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
