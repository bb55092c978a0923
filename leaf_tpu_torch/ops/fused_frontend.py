"""Fused Gabor conv → squared modulus → Gaussian lowpass (LEAF's hot path).

``fused_gabor_sqmod_lowpass`` computes
``GaussianLowPass(SquaredModulus(GaborConv1d(x)))`` (without the lowpass
bias) for the LEAF geometry: 401 taps, stride 160, TF-SAME padding
(200, 200). On a CUDA tensor it launches the hand-written kernel in
``csrc/fused_frontend.cu``; on a CPU tensor it runs the plain PyTorch
version, ``fused_reference``. There is no fallback between the two: a
CUDA tensor the kernel cannot take raises.

Kernel source note: it replaces ``leaf_tpu/ops/fused_frontend.py:
_fwd_kernel`` (the primal forward, ``save_out=False``). It is bound by
f32 operations, ≈ 2·B·T·2F·401 ≈ 2.6·10¹¹ at B=256, T=16000, F=40; its
design keeps the (B, T, 2F) conv output and the (B, T, F) squared modulus
out of device memory (see the source's header).

The JAX op has a custom VJP that returns a zero waveform gradient; this
port has no backward kernel yet, so the op's backward raises instead of
differentiating the plain version (which would give a different, nonzero
waveform gradient) behind the caller's back.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from leaf_tpu_torch.frontend.pooling import depthwise_strided_conv

__all__ = ["fused_gabor_sqmod_lowpass", "fused_reference",
           "fused_forward_cuda", "lowpass_frames_out", "check_geometry"]

_KMAX = 401
_STRIDE = 160
_PAD = (200, 200)
_MAX_GRID_Z = 65535  # the kernel puts the batch on gridDim.z


def lowpass_frames_out(t: int, stride: int, k: int,
                       pad: Tuple[int, int]) -> int:
    return (t + pad[0] + pad[1] - k) // stride + 1


def check_geometry(gabor: torch.Tensor, stride: int, pad) -> None:
    """The kernel is built for the LEAF default geometry only."""
    if gabor.shape[0] != _KMAX or stride != _STRIDE or tuple(pad) != _PAD:
        raise ValueError(
            "fused_gabor_sqmod_lowpass is specialized to K=401 taps, "
            f"stride=160, pad=(200,200); got K={gabor.shape[0]}, "
            f"stride={stride}, pad={tuple(pad)}")


def fused_reference(x: torch.Tensor, gabor: torch.Tensor,
                    windows: torch.Tensor, stride: int = _STRIDE,
                    pad: Tuple[int, int] = _PAD) -> torch.Tensor:
    """Plain version: (B, T) → conv1d → |·|² → depthwise strided conv."""
    f = gabor.shape[1] // 2
    out = F.conv1d(F.pad(x[:, None, :], pad), gabor.T[:, None, :])  # (B, 2F, T)
    s = out[:, :f] ** 2 + out[:, f:] ** 2                             # (B, F, T)
    return depthwise_strided_conv(s.transpose(1, 2), windows, stride, pad)


def fused_forward_cuda(x: torch.Tensor, gabor: torch.Tensor,
                       windows: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel; ``fused_forward_cuda.launches`` counts launches.

    x (B, T), gabor (401, 2F), windows (F, 401): contiguous float32 on one
    CUDA device. Returns (B, n_frames, F) float32.
    """
    from leaf_tpu_torch.ops._build import load_library

    dev = x.device
    for name, t in (("x", x), ("gabor", gabor), ("windows", windows)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the kernel needs all "
                             f"operands on one CUDA device ({dev})")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32 "
                            "only (bf16 input is not ported yet)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.ndim != 2 or x.shape[1] < 1:
        raise ValueError(f"x must be (B, T), got {tuple(x.shape)}")
    b, t_len = x.shape
    if gabor.ndim != 2 or gabor.shape[0] != _KMAX or gabor.shape[1] % 2:
        raise ValueError(f"gabor must be (401, 2F), got {tuple(gabor.shape)}")
    f = gabor.shape[1] // 2
    if tuple(windows.shape) != (f, _KMAX):
        raise ValueError(f"windows must be ({f}, 401), got "
                         f"{tuple(windows.shape)}")
    if not 1 <= b <= _MAX_GRID_Z:
        raise ValueError(f"batch {b} outside the kernel's [1, {_MAX_GRID_Z}]")
    n_frames = lowpass_frames_out(t_len, _STRIDE, _KMAX, _PAD)
    out = torch.empty((b, n_frames, f), device=dev, dtype=torch.float32)
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.fused_fwd_f32(
            x.data_ptr(), gabor.data_ptr(), windows.data_ptr(),
            out.data_ptr(), b, t_len, f, n_frames,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused frontend kernel launch failed: CUDA error "
                           f"{err}")
    fused_forward_cuda.launches += 1
    return out


fused_forward_cuda.launches = 0


class _FusedForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gabor, windows):
        if x.is_cuda:
            return fused_forward_cuda(x.contiguous(), gabor.contiguous(),
                                      windows.contiguous())
        return fused_reference(x, gabor, windows)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "fused_gabor_sqmod_lowpass has no backward yet: its backward "
            "kernel belongs to the training slice of the port (ROADMAP "
            "Queue 2 items 2-3). Train with Leaf(use_fused_kernel='off').")


def fused_gabor_sqmod_lowpass(x: torch.Tensor, gabor: torch.Tensor,
                              windows: torch.Tensor, stride: int = _STRIDE,
                              pad: Tuple[int, int] = _PAD) -> torch.Tensor:
    """LEAF hot path, fused: waveform → lowpass-pooled energies.

    Args:
      x: (B, T) waveform.
      gabor: (K=401, 2F) [real | imag] Gabor filter bank.
      windows: (F, K) per-channel lowpass windows.
      stride/pad: must be 160 and (200, 200) (see ``check_geometry``).

    Returns (B, n_frames, F) float32, n_frames = (T+pl+pr−K)//stride + 1.
    """
    check_geometry(gabor, stride, pad)
    return _FusedForward.apply(x, gabor, windows)
