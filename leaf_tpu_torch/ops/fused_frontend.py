"""Fused Gabor conv → squared modulus → Gaussian lowpass (LEAF's hot path).

``fused_gabor_sqmod_lowpass`` computes
``GaussianLowPass(SquaredModulus(GaborConv1d(x)))`` (without the lowpass
bias) for the LEAF geometry: 401 taps, stride 160, TF-SAME padding
(200, 200). It is differentiable in the bank and the windows; the
waveform gradient is zero, as the JAX op's custom VJP defines it.

Three hand-written CUDA kernels carry it on the card, each beside its
plain PyTorch version (which a CPU tensor runs, and which the tests and
``chip_smoke.py`` hold the kernel against):

- ``fused_forward_cuda`` (``csrc/fused_frontend.cu``, primal) ↔
  ``fused_reference``: the forward when no gradient is wanted. Replaces
  ``leaf_tpu/ops/fused_frontend.py:_fwd_kernel`` with ``save_out=False``.
- ``fused_forward_saving_cuda`` (the same source, ``kSave``) ↔
  ``fused_forward_saving_reference``: the forward that also returns the
  conv outputs OUT (B, 2F, T) [re channels | im channels], f32, as the
  backward's residual. Replaces ``_fwd_kernel`` with ``save_out=True``.
- ``fused_backward_cuda`` (``csrc/fused_frontend_bwd.cu``) ↔
  ``fused_backward_reference``: (d_bank, d_windows) from x, OUT, the
  windows and the output cotangent. Replaces ``_bwd_kernel``. It runs
  the d_bank correlation as an implicit GEMM on the tensor cores in
  3×TF32 (``wgmma``), which keeps f32 accuracy.

Each does ≈ 2·B·T·2F·401 ≈ 2.6·10¹¹ flops at B=256, T=16000, F=40, three
times over on the tensor cores (3×TF32 ``wgmma``, which keeps f32
accuracy); the forwards run the conv as an implicit GEMM with the bank
held in shared memory (the sources' headers say what the designs do
about it; ``csrc/hopper_tf32.cuh`` holds the PTX helpers both share).
There is no fallback between kernel and plain version: a CUDA tensor the
kernels cannot take raises.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.nn import grad as nn_grad

from leaf_tpu_torch.frontend.pooling import depthwise_strided_conv

__all__ = ["fused_gabor_sqmod_lowpass", "fused_reference",
           "fused_forward_saving_reference", "fused_backward_reference",
           "fused_forward_cuda", "fused_forward_saving_cuda",
           "fused_backward_cuda", "lowpass_frames_out", "check_geometry"]

_KMAX = 401
_STRIDE = 160
_PAD = (200, 200)
_MAX_GRID_Z = 65535  # the forward kernels put the batch on gridDim.z
# Channels per backward block: its d_bank tile is 401 taps × 80 columns
# (re | im of 40 channels), the width of one m64n80k8 wgmma.
_BWD_CHANS = 40
_BWD_CHUNK = 32      # positions per backward pipeline stage


def lowpass_frames_out(t: int, stride: int, k: int,
                       pad: Tuple[int, int]) -> int:
    return (t + pad[0] + pad[1] - k) // stride + 1


def check_geometry(gabor: torch.Tensor, stride: int, pad) -> None:
    """The kernels are built for the LEAF default geometry only."""
    if gabor.shape[0] != _KMAX or stride != _STRIDE or tuple(pad) != _PAD:
        raise ValueError(
            "fused_gabor_sqmod_lowpass is specialized to K=401 taps, "
            f"stride=160, pad=(200,200); got K={gabor.shape[0]}, "
            f"stride={stride}, pad={tuple(pad)}")


# ------------------------------------------------------- plain versions

def _conv(x: torch.Tensor, gabor: torch.Tensor,
          pad: Tuple[int, int]) -> torch.Tensor:
    """(B, T) waveform → (B, 2F, T) stride-1 conv outputs [re | im]."""
    return F.conv1d(F.pad(x[:, None, :], pad), gabor.T[:, None, :])


def _sqmod_lowpass(conv: torch.Tensor, windows: torch.Tensor, stride: int,
                   pad: Tuple[int, int]) -> torch.Tensor:
    f = conv.shape[1] // 2
    s = conv[:, :f] ** 2 + conv[:, f:] ** 2                        # (B, F, T)
    return depthwise_strided_conv(s.transpose(1, 2), windows, stride, pad)


def fused_reference(x: torch.Tensor, gabor: torch.Tensor,
                    windows: torch.Tensor, stride: int = _STRIDE,
                    pad: Tuple[int, int] = _PAD) -> torch.Tensor:
    """Plain version: (B, T) → conv1d → |·|² → depthwise strided conv."""
    return _sqmod_lowpass(_conv(x, gabor, pad), windows, stride, pad)


def fused_forward_saving_reference(x: torch.Tensor, gabor: torch.Tensor,
                                   windows: torch.Tensor
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the residual-saving forward: (out, OUT), with OUT
    the (B, 2F, T) conv outputs [re | im] the backward reads."""
    conv = _conv(x, gabor, _PAD)
    return _sqmod_lowpass(conv, windows, _STRIDE, _PAD), conv


def fused_backward_reference(x: torch.Tensor, conv: torch.Tensor,
                             windows: torch.Tensor, d_out: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backward: (d_bank (401, 2F), d_windows (F, 401)).

    From the saved conv outputs OUT = ``conv`` (B, 2F, T) and the output
    cotangent dY = ``d_out`` (B, n_frames, F), with S = OUT_re² + OUT_im²
    zero-padded by (200, 200):

      dS[b,t,c]     = Σ_f dY[b,f,c]·win[c, t+200−160f]      (conv1d_input)
      d_win[c,k]    = Σ_{b,f} dY[b,f,c]·S_pad[b,c,160f+k]   (conv1d_weight)
      dOUT          = 2·OUT·dS
      d_bank[j,col] = Σ_{b,t} xpad[b,t+j]·dOUT[b,col,t]     (conv1d_weight)
    """
    f = windows.shape[0]
    t = x.shape[1]
    s_pad = F.pad(conv[:, :f] ** 2 + conv[:, f:] ** 2, _PAD)       # (B, F, T+400)
    dy = d_out.transpose(1, 2)                                      # (B, F, n_frames)
    w = windows[:, None, :]                                         # (F, 1, 401)
    d_s = nn_grad.conv1d_input(s_pad.shape, w, dy, stride=_STRIDE,
                               groups=f)[..., _PAD[0]:_PAD[0] + t]
    d_windows = nn_grad.conv1d_weight(s_pad, w.shape, dy, stride=_STRIDE,
                                      groups=f)[:, 0]
    d_conv = 2.0 * conv * torch.cat([d_s, d_s], dim=1)
    d_bank = nn_grad.conv1d_weight(F.pad(x[:, None, :], _PAD),
                                   (2 * f, 1, _KMAX), d_conv)[:, 0].T
    return d_bank, d_windows


# ------------------------------------------------------------- kernels

def _check_operands(**tensors: torch.Tensor) -> torch.device:
    """Every operand a contiguous float32 tensor on one CUDA device."""
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the kernel needs all "
                             f"operands on one CUDA device ({dev})")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32 "
                            "only (bf16 input is not ported yet)")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return dev


def _check_shapes(x: torch.Tensor, f: int,
                  windows: torch.Tensor) -> Tuple[int, int, int]:
    """(B, T, n_frames) from the shapes, or raise."""
    if x.ndim != 2 or x.shape[1] < 1:
        raise ValueError(f"x must be (B, T), got {tuple(x.shape)}")
    b, t_len = x.shape
    if tuple(windows.shape) != (f, _KMAX):
        raise ValueError(f"windows must be ({f}, 401), got "
                         f"{tuple(windows.shape)}")
    if not 1 <= b <= _MAX_GRID_Z:
        raise ValueError(f"batch {b} outside the kernel's [1, {_MAX_GRID_Z}]")
    return b, t_len, lowpass_frames_out(t_len, _STRIDE, _KMAX, _PAD)


def _raise_on_error(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def _launch_forward(x, gabor, windows, save: bool):
    from leaf_tpu_torch.ops._build import load_library

    dev = _check_operands(x=x, gabor=gabor, windows=windows)
    if gabor.ndim != 2 or gabor.shape[0] != _KMAX or gabor.shape[1] % 2:
        raise ValueError(f"gabor must be (401, 2F), got {tuple(gabor.shape)}")
    f = gabor.shape[1] // 2
    b, t_len, n_frames = _check_shapes(x, f, windows)
    out = torch.empty((b, n_frames, f), device=dev, dtype=torch.float32)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if not save:
            _raise_on_error(lib.fused_fwd_f32(
                x.data_ptr(), gabor.data_ptr(), windows.data_ptr(),
                out.data_ptr(), b, t_len, f, n_frames, stream),
                "fused frontend forward")
            return out
        conv = torch.empty((b, 2 * f, t_len), device=dev, dtype=torch.float32)
        _raise_on_error(lib.fused_fwd_save_f32(
            x.data_ptr(), gabor.data_ptr(), windows.data_ptr(),
            out.data_ptr(), conv.data_ptr(), b, t_len, f, n_frames, stream),
            "fused frontend residual-saving forward")
    return out, conv


def fused_forward_cuda(x: torch.Tensor, gabor: torch.Tensor,
                       windows: torch.Tensor) -> torch.Tensor:
    """Launch the primal forward kernel; ``.launches`` counts launches.

    x (B, T), gabor (401, 2F), windows (F, 401): contiguous float32 on one
    CUDA device. Returns (B, n_frames, F) float32.
    """
    out = _launch_forward(x, gabor, windows, save=False)
    fused_forward_cuda.launches += 1
    return out


def fused_forward_saving_cuda(x: torch.Tensor, gabor: torch.Tensor,
                              windows: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the residual-saving forward kernel; ``.launches`` counts.

    Operands as ``fused_forward_cuda``. Returns (out (B, n_frames, F),
    OUT (B, 2F, T)) float32; every OUT position is written once.
    """
    res = _launch_forward(x, gabor, windows, save=True)
    fused_forward_saving_cuda.launches += 1
    return res


def fused_backward_cuda(x: torch.Tensor, conv: torch.Tensor,
                        windows: torch.Tensor, d_out: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward kernel; ``.launches`` counts launches.

    x (B, T), conv = OUT (B, 2F, T) from ``fused_forward_saving_cuda``,
    windows (F, 401), d_out (B, n_frames, F): contiguous float32 on one
    CUDA device. The kernel (tensor cores, 3×TF32) writes one partial
    sum per block; one fixed-order ``sum`` over the block axis gives
    (d_bank (401, 2F), d_windows (F, 401)), the same on every launch.
    """
    from leaf_tpu_torch.ops._build import load_library

    dev = _check_operands(x=x, conv=conv, windows=windows, d_out=d_out)
    f = windows.shape[0]
    b, t_len, n_frames = _check_shapes(x, f, windows)
    if tuple(conv.shape) != (b, 2 * f, t_len):
        raise ValueError(f"conv must be ({b}, {2 * f}, {t_len}), got "
                         f"{tuple(conv.shape)}")
    if tuple(d_out.shape) != (b, n_frames, f):
        raise ValueError(f"d_out must be ({b}, {n_frames}, {f}), got "
                         f"{tuple(d_out.shape)}")
    if 2 * f * t_len >= 2 ** 31 or b * -(-t_len // _BWD_CHUNK) >= 2 ** 31:
        raise ValueError(f"({b}, {2 * f}, {t_len}) is past the backward "
                         "kernel's 32-bit row and chunk indices")
    groups = -(-f // _BWD_CHANS)
    # one block per SM across the channel groups, each over a contiguous
    # run of (batch row, 32-position chunk) pairs
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_blocks = min(b * -(-t_len // _BWD_CHUNK), max(1, sms // groups))
    dbank = torch.empty((groups, n_blocks, _KMAX, 2 * _BWD_CHANS),
                        device=dev, dtype=torch.float32)
    dwin = torch.empty((groups, n_blocks, _BWD_CHANS, _KMAX), device=dev,
                       dtype=torch.float32)
    lib = load_library()
    with torch.cuda.device(dev):
        _raise_on_error(lib.fused_bwd_f32(
            x.data_ptr(), conv.data_ptr(), windows.data_ptr(),
            d_out.data_ptr(), dbank.data_ptr(), dwin.data_ptr(), b, t_len, f,
            n_frames, n_blocks, torch.cuda.current_stream(dev).cuda_stream),
            "fused frontend backward")
    fused_backward_cuda.launches += 1
    dbank = dbank.sum(1)                                   # (G, 401, 80)
    cols = [dbank[..., h * _BWD_CHANS:(h + 1) * _BWD_CHANS].transpose(0, 1)
            .reshape(_KMAX, groups * _BWD_CHANS)[:, :f] for h in (0, 1)]
    d_windows = dwin.sum(1).reshape(groups * _BWD_CHANS, _KMAX)[:f]
    return torch.cat(cols, dim=1), d_windows


fused_forward_cuda.launches = 0
fused_forward_saving_cuda.launches = 0
fused_backward_cuda.launches = 0


class _FusedForward(torch.autograd.Function):
    """The op under autograd: the residual-saving forward, then the
    backward, as kernels on a CUDA tensor and plain versions on a CPU one.
    The waveform gradient is zero, not absent (the JAX op's contract)."""

    @staticmethod
    def forward(ctx, x, gabor, windows):
        if x.is_cuda:
            x, gabor, windows = (t.contiguous() for t in (x, gabor, windows))
            out, conv = fused_forward_saving_cuda(x, gabor, windows)
        else:
            out, conv = fused_forward_saving_reference(x, gabor, windows)
        ctx.save_for_backward(x, conv, windows)
        return out

    @staticmethod
    def backward(ctx, d_out):
        x, conv, windows = ctx.saved_tensors
        need_x, need_bank, need_win = ctx.needs_input_grad
        d_x = torch.zeros_like(x) if need_x else None
        if not (need_bank or need_win):
            return d_x, None, None
        if d_out.is_cuda:
            d_bank, d_win = fused_backward_cuda(x, conv, windows,
                                                d_out.contiguous())
        else:
            d_bank, d_win = fused_backward_reference(x, conv, windows, d_out)
        return (d_x, d_bank if need_bank else None,
                d_win if need_win else None)


def fused_gabor_sqmod_lowpass(x: torch.Tensor, gabor: torch.Tensor,
                              windows: torch.Tensor, stride: int = _STRIDE,
                              pad: Tuple[int, int] = _PAD) -> torch.Tensor:
    """LEAF hot path, fused: waveform → lowpass-pooled energies.

    Args:
      x: (B, T) waveform; its gradient is zero.
      gabor: (K=401, 2F) [real | imag] Gabor filter bank.
      windows: (F, K) per-channel lowpass windows.
      stride/pad: must be 160 and (200, 200) (see ``check_geometry``).

    Returns (B, n_frames, F) float32, n_frames = (T+pl+pr−K)//stride + 1.
    When a gradient is wanted the residual-saving forward runs (and the
    backward later); otherwise the primal forward.
    """
    check_geometry(gabor, stride, pad)
    if torch.is_grad_enabled() and (x.requires_grad or gabor.requires_grad
                                    or windows.requires_grad):
        return _FusedForward.apply(x, gabor, windows)
    if x.is_cuda:
        return fused_forward_cuda(x.contiguous(), gabor.contiguous(),
                                  windows.contiguous())
    return fused_reference(x, gabor, windows)
