"""Fused Gabor conv → squared modulus → Gaussian lowpass (LEAF's hot path).

``fused_gabor_sqmod_lowpass`` computes
``GaussianLowPass(SquaredModulus(GaborConv1d(x)))`` (without the lowpass
bias) for the LEAF geometry: 401 taps, stride 160, TF-SAME padding
(200, 200). It is differentiable in the bank and the windows; the
waveform gradient is zero, as the JAX op's custom VJP defines it.

Three hand-written CUDA kernels carry it on the card for each operand
type, each beside its plain PyTorch version (which a CPU tensor runs, and
which the tests and ``chip_smoke.py`` hold the kernel against):

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

bf16 compute (the JAX package's ``compute_dtype=bfloat16``): x and the
bank in bf16, the windows in f32. The ``*_bf16_cuda`` wrappers launch
``csrc/fused_frontend_bf16.cu`` / ``csrc/fused_frontend_bwd_bf16.cu``
(one bf16 ``wgmma`` per k-step, f32 sums), and the plain versions follow
the JAX op's rounding points: bf16 products with f32 sums, S and out in
f32, OUT saved in bf16; in the backward dY, the windows of dS, S for
d_windows and dOUT rounded to bf16, d_bank returned in bf16 and
d_windows in f32. Any other mix of dtypes raises.

The three are registered as ``torch.library`` custom ops,
``torch.ops.leaf_tpu_torch.{fused_fwd, fused_fwd_save, fused_bwd}``
(``fused_fwd_op`` and its siblings here): the CUDA implementation is the
kernel wrapper of the operands' dtype, the CPU one the plain version, and
a fake implementation gives the output shapes, so ``torch.export``
programs and CUDA graphs run the kernels as eager code does.

There is no fallback between kernel and plain version, nor between the
bf16 and the f32 kernels: a CUDA tensor the kernels cannot take raises.
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
           "fused_backward_cuda", "fused_forward_bf16_cuda",
           "fused_forward_saving_bf16_cuda", "fused_backward_bf16_cuda",
           "fused_fwd_op", "fused_fwd_save_op", "fused_bwd_op",
           "KERNELS", "launch_counts", "reset_launch_counts",
           "lowpass_frames_out", "check_geometry"]

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

def _is_bf16(low: dict, high: dict) -> bool:
    """True for the bf16 operand set, False for f32; raises on any other.

    f32: every operand float32. bf16: the ``low`` operands (x and the bank,
    or x and OUT) bfloat16 and the ``high`` ones (the windows, dY) float32,
    as the JAX op runs under ``compute_dtype=bfloat16``.
    """
    lo = {t.dtype for t in low.values()}
    hi = {t.dtype for t in high.values()}
    if lo | hi == {torch.float32}:
        return False
    if lo == {torch.bfloat16} and hi == {torch.float32}:
        return True
    got = ", ".join(f"{k} {str(t.dtype).removeprefix('torch.')}"
                    for k, t in {**low, **high}.items())
    raise TypeError(f"{got}: the op takes float32 throughout, or "
                    f"{' and '.join(low)} bfloat16 with {' and '.join(high)} "
                    "float32")


def _bf16_round(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _conv(x: torch.Tensor, gabor: torch.Tensor,
          pad: Tuple[int, int]) -> torch.Tensor:
    """(B, T) waveform → (B, 2F, T) stride-1 conv outputs [re | im], f32
    sums (bf16 operands are upcast: their products are exact in f32)."""
    return F.conv1d(F.pad(x.float()[:, None, :], pad),
                    gabor.float().T[:, None, :])


def _sqmod_lowpass(conv: torch.Tensor, windows: torch.Tensor, stride: int,
                   pad: Tuple[int, int]) -> torch.Tensor:
    f = conv.shape[1] // 2
    s = conv[:, :f] ** 2 + conv[:, f:] ** 2                        # (B, F, T)
    return depthwise_strided_conv(s.transpose(1, 2), windows, stride, pad)


def fused_reference(x: torch.Tensor, gabor: torch.Tensor,
                    windows: torch.Tensor, stride: int = _STRIDE,
                    pad: Tuple[int, int] = _PAD) -> torch.Tensor:
    """Plain version: (B, T) → conv1d → |·|² → depthwise strided conv.
    Under bf16 operands S and out stay f32, as in the JAX op."""
    _is_bf16({"x": x, "gabor": gabor}, {"windows": windows})
    return _sqmod_lowpass(_conv(x, gabor, pad), windows, stride, pad)


def fused_forward_saving_reference(x: torch.Tensor, gabor: torch.Tensor,
                                   windows: torch.Tensor
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the residual-saving forward: (out, OUT), with OUT
    the (B, 2F, T) conv outputs [re | im] the backward reads, at x's dtype
    (out is formed from the f32 sums before OUT is rounded)."""
    _is_bf16({"x": x, "gabor": gabor}, {"windows": windows})
    conv = _conv(x, gabor, _PAD)
    return _sqmod_lowpass(conv, windows, _STRIDE, _PAD), conv.to(x.dtype)


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

    Under bf16 operands (OUT bf16) the sums stay f32 and the JAX op's
    rounding points are kept: dY, the windows of dS, S for d_win and dOUT
    are rounded to bf16, and d_bank is returned in bf16 (d_win in f32).
    """
    lowp = _is_bf16({"x": x, "conv": conv},
                    {"windows": windows, "d_out": d_out})
    rnd = _bf16_round if lowp else (lambda t: t)
    f = windows.shape[0]
    t = x.shape[1]
    conv = conv.float()
    s = conv[:, :f] ** 2 + conv[:, f:] ** 2                         # (B, F, T)
    dy = rnd(d_out).transpose(1, 2)                                 # (B, F, n_frames)
    w = windows[:, None, :]                                         # (F, 1, 401)
    d_s = nn_grad.conv1d_input((s.shape[0], f, t + sum(_PAD)), rnd(w), dy,
                               stride=_STRIDE, groups=f)[..., _PAD[0]:_PAD[0] + t]
    d_windows = nn_grad.conv1d_weight(F.pad(rnd(s), _PAD), w.shape, dy,
                                      stride=_STRIDE, groups=f)[:, 0]
    d_conv = rnd(2.0 * conv * torch.cat([d_s, d_s], dim=1))
    d_bank = nn_grad.conv1d_weight(F.pad(x.float()[:, None, :], _PAD),
                                   (2 * f, 1, _KMAX), d_conv)[:, 0].T
    return d_bank.to(x.dtype), d_windows


# ------------------------------------------------------------- kernels

def _check_operands(bf16: bool, low: dict, high: dict) -> torch.device:
    """Every operand contiguous on one CUDA device, of the f32 set (``bf16``
    False) or of the bf16 set (see ``_is_bf16``)."""
    tensors = {**low, **high}
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the kernel needs all "
                             f"operands on one CUDA device ({dev})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if _is_bf16(low, high) != bf16:
        raise TypeError(
            "this kernel takes " + ("bf16 x" if bf16 else "float32")
            + " operands; " + ("float32 operands go to the f32 kernels"
                               if bf16 else "bf16 operands go to the "
                               "*_bf16_cuda kernels"))
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


def _launch_forward(x, gabor, windows, save: bool, bf16: bool):
    """Run the primal or saving forward kernel of the f32 or the bf16
    source: (out,) or (out, OUT), OUT at x's dtype."""
    from leaf_tpu_torch.ops._build import load_library

    dev = _check_operands(bf16, {"x": x, "gabor": gabor}, {"windows": windows})
    if gabor.ndim != 2 or gabor.shape[0] != _KMAX or gabor.shape[1] % 2:
        raise ValueError(f"gabor must be (401, 2F), got {tuple(gabor.shape)}")
    f = gabor.shape[1] // 2
    b, t_len, n_frames = _check_shapes(x, f, windows)
    res = [torch.empty((b, n_frames, f), device=dev, dtype=torch.float32)]
    if save:
        res.append(torch.empty((b, 2 * f, t_len), device=dev, dtype=x.dtype))
    kernel = getattr(load_library(), "fused_fwd" + ("_save" if save else "")
                     + ("_bf16" if bf16 else "_f32"))
    with torch.cuda.device(dev):
        _raise_on_error(kernel(
            x.data_ptr(), gabor.data_ptr(), windows.data_ptr(),
            *(r.data_ptr() for r in res), b, t_len, f, n_frames,
            torch.cuda.current_stream(dev).cuda_stream),
            "fused frontend " + ("residual-saving " if save else "")
            + "forward" + (" (bf16)" if bf16 else ""))
    return tuple(res)


def fused_forward_cuda(x: torch.Tensor, gabor: torch.Tensor,
                       windows: torch.Tensor) -> torch.Tensor:
    """Launch the primal forward kernel; ``.launches`` counts launches.

    x (B, T), gabor (401, 2F), windows (F, 401): contiguous float32 on one
    CUDA device. Returns (B, n_frames, F) float32.
    """
    out, = _launch_forward(x, gabor, windows, save=False, bf16=False)
    fused_forward_cuda.launches += 1
    return out


def fused_forward_saving_cuda(x: torch.Tensor, gabor: torch.Tensor,
                              windows: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the residual-saving forward kernel; ``.launches`` counts.

    Operands as ``fused_forward_cuda``. Returns (out (B, n_frames, F),
    OUT (B, 2F, T)) float32; every OUT position is written once.
    """
    res = _launch_forward(x, gabor, windows, save=True, bf16=False)
    fused_forward_saving_cuda.launches += 1
    return res


def fused_forward_bf16_cuda(x: torch.Tensor, gabor: torch.Tensor,
                            windows: torch.Tensor) -> torch.Tensor:
    """Launch the bf16 primal forward kernel; ``.launches`` counts.

    x (B, T) and gabor (401, 2F) bfloat16, windows (F, 401) float32,
    contiguous on one CUDA device. Returns (B, n_frames, F) float32.
    """
    out, = _launch_forward(x, gabor, windows, save=False, bf16=True)
    fused_forward_bf16_cuda.launches += 1
    return out


def fused_forward_saving_bf16_cuda(x: torch.Tensor, gabor: torch.Tensor,
                                   windows: torch.Tensor
                                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the bf16 residual-saving forward kernel; ``.launches``
    counts. Operands as ``fused_forward_bf16_cuda``. Returns (out
    (B, n_frames, F) float32, OUT (B, 2F, T) bfloat16)."""
    res = _launch_forward(x, gabor, windows, save=True, bf16=True)
    fused_forward_saving_bf16_cuda.launches += 1
    return res


def _launch_backward(x, conv, windows, d_out, bf16: bool):
    from leaf_tpu_torch.ops._build import load_library

    dev = _check_operands(bf16, {"x": x, "conv": conv},
                          {"windows": windows, "d_out": d_out})
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
    kernel = getattr(load_library(),
                     "fused_bwd_bf16" if bf16 else "fused_bwd_f32")
    with torch.cuda.device(dev):
        _raise_on_error(kernel(
            x.data_ptr(), conv.data_ptr(), windows.data_ptr(),
            d_out.data_ptr(), dbank.data_ptr(), dwin.data_ptr(), b, t_len, f,
            n_frames, n_blocks, torch.cuda.current_stream(dev).cuda_stream),
            "fused frontend backward" + (" (bf16)" if bf16 else ""))
    dbank = dbank.sum(1)                                   # (G, 401, 80)
    cols = [dbank[..., h * _BWD_CHANS:(h + 1) * _BWD_CHANS].transpose(0, 1)
            .reshape(_KMAX, groups * _BWD_CHANS)[:, :f] for h in (0, 1)]
    d_windows = dwin.sum(1).reshape(groups * _BWD_CHANS, _KMAX)[:f]
    return torch.cat(cols, dim=1).to(x.dtype), d_windows


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
    res = _launch_backward(x, conv, windows, d_out, bf16=False)
    fused_backward_cuda.launches += 1
    return res


def fused_backward_bf16_cuda(x: torch.Tensor, conv: torch.Tensor,
                             windows: torch.Tensor, d_out: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the bf16 backward kernel; ``.launches`` counts launches.

    x (B, T) and conv = OUT (B, 2F, T) bfloat16 (from
    ``fused_forward_saving_bf16_cuda``), windows (F, 401) and d_out
    (B, n_frames, F) float32. The f32 partial sums are reduced as in
    ``fused_backward_cuda`` and d_bank is rounded to bf16 once, at the
    end: (d_bank (401, 2F) bfloat16, d_windows (F, 401) float32).
    """
    res = _launch_backward(x, conv, windows, d_out, bf16=True)
    fused_backward_bf16_cuda.launches += 1
    return res


# The kernel wrappers by the short names the CLIs' epoch line prints.
KERNELS = {"fwd": fused_forward_cuda, "fwd_save": fused_forward_saving_cuda,
           "bwd": fused_backward_cuda, "fwd_bf16": fused_forward_bf16_cuda,
           "fwd_save_bf16": fused_forward_saving_bf16_cuda,
           "bwd_bf16": fused_backward_bf16_cuda}


def launch_counts() -> dict:
    """Each kernel's launches since the process started (or the last
    ``reset_launch_counts``), by short name."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


reset_launch_counts()


# --------------------------------------------------- torch.library ops
# The three kernels as custom ops of the ``leaf_tpu_torch`` namespace, so
# that eager code, ``torch.export`` programs and CUDA-graph captures take
# one route: the CUDA implementation launches the f32 or the bf16 kernel
# by dtype (its wrapper counts the launch), every other device runs the
# plain version, and the fake implementation gives ``torch.export`` the
# output shapes without touching data.

def _op(name: str, schema: str):
    return torch.library.custom_op(f"leaf_tpu_torch::{name}",
                                   mutates_args=(), schema=schema)


@_op("fused_fwd", "(Tensor x, Tensor gabor, Tensor windows) -> Tensor")
def fused_fwd_op(x, gabor, windows):
    """The primal forward: (B, n_frames, F) float32."""
    return fused_reference(x, gabor, windows)


@_op("fused_fwd_save",
     "(Tensor x, Tensor gabor, Tensor windows) -> (Tensor, Tensor)")
def fused_fwd_save_op(x, gabor, windows):
    """The residual-saving forward: (out, OUT (B, 2F, T) at x's dtype)."""
    return fused_forward_saving_reference(x, gabor, windows)


@_op("fused_bwd", "(Tensor x, Tensor conv, Tensor windows, Tensor d_out) "
     "-> (Tensor, Tensor)")
def fused_bwd_op(x, conv, windows, d_out):
    """The backward: (d_bank (401, 2F) at x's dtype, d_windows (F, 401))."""
    return fused_backward_reference(x, conv, windows, d_out)


@fused_fwd_op.register_kernel("cuda")
def _fused_fwd_kernel(x, gabor, windows):
    fwd = (fused_forward_bf16_cuda if x.dtype == torch.bfloat16
           else fused_forward_cuda)
    return fwd(x.contiguous(), gabor.contiguous(), windows.contiguous())


@fused_fwd_save_op.register_kernel("cuda")
def _fused_fwd_save_kernel(x, gabor, windows):
    fwd = (fused_forward_saving_bf16_cuda if x.dtype == torch.bfloat16
           else fused_forward_saving_cuda)
    return fwd(x.contiguous(), gabor.contiguous(), windows.contiguous())


@fused_bwd_op.register_kernel("cuda")
def _fused_bwd_kernel(x, conv, windows, d_out):
    bwd = (fused_backward_bf16_cuda if x.dtype == torch.bfloat16
           else fused_backward_cuda)
    return bwd(x.contiguous(), conv.contiguous(), windows.contiguous(),
               d_out.contiguous())


# The fake outputs carry the strides of the implementation that runs:
# the kernels write contiguous (B, n_frames, F) and (401, 2F) arrays; the
# plain versions return transposes of their convolutions' outputs (kept
# as they are: a copy would change the order of later float sums).

def _fake_out(x, f: int):
    b, t_len = x.shape
    n = lowpass_frames_out(t_len, _STRIDE, _KMAX, _PAD)
    if x.device.type == "cuda":
        return x.new_empty((b, n, f), dtype=torch.float32)
    return x.new_empty((b, f, n), dtype=torch.float32).transpose(1, 2)


@fused_fwd_op.register_fake
def _(x, gabor, windows):
    return _fake_out(x, gabor.shape[1] // 2)


@fused_fwd_save_op.register_fake
def _(x, gabor, windows):
    f = gabor.shape[1] // 2
    return _fake_out(x, f), x.new_empty((x.shape[0], 2 * f, x.shape[1]))


@fused_bwd_op.register_fake
def _(x, conv, windows, d_out):
    f = windows.shape[0]
    d_bank = (x.new_empty((_KMAX, 2 * f)) if x.device.type == "cuda"
              else x.new_empty((2 * f, _KMAX)).T)
    return d_bank, windows.new_empty((f, _KMAX), dtype=torch.float32)


class _FusedForward(torch.autograd.Function):
    """The op under autograd: the residual-saving forward op, then the
    backward op (kernels on a CUDA tensor, the bf16 ones for bf16
    operands; plain versions on a CPU one). The waveform gradient is
    zero, not absent (the JAX op's contract)."""

    @staticmethod
    def forward(ctx, x, gabor, windows):
        out, conv = fused_fwd_save_op(x, gabor, windows)
        ctx.save_for_backward(x, conv, windows)
        return out

    @staticmethod
    def backward(ctx, d_out):
        x, conv, windows = ctx.saved_tensors
        need_x, need_bank, need_win = ctx.needs_input_grad
        d_x = torch.zeros_like(x) if need_x else None
        if not (need_bank or need_win):
            return d_x, None, None
        d_bank, d_win = fused_bwd_op(x, conv, windows, d_out)
        return (d_x, d_bank if need_bank else None,
                d_win if need_win else None)


def fused_gabor_sqmod_lowpass(x: torch.Tensor, gabor: torch.Tensor,
                              windows: torch.Tensor, stride: int = _STRIDE,
                              pad: Tuple[int, int] = _PAD) -> torch.Tensor:
    """LEAF hot path, fused: waveform → lowpass-pooled energies.

    Args:
      x: (B, T) waveform, float32 or bfloat16; its gradient is zero.
      gabor: (K=401, 2F) [real | imag] Gabor filter bank, x's dtype.
      windows: (F, K) per-channel lowpass windows, float32.
      stride/pad: must be 160 and (200, 200) (see ``check_geometry``).

    Returns (B, n_frames, F) float32, n_frames = (T+pl+pr−K)//stride + 1.
    When a gradient is wanted the residual-saving forward runs (and the
    backward later); otherwise the primal forward. Each goes through its
    ``torch.ops.leaf_tpu_torch`` op.
    """
    check_geometry(gabor, stride, pad)
    if torch.is_grad_enabled() and (x.requires_grad or gabor.requires_grad
                                    or windows.requires_grad):
        return _FusedForward.apply(x, gabor, windows)
    return fused_fwd_op(x, gabor, windows)
