"""Depthwise 2-D convolution with TF-SAME padding (EfficientNet's MBConv).

``depthwise_conv2d_same(x, weight, stride)`` computes ``F.conv2d(F.pad(x,
pads), weight, stride=stride, groups=C)`` for NCHW float32 x (B, C, H, W)
and weight (C, 1, k, k), with the pads of ``Conv2dSame`` (``same_pads``).
It is differentiable in x and the weight.

Three hand-written CUDA kernels carry it on the card
(``csrc/depthwise.cu``), each beside its plain PyTorch version, which a
tensor on any other device runs and which the tests and ``chip_smoke.py``
hold the kernel against:

- ``depthwise_forward_cuda`` ↔ ``depthwise_reference``: the forward.
- ``depthwise_dgrad_cuda`` and ``depthwise_wgrad_cuda`` ↔
  ``depthwise_backward_reference``: dx from dy, and dW from x and dy (the
  weight-gradient kernel writes one partial per batch chunk, a second
  kernel adds them in a fixed order: the same bits on every call).

They replace no TPU kernel: the JAX package leaves the depthwise conv to
XLA. PyTorch's native ``conv_depthwise2d`` kernels ran them before (the
source's header says why that was slow and what the kernels do instead).
Each pass is bound by device memory: at b0's 16 sites (B = 256) it moves
≈ 577 MB, ≈ 0.17 ms at 3.35 TB/s (``pass_bytes``).

The tile of each kernel (planes per block or rows per band, channels and
batch rows per block for the weight gradient) is planned from the shape
and the card's SM count (``forward_plan``, ``dgrad_plan``,
``wgrad_plan``), within 48 KB of shared memory a block.

Every call goes through two ``torch.library`` custom ops,
``torch.ops.leaf_tpu_torch.{depthwise_fwd, depthwise_bwd}``: the CUDA
implementation launches the kernels, the other devices run the plain
version (the CPU's bits are those of ``F.pad`` + ``F.conv2d`` and of their
autograd), and a fake implementation gives ``torch.export`` the output
shapes. A CUDA tensor the kernels cannot take raises; there is no
fallback.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

__all__ = ["depthwise_conv2d_same", "routes", "same_pads", "geometry",
           "forward_plan", "dgrad_plan", "wgrad_plan", "pass_bytes",
           "depthwise_reference", "depthwise_backward_reference",
           "depthwise_forward_cuda", "depthwise_dgrad_cuda",
           "depthwise_wgrad_cuda", "depthwise_fwd_op", "depthwise_bwd_op",
           "KERNELS", "launch_counts", "reset_launch_counts",
           "SUPPORTED"]

# the (kernel size, stride) pairs the kernels are built for: every
# depthwise conv of EfficientNet b0-b8 and l2
SUPPORTED = ((3, 1), (3, 2), (5, 1), (5, 2))
_THREADS = 256        # threads a block
_TARGET = 8192        # floats of shared memory a tile aims at (32 KB)
_LIMIT = 12288        # floats a block may take (48 KB)
# the weight gradient's blocks an SM (its __launch_bounds__ minimum)
_WGRAD_BLOCKS_PER_SM = 3


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """TF-SAME padding (before, after) of one spatial axis, as
    ``Conv2dSame``: out = ⌈size / stride⌉ and the total padding
    max((out − 1)·stride + k − size, 0), split total//2 before."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class Geometry(NamedTuple):
    h: int
    w: int
    k: int
    s: int
    oh: int
    ow: int
    pt: int
    pb: int
    pl: int
    pr: int


@functools.lru_cache(maxsize=None)
def geometry(h: int, w: int, k: int, s: int) -> Geometry:
    pt, pb = same_pads(h, k, s)
    pl, pr = same_pads(w, k, s)
    return Geometry(h, w, k, s, (h + pt + pb - k) // s + 1,
                    (w + pl + pr - k) // s + 1, pt, pb, pl, pr)


def routes(x: torch.Tensor, weight: torch.Tensor, stride, dilation,
           groups: int, bias) -> bool:
    """Whether a conv takes ``depthwise_conv2d_same``: a depthwise conv
    (groups == in == out channels) without bias, a square kernel and
    equal strides of a ``SUPPORTED`` pair, dilation 1, on float32
    operands. Every other conv keeps ``F.pad`` + ``F.conv2d``."""
    c = x.shape[1]
    k = weight.shape[-1]
    return (groups == c == weight.shape[0] and weight.shape[1] == 1
            and bias is None and weight.shape[-2] == k
            and tuple(dilation) == (1, 1) and stride[0] == stride[1]
            and (k, stride[0]) in SUPPORTED
            and x.dtype == weight.dtype == torch.float32)


def pass_bytes(b: int, c: int, h: int, w: int, k: int, s: int) -> int:
    """Bytes a pass must move at one site: the input plane once and the
    output plane once, f32 (forward: x and y; input gradient: dy and dx;
    weight gradient: x and dy read)."""
    g = geometry(h, w, k, s)
    return 4 * b * c * (h * w + g.oh * g.ow)


# ------------------------------------------------------------------ plans

def _pow2_floor(n: int) -> int:
    return 1 << (max(1, n).bit_length() - 1)


def _r4(n: int) -> int:
    return (n + 3) & ~3


def _ps(rows: int, wp: int) -> int:
    """A staged plane's stride in shared memory: rows·wp made odd (the
    source's ``Stage::ps``)."""
    return rows * wp | 1


def _band(floats, n_rows: int, what: str) -> Tuple[int, int]:
    """(rows per band, bands) for a plane that takes a band of rows at a
    time: the most rows whose tile ``floats(rows)`` fits the target (at
    least one, within the limit), spread evenly over the bands."""
    rows = 1
    while rows < n_rows and floats(rows + 1) <= _TARGET:
        rows += 1
    if floats(rows) > _LIMIT:
        raise ValueError(f"{what}: one row of the plane takes "
                         f"{floats(rows) * 4} bytes of shared memory, past "
                         f"the kernel's {_LIMIT * 4}")
    bands = -(-n_rows // rows)
    return -(-n_rows // bands), bands


def _planes_per_tile(floats_one: int, n_planes: int, sms: int) -> int:
    """The most planes a tile (a power of two up to 256) whose tile fits
    the target, keeping about four tiles an SM where the planes allow."""
    p = 1
    while (p < _THREADS and 2 * p * floats_one <= _TARGET
           and -(-n_planes // (2 * p)) >= 4 * sms):
        p *= 2
    return p


@functools.lru_cache(maxsize=None)
def forward_plan(n_planes: int, h: int, w: int, k: int, s: int,
                 sms: int) -> Tuple[int, int]:
    """(P, TH): whole planes, P a tile (TH = OH), or, for a plane past the
    tile target, one plane's outputs in bands of TH rows (P = 1)."""
    g = geometry(h, w, k, s)
    wp = w + g.pl + g.pr

    def floats(p: int, th: int) -> int:
        return _r4(p * _ps((th - 1) * s + k, wp)) + p * th * g.ow

    if floats(1, g.oh) <= _TARGET:
        return _planes_per_tile(floats(1, g.oh), n_planes, sms), g.oh
    th, _ = _band(lambda r: floats(1, r), g.oh, "depthwise forward")
    return 1, th


def _coarse(g: Geometry) -> Tuple[int, int, int]:
    """The input gradient's coarse grid: (M taps per parity, coarse rows,
    coarse columns) of a plane."""
    m = -(-g.k // g.s)
    n_a = (g.h - 1 + g.pt) // g.s - g.pt // g.s + 1
    n_b = (g.w - 1 + g.pl) // g.s - g.pl // g.s + 1
    return m, n_a, n_b


@functools.lru_cache(maxsize=None)
def dgrad_plan(n_planes: int, h: int, w: int, k: int, s: int,
               sms: int) -> Tuple[int, int]:
    """(P, TA): whole planes, P a tile, or one plane in bands of TA coarse
    rows (S dx rows each)."""
    g = geometry(h, w, k, s)
    m, n_a, n_b = _coarse(g)

    def floats(p: int, ta: int) -> int:
        return (_r4(p * _ps(ta + m - 1, n_b + m - 1))
                + p * min(ta * s, h) * w)

    if floats(1, n_a) <= _TARGET:
        return _planes_per_tile(floats(1, n_a), n_planes, sms), n_a
    ta, _ = _band(lambda r: floats(1, r), n_a, "depthwise input gradient")
    return 1, ta


class WgradPlan(NamedTuple):
    ct: int        # channels a block (256 / ct threads a channel)
    chunk: int     # batch rows a block
    bs: int        # batch rows staged at once
    tr: int        # dy rows staged at once (OH unless the plane is banded)
    n_chunks: int  # partial sums the second kernel adds


@functools.lru_cache(maxsize=None)
def wgrad_plan(b: int, c: int, h: int, w: int, k: int, s: int,
               sms: int) -> WgradPlan:
    """Threads a channel: a power of two up to the output positions of a
    plane (at most 256); channels a block: 256 over that, halved while one
    batch row of their planes exceeds the tile target. Batch chunks: as
    many as fill one wave of the card beside the channel tiles. Staged at
    once: as many batch rows as fit 48 KB, or one plane in bands of dy
    rows."""
    g = geometry(h, w, k, s)
    wp = w + g.pl + g.pr
    ct = _THREADS // min(_THREADS, _pow2_floor(g.oh * g.ow))

    def floats(ct: int, tr: int) -> int:  # one batch row
        return _r4(ct * _ps((tr - 1) * s + k, wp)) + ct * _ps(tr, g.ow)

    while ct > 1 and floats(ct, g.oh) > _TARGET:
        ct //= 2
    n_ct = -(-c // ct)
    # one wave: as many batch chunks as the SMs hold blocks beside the
    # channel tiles (a second, part-filled wave would idle most SMs)
    chunk = -(-b // max(1, min(b, _WGRAD_BLOCKS_PER_SM * sms // n_ct)))
    if floats(ct, g.oh) <= _TARGET:
        # its 25 sums a thread hold the kernel to three blocks an SM: a
        # stage may take the whole 48 KB
        tr = g.oh
        bs = max(1, min(chunk, _LIMIT // floats(ct, g.oh)))
    else:
        tr, _ = _band(lambda r: floats(1, r), g.oh,
                      "depthwise weight gradient")
        bs = 1
    return WgradPlan(ct, chunk, bs, tr, -(-b // chunk))


# ------------------------------------------------------- plain versions

def _pad(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """x with its TF-SAME pads (``Conv2dSame``'s ``F.pad``)."""
    pt, pb = same_pads(x.shape[2], k, stride)
    pl, pr = same_pads(x.shape[3], k, stride)
    return F.pad(x, (pl, pr, pt, pb)) if any((pl, pr, pt, pb)) else x


def depthwise_reference(x: torch.Tensor, weight: torch.Tensor,
                        stride: int) -> torch.Tensor:
    """Plain version: ``F.pad`` then the grouped ``F.conv2d``, as
    ``Conv2dSame`` computed every depthwise conv before the kernels."""
    return F.conv2d(_pad(x, weight.shape[-1], stride), weight, None, stride,
                    0, 1, x.shape[1])


def depthwise_backward_reference(x: torch.Tensor, weight: torch.Tensor,
                                 dy: torch.Tensor, stride: int,
                                 need_x: bool = True, need_w: bool = True):
    """Plain version of the backward: (dx or None, dW or None). The
    grouped conv's gradients on the padded x in one call, then the pad's
    backward (``F.pad`` by the negated pads) for dx, as autograd of the
    plain forward computes them: the same calls on the same operands, so
    the same bits and layout."""
    k = weight.shape[-1]
    pt, pb = same_pads(x.shape[2], k, stride)
    pl, pr = same_pads(x.shape[3], k, stride)
    dxp, dw, _ = torch.ops.aten.convolution_backward(
        dy, _pad(x, k, stride), weight, None, [stride, stride], [0, 0],
        [1, 1], False, [0, 0], weight.shape[0], [need_x, need_w, False])
    if need_x and any((pl, pr, pt, pb)):
        dxp = F.pad(dxp, (-pl, -pr, -pt, -pb))
    return dxp, dw


# ------------------------------------------------------------- kernels
# The wrappers run 16 times a b0 forward and are host-bound at serving's
# batch sizes: the checks are plain comparisons, the launch arguments come
# from a per-shape cache, and the device is switched only when it is not
# the current one.

@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _launch_args(kind: str, b: int, c: int, h: int, w: int, k: int, s: int,
                 index: int) -> tuple:
    """(geometry, the C entry point's shape and plan arguments) of one
    kernel at one shape, or raise on a shape the kernels do not take."""
    if (k, s) not in SUPPORTED:
        raise ValueError(f"(k, stride) = ({k}, {s}): the kernels take "
                         f"{SUPPORTED}")
    if b * c * h * w >= 2 ** 31 or h * w * w >= 2 ** 32:
        raise ValueError(f"{(b, c, h, w)} is past the kernels' 32-bit plane "
                         "and row indices")
    g = geometry(h, w, k, s)
    pads = (g.pt, g.pb, g.pl, g.pr)
    if kind == "fwd":
        plan = forward_plan(b * c, h, w, k, s, _sms(index))
    elif kind == "dgrad":
        plan = dgrad_plan(b * c, h, w, k, s, _sms(index))
    else:
        wp = wgrad_plan(b, c, h, w, k, s, _sms(index))
        return g, wp.n_chunks, (b, c, h, w, k, s, *pads, wp.ct, wp.chunk,
                                wp.bs, wp.tr)
    return g, None, (b * c, c, h, w, k, s, *pads, *plan)


def _check(x: torch.Tensor, weight: torch.Tensor, dy=None) -> None:
    """Contiguous float32 operands on one CUDA device, x (B, C, H, W) and
    weight (C, 1, k, k), or raise."""
    dev = x.device
    if (dev.type != "cuda" or weight.device != dev
            or (dy is not None and dy.device != dev)):
        raise ValueError(f"operands on {dev}, {weight.device}"
                         + ("" if dy is None else f", {dy.device}")
                         + ": the kernel needs all on one CUDA device")
    if (x.dtype != torch.float32 or weight.dtype != torch.float32
            or (dy is not None and dy.dtype != torch.float32)):
        raise TypeError("the kernel takes float32 operands")
    if not (x.is_contiguous() and weight.is_contiguous()
            and (dy is None or dy.is_contiguous())):
        raise ValueError("the kernel's operands must be contiguous")
    if (x.ndim != 4 or weight.ndim != 4 or weight.shape[0] != x.shape[1]
            or weight.shape[1] != 1 or weight.shape[2] != weight.shape[3]):
        raise ValueError(f"x {tuple(x.shape)} and weight "
                         f"{tuple(weight.shape)}: the kernels take (B, C, H, "
                         "W) and (C, 1, k, k)")


def _launch(name: str, dev: torch.device, *args) -> None:
    """Call the C entry point ``name`` on ``dev``'s current stream; raise if
    the launch failed."""
    from leaf_tpu_torch.ops._build import load_library

    fn = getattr(load_library(), name)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if dev.index == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _check_dy(dy: torch.Tensor, b: int, c: int, g: Geometry) -> None:
    if dy.shape != (b, c, g.oh, g.ow):
        raise ValueError(f"dy must be {(b, c, g.oh, g.ow)}, got "
                         f"{tuple(dy.shape)}")


def depthwise_forward_cuda(x: torch.Tensor, weight: torch.Tensor,
                           stride: int) -> torch.Tensor:
    """Launch the forward kernel; ``.launches`` counts launches.

    x (B, C, H, W), weight (C, 1, k, k): contiguous float32 on one CUDA
    device. Returns y (B, C, ⌈H/s⌉, ⌈W/s⌉) float32, each entry written
    once."""
    _check(x, weight)
    b, c, h, w = x.shape
    g, _, args = _launch_args("fwd", b, c, h, w, weight.shape[-1], stride,
                              x.device.index)
    y = torch.empty((b, c, g.oh, g.ow), device=x.device, dtype=torch.float32)
    _launch("depthwise_fwd_f32", x.device, x.data_ptr(), weight.data_ptr(),
            y.data_ptr(), *args)
    depthwise_forward_cuda.launches += 1
    return y


def depthwise_dgrad_cuda(x: torch.Tensor, weight: torch.Tensor,
                         dy: torch.Tensor, stride: int) -> torch.Tensor:
    """Launch the input-gradient kernel; ``.launches`` counts launches.

    Operands as ``depthwise_forward_cuda`` and dy (B, C, ⌈H/s⌉, ⌈W/s⌉);
    only x's shape is read. Returns dx (B, C, H, W) float32, each entry
    written once."""
    _check(x, weight, dy)
    b, c, h, w = x.shape
    g, _, args = _launch_args("dgrad", b, c, h, w, weight.shape[-1], stride,
                              x.device.index)
    _check_dy(dy, b, c, g)
    dx = torch.empty_like(x)
    _launch("depthwise_dgrad_f32", x.device, dy.data_ptr(),
            weight.data_ptr(), dx.data_ptr(), *args)
    depthwise_dgrad_cuda.launches += 1
    return dx


def depthwise_wgrad_cuda(x: torch.Tensor, weight: torch.Tensor,
                         dy: torch.Tensor, stride: int) -> torch.Tensor:
    """Launch the weight-gradient kernel and its fixed-order sum of the
    batch chunks' partials; ``.launches`` counts the pairs.

    Operands as ``depthwise_dgrad_cuda``; only the weight's shape is read.
    Returns dW (C, 1, k, k) float32, the same bits on every call."""
    _check(x, weight, dy)
    b, c, h, w = x.shape
    k = weight.shape[-1]
    g, n_chunks, args = _launch_args("wgrad", b, c, h, w, k, stride,
                                     x.device.index)
    _check_dy(dy, b, c, g)
    partial = torch.empty((n_chunks, c, k, k), device=x.device,
                          dtype=torch.float32)
    dw = torch.empty_like(weight)
    _launch("depthwise_wgrad_f32", x.device, x.data_ptr(), dy.data_ptr(),
            partial.data_ptr(), dw.data_ptr(), *args)
    depthwise_wgrad_cuda.launches += 1
    return dw


# The kernel wrappers by name (launch_counts' keys).
KERNELS = {"depthwise_fwd": depthwise_forward_cuda,
           "depthwise_dgrad": depthwise_dgrad_cuda,
           "depthwise_wgrad": depthwise_wgrad_cuda}


def launch_counts() -> dict:
    """Each kernel's launches since the process started (or the last
    ``reset_launch_counts``), by name."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


reset_launch_counts()


# --------------------------------------------------- torch.library ops
# One route for eager code, torch.export programs and CUDA-graph captures:
# the CUDA implementation launches the kernel (its wrapper counts it),
# every other device runs the plain version, and the fake implementation
# gives the output's shape and strides without touching data.

def _op(name: str, schema: str):
    return torch.library.custom_op(f"leaf_tpu_torch::{name}",
                                   mutates_args=(), schema=schema)


@_op("depthwise_fwd", "(Tensor x, Tensor weight, int stride) -> Tensor")
def depthwise_fwd_op(x, weight, stride):
    """The forward: (B, C, ⌈H/s⌉, ⌈W/s⌉)."""
    return depthwise_reference(x, weight, stride)


@_op("depthwise_bwd", "(Tensor x, Tensor weight, Tensor dy, int stride, "
     "bool need_x, bool need_w) -> (Tensor?, Tensor?)")
def depthwise_bwd_op(x, weight, dy, stride, need_x, need_w):
    """The backward: (dx of x's shape, dW of the weight's shape), each
    None unless wanted."""
    return depthwise_backward_reference(x, weight, dy, stride, need_x,
                                        need_w)


@depthwise_fwd_op.register_kernel("cuda")
def _depthwise_fwd_kernel(x, weight, stride):
    return depthwise_forward_cuda(x.contiguous(), weight.contiguous(), stride)


@depthwise_bwd_op.register_kernel("cuda")
def _depthwise_bwd_kernel(x, weight, dy, stride, need_x, need_w):
    x, weight, dy = x.contiguous(), weight.contiguous(), dy.contiguous()
    return (depthwise_dgrad_cuda(x, weight, dy, stride) if need_x else None,
            depthwise_wgrad_cuda(x, weight, dy, stride) if need_w else None)


@depthwise_fwd_op.register_fake
def _(x, weight, stride):
    b, c, h, w = x.shape
    return x.new_empty((b, c, -(-h // stride), -(-w // stride)))


@depthwise_bwd_op.register_fake
def _(x, weight, dy, stride, need_x, need_w):
    if x.device.type != "cuda":
        # the plain version's layout follows x's
        return depthwise_backward_reference(x, weight, dy, stride, need_x,
                                            need_w)
    return (torch.empty_like(x, memory_format=torch.contiguous_format)
            if need_x else None,
            torch.empty_like(weight, memory_format=torch.contiguous_format)
            if need_w else None)


class _DepthwiseConv(torch.autograd.Function):
    """The conv under autograd: the forward op, then the backward op for
    the inputs that want a gradient."""

    @staticmethod
    def forward(ctx, x, weight, stride):
        ctx.stride = stride
        ctx.save_for_backward(x, weight)
        return depthwise_fwd_op(x, weight, stride)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad[:2]
        dx, dw = depthwise_bwd_op(x, weight, dy, ctx.stride, need_x, need_w)
        return dx, dw, None


def depthwise_conv2d_same(x: torch.Tensor, weight: torch.Tensor,
                          stride: int) -> torch.Tensor:
    """Depthwise conv with TF-SAME padding: x (B, C, H, W) float32, weight
    (C, 1, k, k), (k, stride) in ``SUPPORTED``; returns (B, C, ⌈H/s⌉,
    ⌈W/s⌉). Autograd records the conv only when a gradient is wanted;
    each pass goes through its ``torch.ops.leaf_tpu_torch`` op."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return _DepthwiseConv.apply(x, weight, stride)
    return depthwise_fwd_op(x, weight, stride)
