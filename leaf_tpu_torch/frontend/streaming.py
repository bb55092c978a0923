"""Exact streaming (chunked) evaluation of the LEAF frontend.

The port of ``leaf_tpu.frontend.streaming``: the frontend runs over
fixed-size waveform chunks and gives the frames of the offline ``Leaf``
on the concatenated signal, up to f32 roundoff from re-associated EMA
sums (≤ 2e-5 relative; ``tests/test_torch_port_streaming.py``).

Why it is exact: every stage is local in time or a linear recurrence.

- The Gabor conv (stride 1, K taps, TF-SAME (K//2, K//2)) and the
  Gaussian lowpass (stride H, K taps) compose so that frame m needs x on
  [H·m − R, H·m + R], R = 2·(K//2) (LEAF: K = 401, H = 160, R = 400). The
  streamer keeps a P = H·D + R sample tail (D = ⌈(R+1)/H⌉ − 1 frames of
  latency; LEAF: D = 2, P = 720) and runs both stages with VALID padding
  over [tail ‖ chunk]; the offline SAME zeros come from a zero tail on the
  first call and zeros appended on flush.
- Preemphasis runs before the conv; the first call zeroes the pre-stream
  region after it, in preemphasis-output space, as the offline padding.
- sPCEN's smoother s_t = w·x_t + (1−w)·s_{t−1} (s_0 = x_0) carries one
  (B, C) vector, injected as a virtual leading frame into the offline
  evaluators (``ema_matmul`` / ``ema_scan``).
- ``mean_var_norm`` normalizes over the whole clip and raises.

Chunks are a multiple of the hop H and at least ``min_chunk`` (LEAF:
640); the final partial chunk (a multiple of H, possibly none) goes to
``flush``. The cell reads the ``Leaf``'s own parameters and runs on its
device; under ``compute_dtype=bfloat16`` it casts before the conv and
the lowpass as the offline ``Leaf`` does.

    leaf = Leaf(device="cuda")
    streamer = LeafStreamer(leaf, chunk_size=1600)
    for chunk in wave_chunks:              # (B, 1600) each
        frames = streamer.process(chunk)   # (B, 10, C) after the first
    frames = streamer.flush(remainder)     # the lag's D (+ partial) frames
"""

from __future__ import annotations

import copy
from typing import Optional

import torch
from torch import nn

from leaf_tpu_torch.frontend.frontend import Leaf
from leaf_tpu_torch.frontend.postprocessing import (_EMA_MATMUL_MAX_T,
                                                    PCENLayer, ema_matmul,
                                                    ema_scan)

__all__ = ["StreamingLeafCell", "LeafStreamer", "streaming_geometry"]


def streaming_geometry(kernel_size: int, stride: int) -> dict:
    """Derived constants of the chunked evaluation (see module docstring).

    radius R: waveform radius of one frame; lag_frames D: output latency;
    tail P: carried samples; flush_pad: zeros appended on flush;
    min_chunk: the shortest chunk; mask_conv_left/right: conv outputs
    outside the stream's [0, T), zeroed (offline they are the lowpass's
    zero padding). An even kernel pads asymmetrically under SAME, which
    this geometry does not reproduce: it is refused.
    """
    if kernel_size % 2 == 0:
        raise ValueError(
            f"streaming requires an odd conv kernel (symmetric SAME "
            f"padding); got kernel_size={kernel_size}. Offline Leaf pads "
            f"an even kernel asymmetrically, which this chunk geometry "
            f"does not reproduce.")
    r = 2 * (kernel_size // 2)
    d = -(-(r + 1) // stride) - 1
    tail = stride * d + r
    flush_pad = r + 1 - stride
    mask_left = tail - kernel_size // 2
    # a chunk yields ≥ 1 frame past the lag on the first call, and only
    # the first call's conv window reaches before the stream start
    min_chunk = stride * max(d + 1, -(-mask_left // stride))
    return {
        "radius": r,
        "lag_frames": d,
        "tail": tail,
        "flush_pad": flush_pad,
        "min_chunk": min_chunk,
        "mask_conv_left": mask_left,
        "mask_conv_right": max(0, flush_pad - kernel_size // 2),
    }


def _ema_chunk(x: torch.Tensor, w: torch.Tensor,
               s_prev: Optional[torch.Tensor]) -> torch.Tensor:
    """EMA over a chunk (B, T, C); ``s_prev=None`` is the stream start
    (s_0 = x_0, the offline path). Otherwise the carry enters as a
    virtual frame 0 and the recurrence continues it exactly."""
    xs = x if s_prev is None else torch.cat(
        [s_prev[:, None, :].to(x.dtype), x], dim=1)
    s = (ema_matmul(xs, w) if xs.shape[1] <= _EMA_MATMUL_MAX_T
         else ema_scan(xs, w))
    return s if s_prev is None else s[:, 1:]


def _streaming_pcen(pcen: PCENLayer, x: torch.Tensor,
                    s_prev: Optional[torch.Tensor]):
    """``PCENLayer.forward`` with an explicit smoother carry: (out, the
    smoother's last frame)."""
    alpha = torch.clamp(pcen.alpha, max=1.0)
    root = torch.clamp(pcen.root, min=1.0)
    s = _ema_chunk(x, torch.clamp(pcen.ema._weights, 0.0, 1.0), s_prev)
    one_over_root = 1.0 / root
    out = ((x / (pcen.floor + s) ** alpha + pcen.delta) ** one_over_root
           - pcen.delta ** one_over_root)
    return out, s[:, -1, :]


def _valid(module: nn.Module) -> nn.Module:
    """A shallow copy of a conv or lowpass module with VALID padding: it
    holds the same Parameter objects."""
    valid = copy.copy(module)
    valid.padding = (0, 0)
    return valid


class StreamingLeafCell(nn.Module):
    """One chunk step of the frontend over the ``Leaf``'s own parameters.

    ``forward(x_work, pcen_s)`` takes the raw window [tail ‖ chunk
    (‖ flush zeros)] (B, W) float32 and the smoother carry (B, C); it
    returns (frames, new carry), with ``drop_lead`` warm-up frames dropped
    before PCEN. The role flags are fixed per cell (``LeafStreamer``
    keeps one cell per role).
    """

    def __init__(self, leaf: Leaf, drop_lead: int = 0, mask_preemp: int = 0,
                 mask_conv_left: int = 0, mask_conv_right: int = 0,
                 stream_start: bool = False):
        super().__init__()
        if leaf.mean_var_norm:
            raise ValueError(
                "mean_var_norm normalizes over the whole clip and cannot "
                "be streamed; disable it for streaming inference.")
        self.leaf = leaf
        # not registered as submodules: their parameters are the leaf's
        self._stages = (_valid(leaf._complex_conv), _valid(leaf._pooling))
        self.drop_lead = drop_lead
        self.mask_preemp = mask_preemp
        self.mask_conv_left = mask_conv_left
        self.mask_conv_right = mask_conv_right
        self.stream_start = stream_start

    def forward(self, x_work: torch.Tensor, pcen_s: torch.Tensor):
        leaf = self.leaf
        conv, pool = self._stages
        x = x_work[:, None, :].to(torch.float32)
        if leaf.preemp:
            x = leaf._preemp(x)
            if self.mask_preemp:
                x[..., :self.mask_preemp] = 0.0
        x = x.to(leaf.compute_dtype)
        out = leaf._activation(conv(x))                     # (B, F, L)
        if self.mask_conv_left:
            out[..., :self.mask_conv_left] = 0.0
        if self.mask_conv_right:
            out[..., -self.mask_conv_right:] = 0.0
        out = pool(out.to(leaf.compute_dtype).transpose(1, 2))
        out = torch.clamp(out, min=1e-5)                    # (B, frames, F)
        if self.drop_lead:
            out = out[:, self.drop_lead:]
        if leaf._compression is not None:
            out, pcen_s = _streaming_pcen(
                leaf._compression, out, None if self.stream_start else pcen_s)
        return out, pcen_s


class LeafStreamer:
    """The host side of streaming: carries the waveform tail and the PCEN
    state between chunk calls and reproduces the offline ``Leaf`` output.

    ``chunk_size`` is a multiple of the hop and ≥ the geometry's
    ``min_chunk`` (LEAF: 640); the stream's total length is a multiple of
    the hop. Chunks are (B, chunk_size) numpy arrays or tensors; frames
    come back as float32 tensors on the leaf's device.
    """

    def __init__(self, leaf: Leaf, chunk_size: int,
                 batch_size: Optional[int] = None):
        if leaf.mean_var_norm:
            raise ValueError("mean_var_norm cannot be streamed.")
        self.leaf = leaf
        self.device = next(leaf.parameters()).device
        self._setup(leaf.stride, leaf.n_filters,
                    streaming_geometry(leaf.window_size, leaf.stride),
                    chunk_size, batch_size)

    def _setup(self, hop: int, n_filters: int, geo: dict, chunk_size: int,
               batch_size: Optional[int]):
        """Bookkeeping shared with ``serving.StreamingServingModel``."""
        if chunk_size % hop != 0:
            raise ValueError(
                f"chunk_size must be a multiple of the hop "
                f"({hop}): {chunk_size}")
        if chunk_size < geo["min_chunk"]:
            raise ValueError(
                f"chunk_size must be ≥ {geo['min_chunk']} "
                f"(hop·(lag+1)): {chunk_size}")
        self.hop = hop
        self.n_filters = n_filters
        self.chunk_size = chunk_size
        self.geometry = geo
        self._batch = batch_size
        self._tail = None      # (B, P) raw waveform carry
        self._pcen_s = None    # (B, C) smoother carry
        self._n_calls = 0
        self._flushed = False
        self._cells = {}

    def _cell(self, role: str):
        """The cell of a role: "first", "steady", "first_flush_<p>" or
        "flush_<p>" (p: the remainder's samples)."""
        first, flush = role.startswith("first"), "flush" in role
        if (first, flush) not in self._cells:
            geo = self.geometry
            self._cells[first, flush] = StreamingLeafCell(
                self.leaf,
                drop_lead=geo["lag_frames"] if first else 0,
                mask_preemp=geo["tail"] if first else 0,
                mask_conv_left=geo["mask_conv_left"] if first else 0,
                mask_conv_right=geo["mask_conv_right"] if flush else 0,
                stream_start=first)
        return self._cells[first, flush]

    def _as_input(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _init_state(self, batch: int):
        self._batch = batch
        self._tail = torch.zeros((batch, self.geometry["tail"]),
                                 device=self.device)
        self._pcen_s = torch.zeros((batch, self.n_filters),
                                   device=self.device)

    def _step(self, x_work: torch.Tensor, role: str) -> torch.Tensor:
        with torch.no_grad():
            frames, self._pcen_s = self._cell(role)(x_work, self._pcen_s)
        self._tail = x_work[:, -self.geometry["tail"]:]
        self._n_calls += 1
        return frames

    def process(self, chunk) -> torch.Tensor:
        """Feed (B, chunk_size) samples; returns (B, F, n_filters) frames —
        F = chunk_size/hop − lag on the first call, chunk_size/hop after."""
        if self._flushed:
            raise RuntimeError("stream already flushed; make a new streamer")
        chunk = self._as_input(chunk)
        if chunk.ndim != 2 or chunk.shape[1] != self.chunk_size:
            raise ValueError(
                f"expected (B, {self.chunk_size}) chunk, got "
                f"{tuple(chunk.shape)}")
        if self._tail is None:
            self._init_state(chunk.shape[0])
        role = "first" if self._n_calls == 0 else "steady"
        return self._step(torch.cat([self._tail, chunk], dim=1), role)

    def flush(self, remainder=None) -> torch.Tensor:
        """Feed the final partial chunk (a multiple of the hop; None or
        empty for none) and drain the lag; returns (B, p/hop + lag,
        n_filters)."""
        if self._flushed:
            raise RuntimeError("stream already flushed")
        hop = self.hop
        if remainder is not None:
            remainder = self._as_input(remainder)
            if remainder.ndim != 2 or remainder.shape[1] % hop != 0 \
                    or remainder.shape[1] >= self.chunk_size:
                raise ValueError(
                    f"flush remainder must be (B, k·{hop}) with "
                    f"k·{hop} < {self.chunk_size}: "
                    f"{tuple(remainder.shape)}")
        p = 0 if remainder is None else remainder.shape[1]
        if self._tail is None:
            if remainder is None or p < self.geometry["min_chunk"]:
                raise ValueError(
                    f"stream too short: needs ≥ {self.geometry['min_chunk']} "
                    f"samples total")
            self._init_state(remainder.shape[0])
        parts = [self._tail]
        if p:
            parts.append(remainder)
        parts.append(torch.zeros((self._batch, self.geometry["flush_pad"]),
                                 device=self._tail.device))
        role = ("first_flush" if self._n_calls == 0 else "flush") + f"_{p}"
        frames = self._step(torch.cat(parts, dim=1), role)
        self._flushed = True
        return frames

    def reset(self):
        """Start a new stream with the same cells."""
        self._tail = None
        self._pcen_s = None
        self._n_calls = 0
        self._flushed = False
