"""sPCEN — per-channel energy normalization with a learnable EMA smoother.

The exponential moving average ``s_t = w·x_t + (1−w)·s_{t−1}`` (initial
state: the first frame) is evaluated exactly in one of two forms, picked
by length as in the JAX package:

- ``ema_matmul`` (T ≤ 256): the closed form as one lower-triangular
  contraction ``s[b,:,c] = L_c @ x[b,:,c]`` with ``L_c[t,u] = w·(1−w)^{t−u}``
  (u ≥ 1) and ``L_c[t,0] = (1−w)^t``.
- ``ema_scan`` (any T): a Hillis–Steele scan over affine maps, ⌈log₂T⌉
  dependent steps, parallel across (B, C).

Parity: reference leaf_pytorch/postprocessing.py (PCENLayer, EMA): smoother
coeff clamped to [0, 1]; α clamped above by 1, root below by 1; output
``(x / (floor + EMA)^α + δ)^(1/r) − δ^(1/r)``. Parameter names are the
reference's (``alpha``, ``delta``, ``root``, ``ema._weights``).
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["ExponentialMovingAverage", "PCENLayer", "ema_scan", "ema_matmul"]

# Above this many frames the O(T²) matrix form gives way to the scan.
_EMA_MATMUL_MAX_T = 256


def ema_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact EMA of (B, T, C) via its closed form, one triangular contraction.

    s_t = Σ_{u=1..t} w·(1−w)^{t−u}·x_u + (1−w)^t·x_0  (s_0 = x_0).
    """
    t = x.shape[1]
    wf = torch.broadcast_to(w.reshape(-1), (x.shape[2],)).to(torch.float32)
    log1m = torch.log(torch.clamp(1.0 - wf, min=1e-30))  # (C,)
    ti = torch.arange(t, dtype=torch.float32, device=x.device)
    delta = ti[:, None] - ti[None, :]  # (T, T): t − u
    tri = delta >= 0
    pow_mat = torch.exp(torch.where(tri, delta, 0.0)[None]
                        * log1m[:, None, None])  # (C, T, T)
    l_mat = torch.where(tri[None], pow_mat * wf[:, None, None], 0.0)
    # column u=0 carries the initial state: L[c, t, 0] = (1−w)^t
    l_mat[:, :, 0] = pow_mat[:, :, 0]
    return torch.einsum("ctu,buc->btc", l_mat.to(x.dtype), x)


def ema_scan(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """EMA along axis 1 of (B, T, C), per-channel coeff ``w`` of shape (C,).

    Inclusive scan over pairs (a, b) — the affine map ``s ↦ a·s + b`` —
    composed left to right; the first frame's map is the constant x_0.
    """
    a = torch.broadcast_to(1.0 - w, x.shape).to(x.dtype).clone()
    b = w * x
    a[:, 0, :] = 0.0
    b[:, 0, :] = x[:, 0, :]
    shift = 1
    while shift < x.shape[1]:
        a_new, b_new = a.clone(), b.clone()
        a_new[:, shift:] = a[:, shift:] * a[:, :-shift]
        b_new[:, shift:] = a[:, shift:] * b[:, :-shift] + b[:, shift:]
        a, b = a_new, b_new
        shift *= 2
    return b


class ExponentialMovingAverage(nn.Module):
    def __init__(self, in_channels: int, coeff_init: float,
                 per_channel: bool = False, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        shape = (in_channels,) if per_channel else (1,)
        self._weights = nn.Parameter(
            torch.full(shape, coeff_init, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = torch.clamp(self._weights, 0.0, 1.0)
        if x.shape[1] <= _EMA_MATMUL_MAX_T:
            return ema_matmul(x, w)
        return ema_scan(x, w)


class PCENLayer(nn.Module):
    def __init__(self, in_channels: int, alpha: float = 0.96,
                 smooth_coef: float = 0.04, delta: float = 2.0,
                 root: float = 2.0, floor: float = 1e-6,
                 trainable: bool = True, learn_smooth_coef: bool = True,
                 per_channel_smooth_coef: bool = True, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if not learn_smooth_coef:
            raise ValueError("SimpleRNN-based ema not implemented.")
        self.floor = floor

        def const(v):
            return nn.Parameter(torch.full((in_channels,), v, device=device,
                                           dtype=dtype),
                                requires_grad=trainable)

        self.alpha = const(alpha)
        self.delta = const(delta)
        self.root = const(root)
        self.ema = ExponentialMovingAverage(
            in_channels, coeff_init=smooth_coef,
            per_channel=per_channel_smooth_coef, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T, C) → (B, T, C)."""
        alpha = torch.clamp(self.alpha, max=1.0)
        root = torch.clamp(self.root, min=1.0)
        ema_smoother = self.ema(x)
        one_over_root = 1.0 / root
        return ((x / (self.floor + ema_smoother) ** alpha + self.delta)
                ** one_over_root - self.delta ** one_over_root)
