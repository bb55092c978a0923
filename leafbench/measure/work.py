"""The H100's published peaks and the least time of a fused-frontend
kernel call, counted from its shape whatever implements it (a frozen copy
of ``leaf_tpu_torch.scripts._measure.bound`` / ``frontend_work``)."""

from __future__ import annotations

# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
F32_PEAK_FLOPS = 67e12
TF32_PEAK_FLOPS = 494.7e12   # tensor cores
BF16_PEAK_FLOPS = 989e12     # tensor cores
HBM_BYTES_PER_S = 3.35e12

TAPS, STRIDE, PAD = 401, 160, (200, 200)


def frames_out(t: int) -> int:
    """Frames of the lowpass at stride 160 over T samples, SAME padding."""
    return (t + PAD[0] + PAD[1] - TAPS) // STRIDE + 1


def bound(flops: float, nbytes: float, tc_flops: float = 0.0,
          tc_peak: float = TF32_PEAK_FLOPS) -> dict:
    """Least time for ``flops`` f32 operations on the CUDA cores plus
    ``tc_flops`` tensor-core operations at ``tc_peak``, or for moving
    ``nbytes``: {"bound_ms", "bound_by"}."""
    flop_ms = (flops / F32_PEAK_FLOPS + tc_flops / tc_peak) * 1e3
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(flop_ms, byte_ms),
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes"}


def frontend_work(b: int, t: int, f: int, es: int, kind: str) -> dict:
    """``bound``'s arguments for one fused-frontend call at (B, T, F) with
    operands of ``es`` bytes (4: f32, 2: bf16); ``kind`` 'fwd' (primal),
    'fwd_save' (also writes the conv output) or 'bwd'.

    Operations: the 401-tap correlation of x with the bank (2·B·T·2F·401)
    on the tensor cores, three times in 3×TF32 for f32 operands, once at
    the bf16 rate for bf16; the rest (|·|², the lowpass, dS and d_windows)
    on the CUDA cores. Bytes: each input read once and each output written
    once."""
    if kind not in ("fwd", "fwd_save", "bwd"):
        raise ValueError(f"kind must be fwd, fwd_save or bwd: {kind!r}")
    n_frames = frames_out(t)
    conv_flops = 2 * b * t * 2 * f * TAPS
    x_b, bank_b, win_b = es * b * t, es * TAPS * 2 * f, 4 * f * TAPS
    out_b, conv_b = 4 * b * n_frames * f, es * b * 2 * f * t
    if kind == "bwd":
        # S positions each frame's window covers inside [0, T): the work
        # of dS and of d_windows
        covered = sum(min(STRIDE * fr + 201, t) - max(STRIDE * fr - 200, 0)
                      for fr in range(n_frames))
        flops = 7 * b * t * f + 2 * 2 * b * f * covered
        nbytes = x_b + conv_b + win_b + out_b + bank_b + win_b
    else:
        flops = 3 * b * t * f + 2 * b * n_frames * f * TAPS
        nbytes = x_b + bank_b + win_b + out_b + (conv_b if kind == "fwd_save"
                                                 else 0)
    if es == 2:
        return {"flops": flops, "nbytes": nbytes, "tc_flops": conv_flops,
                "tc_peak": BF16_PEAK_FLOPS}
    return {"flops": flops, "nbytes": nbytes, "tc_flops": 3 * conv_flops,
            "tc_peak": TF32_PEAK_FLOPS}


def frontend_bound_ms(calls) -> float:
    """Σ bound ms over ``calls``, each (kind, b, t, f, es)."""
    return sum(bound(**frontend_work(b, t, f, es, kind))["bound_ms"]
               for kind, b, t, f, es in calls)
