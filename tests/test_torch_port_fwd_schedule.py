"""The tensor-core forward kernel's schedule, replayed on the CPU.

``leaf_tpu_torch/ops/csrc/fused_frontend.cu`` splits a row's frames over
blocks, walks each block's S span in chunks of 64-position warpgroup
tiles, skips tiles that cannot hold a nonzero S, folds each chunk into
the frames whose windows meet it and stores the conv positions the block
owns. This file replays those index rules in Python, with the constants
read from the source, and checks what the kernel relies on: every conv
position is stored by exactly one block; every window position inside
[0, T) is folded exactly once, from a tile that computed it; the fold's
16-byte reads stay aligned; and the recomputed halo plus the tile
rounding stays within 8 % of the conv work. The kernel's values are held
against the plain version on the card (tests/test_torch_port_cuda.py).
"""

import re
from pathlib import Path

import pytest

from leaf_tpu_torch.ops import fused_frontend as fused

_SRC = (Path(fused.__file__).parent / "csrc" / "fused_frontend.cu")


def _constants() -> dict:
    """The source's ``constexpr int`` values, evaluated in order."""
    env: dict = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);",
                                 _SRC.read_text()):
        env[name] = int(eval(expr.replace("/", "//"), {}, env))
    return env


C = _constants()


def _frames_per_block(n_frames: int) -> int:
    """launch_fwd: a row's frames split evenly over the fewest blocks of
    at most kMaxFrames."""
    blocks = -(-n_frames // C["kMaxFrames"])
    return -(-n_frames // blocks)


def _blocks(t: int):
    """Per frame block of a row: (f0, frames, s_lo, live tile starts, fold
    ranges {frame: [(lo, hi), ...]}, owned [lo, hi)), positions relative
    to s_lo except the owned range (absolute)."""
    hop, wspan, chunk, win = C["kHop"], C["kWgSpan"], C["kChunk"], C["kWinLen"]
    n_frames = fused.lowpass_frames_out(t, 160, 401, (200, 200))
    per = _frames_per_block(n_frames)
    for f0 in range(0, n_frames, per):
        frames = min(per, n_frames - f0)
        s_lo = f0 * hop - C["kPadL"]
        span = hop * (frames - 1) + win
        q_lo, q_hi = max(0, -s_lo), min(span, t - s_lo)
        live, folds = [], {}
        for ch in range(q_lo // chunk, -(-q_hi // chunk)):
            q0 = ch * chunk
            live += [wq for wq in range(q0, q0 + chunk, wspan)
                     if wq < q_hi and wq + wspan > q_lo]
            fa = (q0 - win) // hop + 1 if q0 >= win else 0
            fb = min(frames - 1, (q0 + chunk - 1) // hop)
            for fl in range(fa, fb + 1):
                lo, hi = max(hop * fl, q0), min(hop * fl + win, q0 + chunk)
                folds.setdefault(fl, []).append((lo, hi))
        yield (f0, frames, s_lo, live, folds,
               (f0 * hop, min((f0 + per) * hop, t)))


@pytest.mark.parametrize("t", [1, 159, 160, 161, 1000, 3041, 4037, 12345,
                               16000, 48000])
def test_schedule_covers_every_position_once(t):
    hop, wspan, win = C["kHop"], C["kWgSpan"], C["kWinLen"]
    assert C["kChunk"] % wspan == 0 and win >= 401 and win % 4 == 0
    owned = [0] * t
    n_frames = 0
    for f0, frames, s_lo, live, folds, (own_lo, own_hi) in _blocks(t):
        assert 1 <= frames <= C["kMaxFrames"]
        n_frames += frames
        computed = {q for wq in live for q in range(wq, wq + wspan)}
        for pos in range(own_lo, own_hi):
            owned[pos] += 1
            assert pos - s_lo in computed
        assert sorted(folds) == list(range(frames))
        for fl, ranges in folds.items():
            folded = [q for lo, hi in ranges for q in range(lo, hi)]
            assert all(lo % 4 == 0 and hi % 4 == 0 for lo, hi in ranges)
            assert len(folded) == len(set(folded))
            window = range(hop * fl, hop * fl + win)
            assert set(folded) <= set(window)
            # every window position inside [0, T) is folded, from a tile
            # that computed its S; the rest of the window reads zeros
            inside = {q for q in window if 0 <= s_lo + q < t}
            assert inside <= set(folded) and inside <= computed
    assert n_frames == fused.lowpass_frames_out(t, 160, 401, (200, 200))
    assert owned == [1] * t


def _conv_overhead(t: int) -> float:
    """Positions the live tiles compute per row over T, minus one."""
    return sum(len(b[3]) for b in _blocks(t)) * C["kWgSpan"] / t - 1


def test_recomputed_halo_within_8_percent():
    # the flagship's one-second clips and the 3 s clips
    for t in (16000, 48000):
        over = _conv_overhead(t)
        print(f"T={t}: conv work {over:+.1%} over T")
        assert 0 < over <= 0.08, over
    assert abs(_conv_overhead(16000) - 0.056) < 1e-9
