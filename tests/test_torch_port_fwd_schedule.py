"""The tensor-core forward kernels' schedules, replayed on the CPU.

``leaf_tpu_torch/ops/csrc/fused_frontend.cu`` (f32) and
``fused_frontend_bf16.cu`` (bf16) split a row's frames over blocks (the
bf16 kernel's items), walk each one's S span in chunks of 64-position
warpgroup tiles, skip tiles that cannot hold a nonzero S, fold each
chunk into the frames whose windows meet it and store the conv
positions they own. This file replays those index rules in Python, with
the constants read from each source, and checks what the kernels rely
on: every conv position is stored by exactly one block; every window
position inside [0, T) is folded exactly once, from a tile that
computed it; the fold's 16-byte reads stay aligned; and the recomputed
halo plus the tile rounding stays within 8 % of the conv work. The bf16
kernel's own rules are replayed too: a persistent grid whose blocks
walk the items in a fixed order, a chunk loop that folds chunk ch - 1
and stores its OUT while chunk ch's products run, from double-buffered
waveform, S and OUT tiles, and OUT stored by 16-byte bulk copies when
T % 8 == 0. The kernels' values are held against the plain versions on
the card (tests/test_torch_port_cuda.py).
"""

import re
from pathlib import Path

import pytest

from leaf_tpu_torch.ops import fused_frontend as fused

_CSRC = Path(fused.__file__).parent / "csrc"
_SRC = _CSRC / "fused_frontend.cu"
_SRC_BF16 = _CSRC / "fused_frontend_bf16.cu"


def _constants(src: Path = _SRC) -> dict:
    """The source's ``constexpr int`` values, evaluated in order."""
    env: dict = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);",
                                 src.read_text()):
        env[name] = int(eval(expr.replace("/", "//"), {}, env))
    return env


C = _constants()
CB = _constants(_SRC_BF16)
T_CASES = [1, 159, 160, 161, 1000, 3041, 4037, 12345, 16000, 48000]


def _frames_per_block(n_frames: int, C: dict = C) -> int:
    """launch_fwd: a row's frames split evenly over the fewest blocks of
    at most kMaxFrames."""
    blocks = -(-n_frames // C["kMaxFrames"])
    return -(-n_frames // blocks)


def _blocks(t: int, C: dict = C):
    """Per frame block of a row: (f0, frames, s_lo, live tile starts, fold
    ranges {frame: [(lo, hi), ...]}, owned [lo, hi)), positions relative
    to s_lo except the owned range (absolute)."""
    hop, wspan, chunk, win = C["kHop"], C["kWgSpan"], C["kChunk"], C["kWinLen"]
    n_frames = fused.lowpass_frames_out(t, 160, 401, (200, 200))
    per = _frames_per_block(n_frames, C)
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


def _check_coverage(t: int, C: dict) -> None:
    hop, wspan, win = C["kHop"], C["kWgSpan"], C["kWinLen"]
    assert C["kChunk"] % wspan == 0 and win >= 401 and win % 4 == 0
    owned = [0] * t
    n_frames = 0
    for f0, frames, s_lo, live, folds, (own_lo, own_hi) in _blocks(t, C):
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


@pytest.mark.parametrize("t", T_CASES)
def test_schedule_covers_every_position_once(t):
    _check_coverage(t, C)


def _conv_overhead(t: int, C: dict = C) -> float:
    """Positions the live tiles compute per row over T, minus one."""
    return sum(len(b[3]) for b in _blocks(t, C)) * C["kWgSpan"] / t - 1


def test_recomputed_halo_within_8_percent():
    # the flagship's one-second clips and the 3 s clips
    for t in (16000, 48000):
        over = _conv_overhead(t)
        print(f"T={t}: conv work {over:+.1%} over T")
        assert 0 < over <= 0.08, over
    assert abs(_conv_overhead(16000) - 0.056) < 1e-9


# ----------------------------------------------- the bf16 kernel's loop

def _bf16_fold_reads(t: int):
    """Per item, the bf16 fold's reads: {frame: [(q, o), ...]} for every
    16-byte piece a lane reads, q its first S position (from s_lo) and
    o = q - 160 fl its window offset; lane l of chunk ch takes q = 256 ch
    + 4 l + 128 h (h = 0, 1) for frames fa .. fb, reading o in [0,
    kWinLen - 4]."""
    hop, chunk, win = CB["kHop"], CB["kChunk"], CB["kWinLen"]
    for f0, frames, s_lo, live, folds, owned in _blocks(t, CB):
        q_lo = max(0, -s_lo)
        q_hi = min(hop * (frames - 1) + win, t - s_lo)
        reads = {}
        for ch in range(q_lo // chunk, -(-q_hi // chunk)):
            q0 = ch * chunk
            fa = (q0 - win) // hop + 1 if q0 >= win else 0
            fb = min(frames - 1, (q0 + chunk - 1) // hop)
            assert fb - fa + 1 <= CB["kFoldFrames"]
            for fl in range(fa, fb + 1):
                for lane in range(32):
                    for h in range(2):
                        q = q0 + 4 * lane + chunk // 2 * h
                        o = q - hop * fl
                        if 0 <= o <= win - 4:
                            reads.setdefault(fl, []).append((q, o))
        yield s_lo, frames, live, reads


@pytest.mark.parametrize("t", T_CASES)
def test_bf16_schedule_covers_every_position_once(t):
    # its items, tiles and owned ranges are the f32 kernel's blocks with
    # its own constants; its fold reads 2 x 4 positions per lane
    assert all(CB[k] == C[k] for k in ("kHop", "kPadL", "kChunk", "kWgSpan",
                                       "kWinLen", "kMaxFrames", "kChans"))
    _check_coverage(t, CB)
    for s_lo, frames, live, reads in _bf16_fold_reads(t):
        computed = {q for wq in live for q in range(wq, wq + CB["kWgSpan"])}
        assert sorted(reads) == list(range(frames))
        for fl, lanes in reads.items():
            # 16-byte aligned S and window reads, inside the padded row
            assert all(q % 4 == 0 and o % 4 == 0 for q, o in lanes)
            taps = [o + k for q, o in lanes for k in range(4)]
            assert len(taps) == len(set(taps)) and max(taps) < CB["kWinLen"]
            # every tap of the window whose position lies in [0, T) is
            # read once, from a tile that computed its S
            inside = {k for k in range(401)
                      if 0 <= s_lo + CB["kHop"] * fl + k < t}
            assert inside <= set(taps)
            assert {CB["kHop"] * fl + k for k in inside} <= computed


def _bf16_items(t: int):
    """The per-item geometry the bf16 kernel's item_at computes: the f32
    kernel's blocks, in order j = row * n_fblocks + frame block."""
    per_row = list(_blocks(t, CB))
    return per_row, len(per_row)


def _bf16_walk(t: int, batch: int = 3, f: int = 40, sms: int = 132):
    """The bf16 kernel's persistent grid, replayed: per block (x, group),
    the items j = x, x + gridDim.x, ... < batch * n_fblocks in order, and
    their chunks as one walk of slots, as events in program order.
    Iteration n passes one barrier; the product warpgroups run slot n's
    products from the Hankel matrices of half n % 2, write its S and OUT
    tiles to half n % 2 and fold slot n - 1's S (half (n - 1) % 2), while
    the helpers stage slot n + 2's waveform into half n % 2, store the
    out of an item whose last fold ran in iteration n - 1, store slot
    n - 1's OUT, and build slot n + 1's Hankel matrices (half
    (n + 1) % 2) from its waveform. After the walk: the last slot's stores and fold,
    a barrier, the last item's out. An item's sums are half (j //
    gridDim.x) % 2."""
    per_row, n_fb = _bf16_items(t)
    n_items = batch * n_fb
    groups = -(-f // CB["kChans"])
    grid_x = min(n_items, max(1, sms // groups))
    chunk = CB["kChunk"]

    def chunks(j):
        s_lo, frames = per_row[j % n_fb][2], per_row[j % n_fb][1]
        q_lo = max(0, -s_lo)
        q_hi = min(CB["kHop"] * (frames - 1) + CB["kWinLen"], t - s_lo)
        return range(q_lo // chunk, -(-q_hi // chunk))

    for x in range(grid_x):
        walk = list(range(x, n_items, grid_x))
        slots = [(j, ch) for j in walk for ch in chunks(j)]

        def store(k, half):
            j, ch = slots[k]
            f0, frames, s_lo, _, _, (own_lo, own_hi) = per_row[j % n_fb]
            t0 = s_lo + ch * chunk
            lo, hi = max(own_lo, t0), min(own_hi, t0 + chunk)
            return [("store", half, slots[k], lo, hi, s_lo)] if lo < hi else []

        def sums_of(k):
            return ("sums", (slots[k][0] // grid_x) % 2, slots[k][0])

        events = [("stage", 0, slots[0])]
        if len(slots) > 1:
            events.append(("stage", 1, slots[1]))
        events += [("barrier",), ("hankel", 0, slots[0])]
        done = None
        for n, slot in enumerate(slots):
            buf = n % 2
            events.append(("barrier",))
            if n + 2 < len(slots):
                events.append(("stage", buf, slots[n + 2]))
            events.append(("product", buf, slot))
            if done is not None:
                events.append(("out",) + done)
            if n > 0:
                events += store(n - 1, buf ^ 1)
            if n + 1 < len(slots):
                events.append(("hankel", buf ^ 1, slots[n + 1]))
            events.append(("write", buf, slot))
            if n > 0:  # the product warpgroups, after their products
                events.append(("fold", buf ^ 1, slots[n - 1]) + sums_of(n - 1))
            done = (sums_of(n - 1)[1:] if n > 0 and slots[n - 1][0] != slot[0]
                    else None)
        last = len(slots) - 1
        events.append(("barrier",))
        if done is not None:
            events.append(("out",) + done)
        events += store(last, last % 2)
        events.append(("fold", last % 2, slots[last]) + sums_of(last))
        events += [("barrier",), ("out",) + sums_of(last)[1:]]
        yield walk, slots, events


@pytest.mark.parametrize("t", [16000, 12345, 48000, 161, 1])
@pytest.mark.parametrize("batch", [1, 3, 133])
def test_bf16_persistent_walk_holds_each_chunk_until_read(t, batch):
    """Every item is walked once, by one block. Every read of a buffer
    half (the waveform by the Hankel build, the Hankel matrices by the
    products, S by the fold, OUT by the stores) finds the chunk it wants,
    written before a barrier; no half is written again before its last
    read is past a barrier (bulk copies are waited for before it). An
    item's sums take its folds after the previous item of their half
    stored and zeroed them, and are stored past a barrier after its last
    fold; one barrier per slot (and three around the walk)."""
    per_row, n_fb = _bf16_items(t)
    walked = []
    for walk, slots, events in _bf16_walk(t, batch):
        walked += walk
        held, last_read = {}, {}      # (kind, half) -> (slot, barrier)
        sums_user, sums_read = {}, {}  # sums half -> item, barrier of out
        barriers = 0
        products, folded, outs = [], [], []

        def write(kind, half, slot):
            assert last_read.get((kind, half), -1) < barriers
            held[kind, half] = (slot, barriers)

        def read(kind, half, slot):
            assert held[kind, half][0] == slot
            assert held[kind, half][1] < barriers
            last_read[kind, half] = barriers

        for ev in events:
            kind = ev[0]
            if kind == "barrier":
                barriers += 1
            elif kind == "stage":
                write("wave", ev[1], ev[2])
            elif kind == "hankel":
                read("wave", ev[1], ev[2])
                write("hankel", ev[1], ev[2])
            elif kind == "product":
                read("hankel", ev[1], ev[2])
                products.append(ev[2])
            elif kind == "write":
                write("tile", ev[1], ev[2])
            elif kind == "store":
                read("tile", ev[1], ev[2])
            elif kind == "fold":
                read("tile", ev[1], ev[2])
                folded.append(ev[2])
                half, j = ev[4], ev[5]
                if sums_user.get(half) != j:   # the half's first fold of j
                    assert sums_read.get(half, -1) < barriers
                    sums_user[half] = j
                held["sums", j] = (None, barriers)
            elif kind == "out":
                half, j = ev[1], ev[2]
                assert sums_user[half] == j
                assert held["sums", j][1] < barriers  # its folds are done
                sums_read[half] = barriers
                outs.append(j)
        assert products == folded == slots
        assert outs == walk
        assert barriers == len(slots) + 3  # one per slot, 1 before, 2 after
    assert sorted(walked) == list(range(batch * n_fb))


@pytest.mark.parametrize("t", [16000, 12345, 48000, 161, 1])
def test_bf16_out_stores_once_in_aligned_runs(t):
    """Every OUT position of every row in [0, T) is stored by exactly one
    run; with T % 8 == 0 every run is a bulk copy whose global start (for
    every OUT row), smem start and length are 16-byte aligned, else the
    2-byte stores take it."""
    batch, f = 3, 40
    stored = [[0] * t for _ in range(batch)]
    chunk = CB["kChunk"]
    assert (2 * CB["kOutPitch"]) % 16 == 0
    _, n_fb = _bf16_items(t)
    for _, _, events in _bf16_walk(t, batch, f):
        for ev in events:
            if ev[0] != "store":
                continue
            _, buf, (j, ch), lo, hi, s_lo = ev
            assert 0 <= lo < hi <= t
            for pos in range(lo, hi):
                stored[j // n_fb][pos] += 1
            if t % 8 == 0:
                t0 = s_lo + ch * chunk
                assert (lo - t0) % 8 == 0 and (hi - lo) % 8 == 0
                rows = range(2 * f * (j // n_fb), 2 * f * (j // n_fb + 1))
                assert all((row * t + lo) % 8 == 0 for row in rows)
    assert stored == [[1] * t for _ in range(batch)]


def test_bf16_recomputed_halo_within_8_percent():
    for t in (16000, 12345, 48000):
        over = _conv_overhead(t, CB)
        print(f"T={t}: conv work {over:+.1%} over T")
        assert 0 < over <= 0.08, over
