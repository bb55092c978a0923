"""The bf16 backward kernel's schedule, replayed on the CPU.

``leaf_tpu_torch/ops/csrc/fused_frontend_bwd_bf16.cu`` splits the
(32-position window, batch row) chunks of a launch, window-major, into one
contiguous range per block; its producer walks a range in runs of up to
``kRun`` rows of one window, a lane (position) keeping its frames, taps,
windows and d_windows sums in registers through a run and adding the sums
into the block's at the run's end; its consumers flush the tensor-core
accumulators every ``kFlushChunks`` chunks. This file replays those index
rules in Python, with the constants read from the source, and checks what
the kernel relies on: every (row, position) is consumed once; a lane's
frames and taps hold through a run; every d_windows term is added once;
no accumulator runs past 2048 positions between flushes. It also emulates
the kernel's d_windows summation order (f32 sums per lane over a run, the
runs' flushes in order, the wrapper's sum over blocks) and holds it
against ``jax.vjp`` of the JAX op under bf16. The kernel's values are
held against the plain version on the card (tests/test_torch_port_cuda.py).

Tolerance of the emulation: d_windows to 1e-3 of its norm against the JAX
op, the bound of tests/test_torch_port_bf16.py's backward test; to 1e-5
against the plain version, which sums the same bf16 products (exact in
f32) in another order.
"""

import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leaf_tpu.ops import fused_frontend as jfused
from leaf_tpu_torch.ops import fused_frontend as fused

_SRC = Path(fused.__file__).parent / "csrc" / "fused_frontend_bwd_bf16.cu"


def _constants(src: Path = _SRC) -> dict:
    """The source's ``constexpr int`` values (one or more per
    declaration) that are Python expressions too, evaluated in order."""
    env: dict = {}
    for decl in re.findall(r"constexpr int ([^;?]+);", src.read_text()):
        for part in decl.split(","):
            name, expr = part.split("=", 1)
            env[name.strip()] = int(eval(expr.replace("/", "//"), {}, env))
    return env


C = _constants()
T_CASES = [16000, 12345, 48000, 161, 1]
B_CASES = [1, 3, 256]
SMS = 132  # an H100's SMs: the wrapper's grid for one channel group


def _n_blocks(batch: int, t: int, sms: int = SMS) -> int:
    """The wrapper's grid: one block per SM, at most one per chunk."""
    return min(batch * -(-t // C["kChunk"]), sms)


def _ranges(batch: int, t: int, sms: int = SMS):
    """Per block, its chunks [chunk0, chunk0 + n_chunks) of the launch's
    batch * ceil(T / 32), as the kernel splits them."""
    work = batch * -(-t // C["kChunk"])
    grid = _n_blocks(batch, t, sms)
    for x in range(grid):
        chunk0 = work * x // grid
        yield chunk0, work * (x + 1) // grid - chunk0


def _runs(chunk0: int, n_chunks: int, batch: int):
    """The producer's walk of one block: chunk g = window (g // batch),
    row (g % batch); a run starts at the first chunk, at row 0 and after
    kRun rows, and ends at the batch end, after kRun rows and at the
    block's last chunk. Yields (t0, [rows]) per run, in order."""
    run, rows = None, 0
    for it in range(n_chunks):
        g = chunk0 + it
        b, t0 = g % batch, g // batch * C["kChunk"]
        if it == 0 or b == 0 or rows == C["kRun"]:
            run, rows = (t0, []), 0
        assert run[0] == t0
        run[1].append(b)
        rows += 1
        if rows == C["kRun"] or b + 1 == batch or it + 1 == n_chunks:
            yield run
            run = None
    assert run is None


def _first_frame(t: int) -> int:
    return -(-(t - C["kPadL"]) // C["kHop"]) if t > C["kPadL"] else 0


def _lane_terms(t0: int, lane: int, n_frames: int):
    """The (frame, tap) terms lane ``lane`` of window t0 adds for its
    position t (none past T is checked by the caller): taps k0 > k1 > k2
    of frames fa, fa + 1, fa + 2, k2 only if >= 0, and frames past the
    last read as zero dY (staged zero). Also the lane's dY row fd."""
    t = t0 + lane
    fa = _first_frame(t)
    k0 = t + C["kPadL"] - C["kHop"] * fa
    fd = fa - _first_frame(t0)
    f_hi = min(n_frames - 1, (t0 + C["kChunk"] - 1 + C["kPadL"]) // C["kHop"])
    terms = [(fa + j, k0 - C["kHop"] * j) for j in range(3)
             if k0 - C["kHop"] * j >= 0 and fa + j <= f_hi]
    return fd, k0, terms


def test_constants():
    assert C["kChunk"] == 32 and C["kKSteps"] * 16 == C["kChunk"]
    assert C["kFlushChunks"] * C["kChunk"] <= 2048
    assert 1 <= C["kRun"] and C["kChans"] == 40
    assert 4 * (C["kPerWarp3"] + C["kPerWarp2"]) == C["kChans"]
    # setmaxnreg: the block's 512 threads hold 128 registers each
    assert 2 * C["kRegs3"] + C["kRegs2"] + C["kRegsProducer"] <= 4 * 128


@pytest.mark.parametrize("batch", B_CASES)
@pytest.mark.parametrize("t", T_CASES)
def test_every_row_position_consumed_once(t, batch):
    nch = -(-t // C["kChunk"])
    seen = np.zeros((batch, nch), np.int64)
    n_runs = 0
    for chunk0, n_chunks in _ranges(batch, t):
        assert n_chunks >= 1
        for t0, rows in _runs(chunk0, n_chunks, batch):
            n_runs += 1
            assert 1 <= len(rows) <= C["kRun"]
            # consecutive rows of one window
            assert rows == list(range(rows[0], rows[0] + len(rows)))
            seen[rows, t0 // C["kChunk"]] += 1
    assert (seen == 1).all()
    # the windows' positions tile [0, T): each (row, position) once
    cover = np.zeros(t, np.int64)
    for tc in range(nch):
        cover[tc * C["kChunk"]:min(t, (tc + 1) * C["kChunk"])] += 1
    assert (cover == 1).all()
    assert n_runs >= -(-batch // C["kRun"]) * nch


@pytest.mark.parametrize("t", T_CASES)
def test_lane_taps_fixed_within_a_run(t):
    # within a run the window t0 is fixed (checked in _runs) and a lane's
    # frames, taps and dY row are a function of (t0, lane) alone; the
    # chunk's frames fit the kFrames-wide dY row of the 16-byte read
    n_frames = fused.lowpass_frames_out(t, 160, 401, (200, 200))
    for t0 in range(0, t, C["kChunk"]):
        f_lo = _first_frame(t0)
        for lane in range(C["kChunk"]):
            fd, k0, terms = _lane_terms(t0, lane, n_frames)
            assert fd in (0, 1) and C["kPadL"] <= k0 <= 400
            assert all(0 <= f - f_lo < C["kFrames"] for f, _ in terms)
            assert fd + 2 < C["kFrames"]
            # a tap k2 >= 0 needs fd == 0: frame f_lo + 3 meets no position
            # of the chunk
            if k0 >= 2 * C["kHop"]:
                assert fd == 0
        # within a chunk no two lanes add into one (channel, tap)
        taps = [k for lane in range(C["kChunk"])
                for _, k in _lane_terms(t0, lane, n_frames)[2]]
        assert len(taps) == len(set(taps))


@pytest.mark.parametrize("batch", B_CASES)
@pytest.mark.parametrize("t", T_CASES)
def test_every_d_windows_term_added_once(t, batch):
    # a term (b, f, c, k) reads S at t = 160 f + k - 200; every channel
    # takes the same positions, so count (b, f, k) over the runs' flushes
    n_frames = fused.lowpass_frames_out(t, 160, 401, (200, 200))
    want = np.zeros((n_frames, 401), np.int64)
    for f in range(n_frames):
        for k in range(401):
            if 0 <= C["kHop"] * f + k - C["kPadL"] < t:
                want[f, k] = batch
    lane_terms = {}
    got = np.zeros_like(want)
    for chunk0, n_chunks in _ranges(batch, t):
        for t0, rows in _runs(chunk0, n_chunks, batch):
            if t0 not in lane_terms:
                lane_terms[t0] = [
                    _lane_terms(t0, lane, n_frames)[2]
                    for lane in range(C["kChunk"]) if t0 + lane < t]
            # each lane adds its run's sums once, rows each
            for terms in lane_terms[t0]:
                for f, k in terms:
                    got[f, k] += len(rows)
    assert (got == want).all()


@pytest.mark.parametrize("batch", B_CASES)
@pytest.mark.parametrize("t", T_CASES)
def test_accumulators_flushed_every_2048_positions(t, batch):
    # the consumers flush after chunk it when (it + 1) % kFlushChunks == 0
    # and after the last
    longest = 0
    for _, n_chunks in _ranges(batch, t):
        flushes = [it for it in range(n_chunks)
                   if (it + 1) % C["kFlushChunks"] == 0 or it + 1 == n_chunks]
        gaps = np.diff([-1] + flushes)
        assert flushes[-1] == n_chunks - 1
        longest = max(longest, int(gaps.max()) * C["kChunk"])
    assert 0 < longest <= 2048


# ------------------------------------- the d_windows summation order

def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a)).bfloat16().float().numpy()


def _emulate_d_windows(conv, dy, batch, t, f, sms):
    """d_windows as the kernel sums it: per block and run, each lane's f32
    sums over the run's rows in order (bf16(dY) * bf16(S) products, exact
    in f32, so the fused multiply-add rounds as an add), added into the
    block's sums at the run's end; then the wrapper's sum over blocks."""
    n_frames = dy.shape[1]
    s = conv[:, :f].astype(np.float32) ** 2 + conv[:, f:].astype(np.float32) ** 2
    s = _bf16(s)                                      # (B, F, T)
    dyr = _bf16(dy)                                   # (B, n_frames, F)
    parts = []
    for chunk0, n_chunks in _ranges(batch, t, sms):
        dws = np.zeros((f, 401), np.float32)
        for t0, rows in _runs(chunk0, n_chunks, batch):
            for lane in range(C["kChunk"]):
                if t0 + lane >= t:
                    continue  # OUT staged as zero: S = 0, the sums add 0
                for fr, k in _lane_terms(t0, lane, n_frames)[2]:
                    acc = np.zeros(f, np.float32)
                    for b in rows:
                        acc = acc + dyr[b, fr, :] * s[b, :, t0 + lane]
                    dws[:, k] = dws[:, k] + acc
        parts.append(dws)
    return torch.from_numpy(np.stack(parts)).sum(0).numpy()


# B = kRun + 3 rows: runs cut at kRun rows and at the batch end; 5 blocks
# start mid-run and mid-window, 132 blocks split windows over blocks
EMU_B, EMU_T, EMU_F = 35, 1000, 8


@functools.lru_cache(maxsize=None)
def _emu_case():
    rng = np.random.RandomState(0)
    x = rng.randn(EMU_B, EMU_T).astype("float32") * 0.1
    gabor = rng.randn(401, 2 * EMU_F).astype("float32") * 0.05
    windows = np.abs(rng.randn(EMU_F, 401)).astype("float32") * 0.01
    n_frames = fused.lowpass_frames_out(EMU_T, 160, 401, (200, 200))
    dy = rng.randn(EMU_B, n_frames, EMU_F).astype("float32")

    def op(w):
        return jfused.fused_gabor_sqmod_lowpass(
            jnp.asarray(x).astype(jnp.bfloat16),
            jnp.asarray(gabor).astype(jnp.bfloat16), w, 160, (200, 200), True)

    # jitted: the interpret-mode kernels trace once (~3 s, not ~20 eagerly)
    d_win = jax.jit(lambda w, d: jax.vjp(op, w)[1](d)[0])(
        jnp.asarray(windows), jnp.asarray(dy))
    xb = torch.from_numpy(x).bfloat16()
    _, conv = fused.fused_forward_saving_reference(
        xb, torch.from_numpy(gabor).bfloat16(), torch.from_numpy(windows))
    _, plain = fused.fused_backward_reference(
        xb, conv, torch.from_numpy(windows), torch.from_numpy(dy))
    return conv.float().numpy(), dy, np.asarray(d_win), plain.numpy()


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("sms", [5, SMS])
def test_d_windows_order_matches_jax(sms):
    conv, dy, ref, plain = _emu_case()
    got = _emulate_d_windows(conv, dy, EMU_B, EMU_T, EMU_F, sms)
    rj, rp = _rel(got, ref), _rel(got, plain)
    print(f"sms={sms}: d_windows rel vs JAX {rj:.3e}, vs plain {rp:.3e}")
    assert rj <= 1e-3 and rp <= 1e-5, (rj, rp)
