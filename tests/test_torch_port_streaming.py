"""The port's streaming frontend (leaf_tpu_torch.frontend.streaming) against
the JAX package's ``LeafStreamer``, on the CPU.

The same seeded waveforms go through the JAX streamer and the port's,
with the JAX Leaf's weights carried by ``load_jax_variables`` (a 16-filter
Leaf, the unfused 'off' path on both sides). Frames agree at
tests/test_streaming.py's TOL (rtol 2e-5, atol 2e-6): the streamed sPCEN
composes two closed-form EMAs where offline uses one, and torch's and
XLA's convolutions sum in other orders. The cases: chunks of 640 (the
minimum), 1600 and 16000 samples, a flush remainder, preemphasis, no
PCEN, a flush-only stream, a chunk past 256 frames (the EMA's scan form)
and a stream after ``reset``; bf16 compute against the JAX bf16 streamer
at tests/test_torch_port_bf16.py's frontend bound (2e-5 of max|frames|).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leaf_tpu.frontend import Leaf as JaxLeaf
from leaf_tpu.frontend.streaming import LeafStreamer as JaxStreamer
from leaf_tpu.frontend.streaming import streaming_geometry as jax_geometry
from leaf_tpu_torch.frontend import (Leaf, LeafStreamer, StreamingLeafCell,
                                     streaming_geometry)
from leaf_tpu_torch.models import load_jax_variables

TOL = dict(rtol=2e-5, atol=2e-6)
BF16_TOL = 2e-5
N_FILTERS = 16


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads, as tests/test_torch_port_cli.py runs its
    CLIs: the test runner shares the cores among its workers, and torch's
    default of one thread per core oversubscribes them (its many small
    ops then wait on each other's threads)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _np_tree(v):
    return jax.tree_util.tree_map(np.asarray, dict(v))


def _wave(b, t, seed):
    return (np.random.RandomState(seed).randn(b, t) * 0.1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _pair(preemp=False, pcen=True, bf16=False):
    """(JAX Leaf, its variables, the port Leaf holding them)."""
    kw = dict(n_filters=N_FILTERS, preemp=preemp, pcen_compression=pcen,
              use_fused_kernel="off")
    jm = JaxLeaf(compute_dtype=jnp.bfloat16 if bf16 else jnp.float32, **kw)
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 16000)))
    pm = load_jax_variables(
        Leaf(compute_dtype=torch.bfloat16 if bf16 else torch.float32,
             device="cpu", **kw), _np_tree(v))
    return jm, v, pm


def _stream(streamer, wave, chunk):
    n = wave.shape[1] // chunk
    outs = [np.asarray(streamer.process(wave[:, i * chunk:(i + 1) * chunk]))
            for i in range(n)]
    rem = wave[:, n * chunk:]
    outs.append(np.asarray(streamer.flush(rem if rem.shape[1] else None)))
    return np.concatenate(outs, axis=1)


@pytest.mark.parametrize("kernel, stride", [(401, 160), (401, 80),
                                            (201, 160), (551, 220)])
def test_geometry_matches_jax(kernel, stride):
    assert streaming_geometry(kernel, stride) == jax_geometry(kernel, stride)


def test_even_kernel_refused():
    with pytest.raises(ValueError, match="odd"):
        streaming_geometry(552, 220)


# name: (pair options, stream length, chunk)
CASES = {
    "chunk640_remainder": ({}, 8160, 640),
    "chunk1600": ({}, 16000, 1600),
    "chunk16000_remainder": ({}, 19200, 16000),
    "preemp_remainder": ({"preemp": True}, 8160, 1600),
    "no_pcen": ({"pcen": False}, 16000, 1600),
    "flush_only": ({}, 1280, 1600),
    "scan_past_256_frames": ({}, 48000, 48000),
}


@pytest.mark.parametrize("case", list(CASES))
def test_streamer_matches_jax(case):
    opts, t, chunk = CASES[case]
    jm, v, pm = _pair(**opts)
    wave = _wave(2, t, seed=len(case))
    ref = _stream(JaxStreamer(jm, v, chunk_size=chunk), wave, chunk)
    got = _stream(LeafStreamer(pm, chunk), wave, chunk)
    assert got.shape == ref.shape == (2, t // 160, N_FILTERS)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("preemp", [False, True])
def test_streamed_matches_offline(preemp):
    _, _, pm = _pair(preemp=preemp)
    wave = _wave(3, 16160, seed=5)
    with torch.no_grad():
        offline = pm(torch.from_numpy(wave)).numpy()
    got = _stream(LeafStreamer(pm, 1600), wave, 1600)
    np.testing.assert_allclose(got, offline, **TOL)


def test_reset_replays_the_stream():
    jm, v, pm = _pair()
    wave = _wave(2, 4800, seed=6)
    streamer = LeafStreamer(pm, 1600)
    first = _stream(streamer, wave, 1600)
    streamer.reset()
    again = _stream(streamer, wave, 1600)
    np.testing.assert_array_equal(again, first)
    np.testing.assert_allclose(
        again, _stream(JaxStreamer(jm, v, chunk_size=1600), wave, 1600),
        **TOL)


def test_bf16_streamer_matches_jax():
    jm, v, pm = _pair(bf16=True)
    wave = _wave(2, 8160, seed=7)
    ref = _stream(JaxStreamer(jm, v, chunk_size=1600), wave, 1600)
    got = _stream(LeafStreamer(pm, 1600), wave, 1600)
    assert got.dtype == ref.dtype == np.float32
    gap = float(np.abs(got - ref).max() / np.abs(ref).max())
    assert gap < BF16_TOL, gap


def test_streamer_errors_match_jax():
    jm, v, pm = _pair()
    for make in (lambda c: JaxStreamer(jm, v, chunk_size=c),
                 lambda c: LeafStreamer(pm, c)):
        with pytest.raises(ValueError, match="multiple of the hop"):
            make(1000)
        with pytest.raises(ValueError, match="≥ 640"):
            make(480)
        st = make(1600)
        with pytest.raises(ValueError, match="expected"):
            st.process(np.zeros((2, 800), np.float32))
        with pytest.raises(ValueError, match="stream too short"):
            st.flush(np.zeros((2, 320), np.float32))
        st.process(np.zeros((2, 1600), np.float32))
        with pytest.raises(ValueError, match="flush remainder"):
            st.flush(np.zeros((2, 1600), np.float32))
        st.flush()
        with pytest.raises(RuntimeError, match="already flushed"):
            st.process(np.zeros((2, 1600), np.float32))


def test_mean_var_norm_refused():
    leaf = Leaf(n_filters=4, mean_var_norm=True, device="cpu")
    with pytest.raises(ValueError, match="mean_var_norm"):
        LeafStreamer(leaf, 1600)
    with pytest.raises(ValueError, match="mean_var_norm"):
        StreamingLeafCell(leaf)


def test_cell_shares_the_leaf_parameters():
    # the cell reads the Leaf's own Parameter objects: an update of the
    # Leaf shows in the next chunk, and no parameter is copied
    _, _, pm = _pair()
    cell = StreamingLeafCell(pm)
    assert ({id(p) for p in cell.parameters()}
            == {id(p) for p in pm.parameters()})
    conv, pool = cell._stages
    assert conv._kernel is pm._complex_conv._kernel
    assert pool.weights is pm._pooling.weights
    assert conv.padding == pool.padding == (0, 0)
    assert pm._complex_conv.padding == pm._pooling.padding == (200, 200)
