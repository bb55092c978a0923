"""The port's fused frontend op (leaf_tpu_torch.ops.fused_frontend) held
against the JAX op.

On the CPU the port's op runs its plain PyTorch version; the JAX op runs
its Pallas kernel in interpret mode, as tests/test_ops.py runs it, on the
same RandomState(0) inputs. Tolerance atol 1e-6 / rtol 1e-5 (the one
tests/test_ops.py holds the Pallas kernel to); Leaf 'on' vs JAX Leaf 'on'
at 1e-4, as test_ops.py:141-149 holds fused vs unfused Leaf. The CUDA
kernel itself has no CPU mode: tests/test_torch_port_cuda.py and
chip_smoke.py hold it against this plain version on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leaf_tpu.frontend import Leaf as JaxLeaf
from leaf_tpu.ops import fused_frontend as jfused
from leaf_tpu_torch.frontend import Leaf
from leaf_tpu_torch.models import load_jax_variables
from leaf_tpu_torch.ops import fused_frontend as fused

F, K = 40, 401


@pytest.fixture
def inputs():
    rng = np.random.RandomState(0)
    x = rng.randn(4, 16000).astype("float32") * 0.1
    gabor = rng.randn(K, 2 * F).astype("float32") * 0.05
    windows = np.abs(rng.randn(F, K)).astype("float32") * 0.01
    return x, gabor, windows


def _sub_bank(gabor, windows, f):
    return (np.concatenate([gabor[:, :f], gabor[:, F:F + f]], axis=1),
            windows[:f])


@pytest.mark.parametrize("f", [40, 24])
@pytest.mark.parametrize("t", [16000, 12345, 48000])
def test_plain_matches_jax_op(inputs, t, f):
    x, gabor, windows = inputs
    x = np.tile(x, (1, 3))[:, :t]
    gabor, windows = _sub_bank(gabor, windows, f)
    ref = np.asarray(jfused.fused_gabor_sqmod_lowpass(
        jnp.asarray(x), jnp.asarray(gabor), jnp.asarray(windows), 160,
        (200, 200), True))
    got = fused.fused_gabor_sqmod_lowpass(
        torch.from_numpy(x), torch.from_numpy(gabor), torch.from_numpy(windows))
    assert got.shape == ref.shape == (
        4, fused.lowpass_frames_out(t, 160, K, (200, 200)), f)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=1e-5)


def test_frames_out_matches_jax():
    for t in (1, 160, 161, 12345, 16000, 48000):
        assert (fused.lowpass_frames_out(t, 160, K, (200, 200))
                == jfused.lowpass_frames_out(t, 160, K, (200, 200)))


@pytest.mark.parametrize("stride,pad,k", [(128, (200, 200), K),
                                          (160, (100, 100), K),
                                          (160, (200, 200), 400)])
def test_geometry_guard(inputs, stride, pad, k):
    x, gabor, windows = (torch.from_numpy(a) for a in inputs)
    with pytest.raises(ValueError, match="specialized"):
        fused.fused_gabor_sqmod_lowpass(x, gabor[:k], windows[:, :k], stride,
                                        pad)


def test_cuda_wrapper_refuses_cpu_tensors(inputs):
    # the kernel wrapper never falls back to the plain version
    before = fused.fused_forward_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        fused.fused_forward_cuda(*(torch.from_numpy(a) for a in inputs))
    assert fused.fused_forward_cuda.launches == before


def test_backward_raises(inputs):
    x, gabor, windows = (torch.from_numpy(a) for a in inputs)
    gabor.requires_grad_(True)
    out = fused.fused_gabor_sqmod_lowpass(x, gabor, windows)
    with pytest.raises(NotImplementedError, match="training slice"):
        out.sum().backward()


def _np_tree(variables):
    return jax.tree_util.tree_map(np.asarray, dict(variables))


class TestLeafFused:
    def test_on_matches_jax_on(self):
        x = (np.random.RandomState(1).randn(2, 16000) * 0.1).astype("float32")
        jm = JaxLeaf(use_fused_kernel="on")
        v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
        ref = np.asarray(jm.apply(v, jnp.asarray(x)))
        pm = load_jax_variables(Leaf(use_fused_kernel="on", device="cpu"),
                                _np_tree(v))
        with torch.no_grad():
            got = pm(torch.from_numpy(x)).numpy()
            off = Leaf(use_fused_kernel="off", device="cpu")
            off.load_state_dict(pm.state_dict())
            got_off = off(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got, got_off, atol=1e-4, rtol=1e-4)

    def test_auto_on_cpu_takes_the_plain_path(self):
        before = fused.fused_forward_cuda.launches
        x = torch.zeros(2, 16000)
        assert not Leaf(device="cpu")._fused_applicable(x)
        assert Leaf(use_fused_kernel="on", device="cpu")._fused_applicable(x)
        assert fused.fused_forward_cuda.launches == before

    def test_on_with_unsupported_geometry_raises(self):
        x = torch.zeros(2, 16000)
        for kw in ({"preemp": True}, {"window_stride": 8.0},
                   {"window_len": 20.0}):
            with pytest.raises(ValueError):
                Leaf(use_fused_kernel="on", device="cpu", **kw)(x)
        with pytest.raises(ValueError):
            Leaf(use_fused_kernel="sometimes", device="cpu")
