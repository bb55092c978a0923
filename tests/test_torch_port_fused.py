"""The port's fused frontend op (leaf_tpu_torch.ops.fused_frontend) held
against the JAX op.

On the CPU the port's op runs its plain PyTorch versions (forward,
residual-saving forward, backward); the JAX op runs its Pallas kernels in
interpret mode, as tests/test_ops.py runs them, on the same RandomState(0)
inputs. Tolerances are tests/test_ops.py's: forward atol 1e-6 / rtol
1e-5, gradients rel-norm 1e-5; Leaf 'on' vs JAX Leaf 'on' at 1e-4 for
features and every parameter gradient (test_ops.py:141-169). The CUDA
kernels have no CPU mode: tests/test_torch_port_cuda.py and chip_smoke.py
hold them against these plain versions on the card.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as tF
from torch.nn import grad as nn_grad

from leaf_tpu.frontend import Leaf as JaxLeaf
from leaf_tpu.ops import fused_frontend as jfused
from leaf_tpu_torch.frontend import Leaf
from leaf_tpu_torch.models import load_jax_variables
from leaf_tpu_torch.models.jax_import import _frontend_route
from leaf_tpu_torch.ops import fused_frontend as fused

F, K = 40, 401


def _make_inputs():
    rng = np.random.RandomState(0)
    x = rng.randn(4, 16000).astype("float32") * 0.1
    gabor = rng.randn(K, 2 * F).astype("float32") * 0.05
    windows = np.abs(rng.randn(F, K)).astype("float32") * 0.01
    return x, gabor, windows


@pytest.fixture
def inputs():
    return _make_inputs()


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
    """The op's backward: the waveform gradient is exactly zero (the JAX
    op's contract, not autograd through the plain forward), and the bank
    and window gradients are autograd's through the plain forward."""
    x, gabor, windows = (torch.from_numpy(a) for a in inputs)
    x.requires_grad_(True)
    gabor.requires_grad_(True)
    windows.requires_grad_(True)
    dy = torch.from_numpy(np.random.RandomState(5).randn(4, 100, F)
                          .astype("float32"))
    dx, dg, dw = torch.autograd.grad(
        fused.fused_gabor_sqmod_lowpass(x, gabor, windows), (x, gabor, windows),
        dy)
    assert dx.shape == x.shape and not dx.abs().max()
    rg, rw = torch.autograd.grad(fused.fused_reference(x, gabor, windows),
                                 (gabor, windows), dy)
    torch.testing.assert_close(dg, rg, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dw, rw, rtol=1e-5, atol=1e-6)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _grad_inputs(t, f):
    """test_ops.py's backward inputs: B=2, the first t samples, f channels."""
    x, gabor, windows = _make_inputs()
    return (x[:2, :t],) + _sub_bank(gabor, windows, f)


@functools.lru_cache(maxsize=None)
def _jax_grads(t, f):
    """jax.grad of Σ sin(0.1·out) through the Pallas op (interpret mode),
    for (x, bank, windows)."""
    def jloss(xx, g, w):
        o = jfused.fused_gabor_sqmod_lowpass(xx, g, w, 160, (200, 200), True)
        return jnp.sum(jnp.sin(o * 0.1))

    return tuple(np.asarray(g) for g in jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in _grad_inputs(t, f))))


@pytest.mark.parametrize("f", [40, 24])
@pytest.mark.parametrize("t", [16000, 12345])
def test_grads_match_jax_grad(t, f):
    # jax.grad through the Pallas op (interpret mode) vs the port's
    # backward (its plain version on the CPU): the loss of test_ops.py
    x, gabor, windows = _grad_inputs(t, f)
    ref = _jax_grads(t, f)
    tx, tg, tw = (torch.from_numpy(a).requires_grad_() for a in
                  (x, gabor, windows))
    loss = torch.sum(torch.sin(fused.fused_gabor_sqmod_lowpass(tx, tg, tw)
                               * 0.1))
    got = torch.autograd.grad(loss, (tx, tg, tw))
    assert not got[0].abs().max() and not np.abs(np.asarray(ref[0])).max()
    for a, b in zip(got[1:], ref[1:]):
        assert a.shape == b.shape
        assert _rel(a.numpy(), np.asarray(b)) < 1e-5


def _rna_tf32(a):
    """Round float32 to TF32 (10 stored mantissa bits), to nearest with
    ties away from zero: cvt.rna.tf32.f32, through the int32 view."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.int32)
    return ((bits + 0x1000) & np.int32(-0x2000)).view(np.float32)


def _split_tf32(a):
    hi = _rna_tf32(a)
    return hi, _rna_tf32(a - hi)


@pytest.mark.parametrize("t", [16000, 12345])
def test_tf32x3_bank_gradient_matches_jax_grad(t):
    """The backward kernel's arithmetic on the CPU: the d_bank correlation
    from TF32 hi/lo splits of xpad and dOUT, hi·hi + hi·lo + lo·hi summed in
    float32 (exact products: TF32 × TF32 fits in float32), against the JAX
    op's bank gradient; one TF32 product (hi·hi) reads ≥ 10× worse."""
    x, gabor, windows = (torch.from_numpy(a) for a in _grad_inputs(t, F))
    out, conv = fused.fused_forward_saving_reference(x, gabor, windows)
    dy = 0.1 * torch.cos(0.1 * out)          # d/d out of Σ sin(0.1·out)
    s_pad = tF.pad(conv[:, :F] ** 2 + conv[:, F:] ** 2, (200, 200))
    d_s = nn_grad.conv1d_input(s_pad.shape, windows[:, None, :],
                               dy.transpose(1, 2), stride=160,
                               groups=F)[..., 200:200 + t]
    d_conv = 2.0 * conv * torch.cat([d_s, d_s], dim=1)   # dOUT (B, 2F, T)
    xh, xl = _split_tf32(tF.pad(x, (200, 200)).numpy())
    dh, dl = _split_tf32(d_conv.numpy())

    def corr(xs, ds):  # Σ_{b,t} xs[b, t + j]·ds[b, col, t] in float32
        return nn_grad.conv1d_weight(torch.from_numpy(xs)[:, None, :],
                                     (2 * F, 1, K),
                                     torch.from_numpy(ds))[:, 0].T.numpy()

    one = corr(xh, dh)
    three = one + corr(xh, dl) + corr(xl, dh)
    ref = _jax_grads(t, F)[1]
    assert three.shape == ref.shape == (K, 2 * F)
    rel3, rel1 = _rel(three, ref), _rel(one, ref)
    print(f"T={t}: d_bank vs JAX, 3×TF32 {rel3:.3e}, 1×TF32 {rel1:.3e}")
    assert rel3 < 1e-5, rel3
    assert rel1 >= 10 * rel3, (rel1, rel3)


@functools.lru_cache(maxsize=None)
def _jax_forward(t):
    """The JAX op's forward (Pallas, interpret mode) at B=2, F=40."""
    return np.asarray(jfused.fused_gabor_sqmod_lowpass(
        *(jnp.asarray(a) for a in _grad_inputs(t, F)), 160, (200, 200), True))


@pytest.mark.parametrize("t", [16000, 12345])
def test_tf32x3_forward_matches_jax(t):
    """The forward kernels' arithmetic on the CPU: OUT from TF32 hi/lo
    splits of xpad and the bank, hi·hi + hi·lo + lo·hi summed in float32,
    then |·|² and the lowpass, against the JAX op at
    test_plain_matches_jax_op's tolerance; one TF32 product (hi·hi)
    reads ≥ 10× worse in rel-norm."""
    x, gabor, windows = _grad_inputs(t, F)
    xh, xl = (torch.from_numpy(a)[:, None, :]
              for a in _split_tf32(np.pad(x, ((0, 0), (200, 200)))))
    gh, gl = (torch.from_numpy(a.T.copy())[:, None, :]
              for a in _split_tf32(gabor))
    one = tF.conv1d(xh, gh)                                 # OUT (B, 2F, T)
    three = one + tF.conv1d(xh, gl) + tF.conv1d(xl, gh)
    w = torch.from_numpy(windows)
    out1, out3 = (fused._sqmod_lowpass(o, w, 160, (200, 200)).numpy()
                  for o in (one, three))
    ref = _jax_forward(t)
    assert out3.shape == ref.shape == (2, fused.lowpass_frames_out(
        t, 160, K, (200, 200)), F)
    rel3, rel1 = _rel(out3, ref), _rel(out1, ref)
    print(f"T={t}: out vs JAX, 3×TF32 {rel3:.3e}, 1×TF32 {rel1:.3e}")
    np.testing.assert_allclose(out3, ref, atol=1e-6, rtol=1e-5)
    assert rel1 >= 10 * rel3, (rel1, rel3)


@pytest.mark.parametrize("t", [16000, 12345, 161, 1])
def test_backward_reference_matches_autograd(inputs, t):
    # the plain backward from its formulas vs autograd through the plain
    # forward; and the saving forward's out is the plain forward's
    x, gabor, windows = (torch.from_numpy(a) for a in inputs)
    x = x[:2, :t]
    out, conv = fused.fused_forward_saving_reference(x, gabor, windows)
    assert conv.shape == (2, 2 * F, t)
    torch.testing.assert_close(out, fused.fused_reference(x, gabor, windows),
                               rtol=0, atol=0)
    dy = torch.from_numpy(np.random.RandomState(6).randn(*out.shape)
                          .astype("float32"))
    d_bank, d_win = fused.fused_backward_reference(x, conv, windows, dy)
    g, w = gabor.clone().requires_grad_(), windows.clone().requires_grad_()
    rg, rw = torch.autograd.grad(fused.fused_reference(x, g, w), (g, w), dy)
    assert _rel(d_bank.numpy(), rg.numpy()) < 1e-6
    assert _rel(d_win.numpy(), rw.numpy()) < 1e-6


def test_backward_honours_needs_input_grad(inputs):
    x, gabor, windows = (torch.from_numpy(a) for a in inputs)
    w = windows.clone().requires_grad_()
    fused.fused_gabor_sqmod_lowpass(x, gabor, w).sum().backward()
    assert w.grad is not None and gabor.grad is None and x.grad is None


def test_no_grad_takes_the_primal_path(inputs, monkeypatch):
    # under no_grad the op saves nothing: the residual-saving path is not
    # entered even when a parameter requires a gradient
    x, gabor, windows = (torch.from_numpy(a) for a in inputs)
    monkeypatch.setattr(fused, "fused_forward_saving_reference", None)
    with torch.no_grad():
        out = fused.fused_gabor_sqmod_lowpass(x, gabor.requires_grad_(),
                                              windows)
    assert not out.requires_grad


def _np_tree(variables):
    return jax.tree_util.tree_map(np.asarray, dict(variables))


def assert_grads_match(module, jax_grads, tol):
    """Every parameter's .grad vs the JAX gradient tree, rel-norm < tol."""
    names = [n for n, _ in module.named_parameters()]
    assert len(names) == len(jax.tree_util.tree_leaves(jax_grads)), names
    for name, p in module.named_parameters():
        tree, path, _ = _frontend_route(name)
        ref = jax_grads[tree]
        for k in path:
            ref = ref[k]
        ref = np.asarray(ref)
        got = p.grad.numpy().reshape(ref.shape)
        assert _rel(got, ref) < tol, (name, _rel(got, ref))


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

    def test_on_train_gradients_match_jax_on(self):
        # every parameter's gradient, port Leaf 'on' (saving forward +
        # backward, plain versions) vs JAX Leaf 'on' (Pallas, interpret)
        x = (np.random.RandomState(2).randn(2, 16000) * 0.1).astype("float32")
        jm = JaxLeaf(use_fused_kernel="on")
        v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
        ref = jax.grad(lambda p: jnp.mean(jm.apply(p, jnp.asarray(x)) ** 2))(v)
        pm = load_jax_variables(Leaf(use_fused_kernel="on", device="cpu"),
                                _np_tree(v))
        torch.mean(pm(torch.from_numpy(x)) ** 2).backward()
        assert_grads_match(pm, ref, 1e-4)

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
