"""bf16 compute (``compute_dtype: bfloat16``, ``train --bf16``) in the port,
held against the JAX package's bf16 path on the CPU.

Inputs are made from ``RandomState`` seeds with numpy and handed to both
packages. The JAX fused op runs its Pallas kernels in interpret mode, as
tests/test_ops.py runs them; each JAX result is computed once per module.

Tolerances, with what this CPU measured when they were set:

- the plain bf16 forward and saving forward vs the JAX op (x and the bank
  bf16, the windows f32): atol 1e-6 / rtol 1e-5, the f32 tolerance (the
  bf16 products are exact in f32);
- the plain bf16 backward vs ``jax.vjp`` of the JAX op: d_bank (bf16) and
  d_windows (f32) to 1e-3 of their norm (measured ≤ 1.8e-4 and 4.7e-5);
  the f32 backward on the same operands, with none of the JAX op's bf16
  rounding points, misses that bound (measured ≥ 2.3e-3), so the bound
  guards the rounding points;
- Leaf in bf16 vs JAX's Leaf in bf16, 'on' and 'off': features to 2e-5
  of max|feature| (measured ≤ 2.8e-6), each frontend leaf's gradient to
  5e-3 of its norm (measured ≤ 1.3e-3, the Gabor kernel under 'off');
- XLA's bf16 sigmoid and silu, and optax's bf16 loss: exactly.

The whole model under bf16 is held in tests/test_torch_port_bf16_model.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from leaf_tpu.frontend import Leaf as JaxLeaf
from leaf_tpu.ops import fused_frontend as jfused
from leaf_tpu_torch.frontend import Leaf, get_frontend
from leaf_tpu_torch.frontend.helper import compute_dtype_of
from leaf_tpu_torch.models import common, get_classifier, load_jax_variables
from leaf_tpu_torch.models.jax_import import _frontend_route
from leaf_tpu_torch.ops import fused_frontend as fused
from leaf_tpu_torch.training import cross_entropy_loss

K = 401
BF16 = torch.bfloat16
CFG = {"frontend": {"name": "leaf", "default_args": True},
       "audio_config": {"sample_rate": 16000},
       "model": {"arch": "efficientnet", "model_depth": "b0",
                 "num_classes": 35}}
OPS_SHAPES = [(40, 16000), (8, 12345)]


def _bf16_cfg(cfg):
    return {**cfg,
            "frontend": {**cfg["frontend"], "compute_dtype": "bfloat16"},
            "model": {**cfg["model"], "compute_dtype": "bfloat16"}}


def _np_tree(variables):
    return jax.tree_util.tree_map(np.asarray, dict(variables))


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _to_np(t):
    return t.detach().float().numpy()


def _jbf16(a):
    return jnp.asarray(a).astype(jnp.bfloat16)


# ------------------------------------------------------------ the fused op

@functools.lru_cache(maxsize=None)
def _op_case(f, t):
    """Seeded operands (x and the bank rounded to bf16, the windows f32,
    dY f32) and the JAX op's bf16 results: forward out, and d_bank
    (bf16), d_windows (f32) from ``jax.vjp`` (Pallas, interpret mode)."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, t).astype("float32") * 0.1
    gabor = rng.randn(K, 2 * f).astype("float32") * 0.05
    windows = np.abs(rng.randn(f, K)).astype("float32") * 0.01
    n_frames = fused.lowpass_frames_out(t, 160, K, (200, 200))
    dy = rng.randn(2, n_frames, f).astype("float32")

    def op(g, w):
        return jfused.fused_gabor_sqmod_lowpass(_jbf16(x), g, w, 160,
                                                (200, 200), True)

    out, vjp = jax.vjp(op, _jbf16(gabor), jnp.asarray(windows))
    d_bank, d_win = vjp(jnp.asarray(dy))
    assert d_bank.dtype == jnp.bfloat16 and d_win.dtype == jnp.float32
    ops = (torch.from_numpy(x).to(BF16), torch.from_numpy(gabor).to(BF16),
           torch.from_numpy(windows), torch.from_numpy(dy))
    return ops, (np.asarray(out), np.asarray(d_bank.astype(jnp.float32)),
                 np.asarray(d_win))


@pytest.mark.parametrize("f,t", OPS_SHAPES)
def test_bf16_forwards_match_jax(f, t):
    (x, gabor, windows, _), (ref, _, _) = _op_case(f, t)
    out = fused.fused_reference(x, gabor, windows)
    s_out, conv = fused.fused_forward_saving_reference(x, gabor, windows)
    assert out.dtype == s_out.dtype == torch.float32
    assert conv.dtype == BF16 and conv.shape == (2, 2 * f, t)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(s_out, out, rtol=0, atol=0)
    # OUT is the f32 conv sums rounded once; out is formed before that
    want = torch.nn.functional.conv1d(
        torch.nn.functional.pad(x.float()[:, None], (200, 200)),
        gabor.float().T[:, None, :])
    assert torch.equal(conv, want.to(BF16))
    # the op itself (no gradient wanted) takes the primal plain version
    torch.testing.assert_close(fused.fused_gabor_sqmod_lowpass(
        x, gabor, windows), out, rtol=0, atol=0)


@pytest.mark.parametrize("f,t", OPS_SHAPES)
def test_bf16_backward_matches_jax_vjp(f, t):
    (x, gabor, windows, dy), (_, ref_bank, ref_win) = _op_case(f, t)
    _, conv = fused.fused_forward_saving_reference(x, gabor, windows)
    d_bank, d_win = fused.fused_backward_reference(x, conv, windows, dy)
    assert d_bank.dtype == BF16 and d_win.dtype == torch.float32
    rb, rw = _rel(_to_np(d_bank), ref_bank), _rel(_to_np(d_win), ref_win)
    print(f"F={f} T={t}: d_bank rel {rb:.3e}, d_windows rel {rw:.3e}")
    assert rb <= 1e-3 and rw <= 1e-3, (rb, rw)


@pytest.mark.parametrize("f,t", OPS_SHAPES)
def test_f32_backward_misses_the_bf16_bound(f, t):
    # the same operands through the f32 backward (no bf16 rounding of dY,
    # the windows of dS, S or dOUT): the 1e-3 bound above sees the
    # difference, so it holds the rounding points and not just the sums
    (x, gabor, windows, dy), (_, ref_bank, ref_win) = _op_case(f, t)
    _, conv = fused.fused_forward_saving_reference(x, gabor, windows)
    d_bank, d_win = fused.fused_backward_reference(x.float(), conv.float(),
                                                   windows, dy)
    rb, rw = _rel(_to_np(d_bank), ref_bank), _rel(_to_np(d_win), ref_win)
    print(f"F={f} T={t} f32 backward: d_bank rel {rb:.3e}, d_windows rel "
          f"{rw:.3e}")
    assert max(rb, rw) > 1e-3, (rb, rw)


def test_bf16_op_under_autograd():
    # the autograd.Function on bf16 operands: a zero waveform gradient,
    # d_bank in bf16 (the bank's dtype) and d_windows in f32, as the
    # plain backward gives them; an f32 bank parameter cast to bf16 gets
    # its gradient back in f32 through the cast
    (x, gabor, windows, dy), _ = _op_case(40, 16000)
    g32 = gabor.float().requires_grad_()
    w = windows.clone().requires_grad_()
    xr = x.clone().requires_grad_()
    out = fused.fused_gabor_sqmod_lowpass(xr, g32.to(BF16), w)
    dx, dg, dw = torch.autograd.grad(out, (xr, g32, w), dy)
    assert dx.dtype == BF16 and not dx.abs().max()
    _, conv = fused.fused_forward_saving_reference(x, gabor, windows)
    rb, rw = fused.fused_backward_reference(x, conv, windows, dy)
    assert dg.dtype == torch.float32 and torch.equal(dg, rb.float())
    assert torch.equal(dw, rw)


@pytest.mark.parametrize("case", ["bank f32", "windows bf16", "x float16",
                                  "OUT f32", "dY bf16"])
def test_operand_sets_other_than_f32_or_bf16_raise(case):
    (x, gabor, windows, dy), _ = _op_case(8, 12345)
    _, conv = fused.fused_forward_saving_reference(x, gabor, windows)
    fwd = {"bank f32": (x, gabor.float(), windows),
           "windows bf16": (x, gabor, windows.to(BF16)),
           "x float16": (x.half(), gabor, windows)}
    with pytest.raises(TypeError, match="float32 throughout"):
        if case in fwd:
            fused.fused_reference(*fwd[case])
        elif case == "OUT f32":
            fused.fused_backward_reference(x, conv.float(), windows, dy)
        else:
            fused.fused_backward_reference(x, conv, windows, dy.to(BF16))


# ------------------------------------------------------------------ Leaf

LEAF_FEATURE_TOL, LEAF_GRAD_TOL = 2e-5, 5e-3


@functools.lru_cache(maxsize=None)
def _leaf_case(mode):
    """JAX Leaf(compute_dtype=bf16) features and the gradient of
    mean(features²) for every frontend leaf, at B=2 × 16000."""
    x = (np.random.RandomState(1).randn(2, 16000) * 0.1).astype("float32")
    jm = JaxLeaf(compute_dtype=jnp.bfloat16, use_fused_kernel=mode)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    feats = np.asarray(jm.apply(v, jnp.asarray(x)))
    grads = jax.grad(lambda p: jnp.mean(jm.apply(p, jnp.asarray(x)) ** 2))(v)
    return x, _np_tree(v), feats, grads


@pytest.mark.parametrize("mode", ["on", "off"])
def test_leaf_bf16_matches_jax(mode):
    x, v, ref, grads = _leaf_case(mode)
    pm = load_jax_variables(Leaf(use_fused_kernel=mode, compute_dtype=BF16,
                                 device="cpu"), v)
    out = pm(torch.from_numpy(x))
    assert out.dtype == torch.float32 and ref.dtype == np.float32
    gap = float(np.abs(_to_np(out) - ref).max() / np.abs(ref).max())
    print(f"Leaf {mode}: features max-rel {gap:.3e}")
    assert gap < LEAF_FEATURE_TOL, gap
    torch.mean(out ** 2).backward()
    names = [n for n, _ in pm.named_parameters()]
    assert len(names) == len(jax.tree_util.tree_leaves(grads)) == 7
    worst = {}
    for name, p in pm.named_parameters():
        tree, path, _ = _frontend_route(name)
        g = grads[tree]
        for k in path:
            g = g[k]
        g = np.asarray(g)
        assert p.dtype == p.grad.dtype == torch.float32
        worst[name] = _rel(p.grad.numpy().reshape(g.shape), g)
    print(f"Leaf {mode}: gradient rel per leaf {worst}")
    assert max(worst.values()) < LEAF_GRAD_TOL, worst


def test_leaf_bf16_on_and_off_agree():
    # the fused op keeps OUT in f32 for S where the unfused path rounds the
    # conv output and S to bf16, as in the JAX package
    x = torch.from_numpy(_leaf_case("on")[0])
    on = Leaf(use_fused_kernel="on", compute_dtype=BF16, device="cpu")
    off = Leaf(use_fused_kernel="off", compute_dtype=BF16, device="cpu")
    off.load_state_dict(on.state_dict())
    with torch.no_grad():
        a, b = on(x), off(x)
    assert a.dtype == b.dtype == torch.float32
    assert float((a - b).abs().max() / b.abs().max()) < 1e-2


def test_compute_dtype_names():
    assert compute_dtype_of({}) is torch.float32
    assert compute_dtype_of({"compute_dtype": "bfloat16"}) is BF16
    with pytest.raises(ValueError, match="float16"):
        compute_dtype_of({"compute_dtype": "float16"})
    with pytest.raises(ValueError, match="compute_dtype"):
        Leaf(compute_dtype=torch.float16, device="cpu")
    cfg = _bf16_cfg(CFG)
    assert get_frontend(cfg, device="cpu").compute_dtype is BF16
    assert get_classifier(cfg["model"], device="cpu").compute_dtype is BF16
    assert get_frontend(CFG, device="cpu").compute_dtype is torch.float32


def test_bf16_sigmoid_follows_xla():
    # jax.nn.sigmoid on bf16 as XLA computes it: 1 / (1 + exp(−x)), each
    # op rounded to bf16; silu rounds x · sigmoid(x) once more
    xs = (np.random.RandomState(4).randn(4096) * 4).astype("float32")
    xb = _jbf16(xs)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(BF16)
    for ours, theirs in ((common.sigmoid, jax.nn.sigmoid),
                         (common.silu, jax.nn.silu)):
        want = np.asarray(jax.jit(theirs)(xb).astype(jnp.float32))
        np.testing.assert_array_equal(_to_np(ours(xt)), want)


def test_bf16_loss_follows_optax():
    # the loss of bf16 logits is formed and reduced in bf16, as optax's
    rng = np.random.RandomState(5)
    logits = _jbf16(rng.randn(64, 35).astype("float32") * 3)
    labels = rng.randint(0, 35, 64)
    want = optax.softmax_cross_entropy_with_integer_labels(
        logits, jnp.asarray(labels)).mean()
    got = cross_entropy_loss(
        torch.from_numpy(np.array(logits.astype(jnp.float32))).to(BF16),
        torch.from_numpy(labels))
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    assert float(got) == float(want), (float(got), float(want))
