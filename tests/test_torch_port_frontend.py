"""The port's frontend (leaf_tpu_torch.frontend) held against the JAX package.

Same inputs, made with numpy from a seed, go through the JAX function and
its port on the CPU. Tolerances: the mel init is bit-exact (it is discrete
argmax/threshold arithmetic in float32 numpy on both sides); float32 torch
vs float32 XLA elsewhere, atol 1e-6 / rtol 1e-5 for the single functions
(the tolerance tests/test_ops.py uses for the fused op) and atol 1e-5 /
rtol 1e-5 for the whole Leaf, whose PCEN power and root stretch the
last-bit differences of the two conv implementations.
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leaf_tpu.frontend import Leaf as JaxLeaf
from leaf_tpu.frontend import filters as jfilters
from leaf_tpu.frontend import helper as jhelper
from leaf_tpu.frontend import impulse_responses as jir
from leaf_tpu.frontend import initializers as jinit
from leaf_tpu.frontend import melbanks as jmel
from leaf_tpu.frontend import pooling as jpool
from leaf_tpu.frontend import postprocessing as jpost
from leaf_tpu.frontend import utils as jutils
from leaf_tpu.frontend.convolution import gabor_constraint as jconstraint
from leaf_tpu_torch.frontend import Leaf, get_frontend
from leaf_tpu_torch.frontend import filters, impulse_responses, initializers
from leaf_tpu_torch.frontend import melbanks, pooling, postprocessing, utils
from leaf_tpu_torch.frontend.convolution import gabor_constraint
from leaf_tpu_torch.models import load_jax_variables

ATOL, RTOL = 1e-6, 1e-5
REPO = pathlib.Path(__file__).resolve().parent.parent


def _np_tree(variables):
    return jax.tree_util.tree_map(np.asarray, dict(variables))


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


class TestMelInit:
    @pytest.mark.parametrize("n_filters,table", [(40, "DEFAULT_40"),
                                                 (64, "AUDIOSET_64")])
    def test_golden_bit_exact(self, n_filters, table):
        from tests import golden_mel_init
        got = filters.GaborParams(n_filters=n_filters, min_freq=60.0,
                                  max_freq=7800.0).gabor_params_from_mels()
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, getattr(golden_mel_init, table))

    def test_melbank_equals_jax(self):
        for args in [(257, 60.0, 7800.0, 40, 16000), (257, 0.0, 8000.0, 64, 16000)]:
            np.testing.assert_array_equal(melbanks.melscale_fbanks(*args),
                                          jmel.melscale_fbanks(*args))

    def test_leaf_init_is_golden(self):
        from tests.golden_mel_init import DEFAULT_40
        leaf = Leaf(device="cpu")
        np.testing.assert_array_equal(
            leaf._complex_conv._kernel.detach().numpy(), DEFAULT_40)

    def test_gabor_init_equals_jax(self):
        kw = dict(default_window_len=401, sample_rate=16000, min_freq=60.0,
                  max_freq=7800.0)
        got = initializers.GaborInit(**kw)((25, 2))
        ref = jinit.GaborInit(**kw)(jax.random.PRNGKey(0), (25, 2))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))

    @pytest.mark.parametrize("name", ["random", "xavier_normal",
                                      "kaiming_normal"])
    def test_random_initializers_take_a_generator(self, name):
        init = initializers.make_initializer(name, 401, 16000, 60.0, 7800.0)
        a = init((4000, 2), torch.Generator().manual_seed(3))
        b = init((4000, 2), torch.Generator().manual_seed(3))
        assert torch.equal(a, b)
        # the JAX schemes' std, on a large draw
        std = np.asarray(jinit.make_initializer(
            name, 401, 16000, 60.0, 7800.0)(jax.random.PRNGKey(0),
                                            (4000, 2))).std()
        assert abs(float(a.std()) - std) < 0.05 * std

    def test_unknown_initializer(self):
        with pytest.raises(ValueError, match="unsupported"):
            initializers.make_initializer("nope", 401, 16000, 60.0, 7800.0)


class TestMath:
    def test_same_padding(self):
        for k in (1, 2, 3, 400, 401):
            assert utils.tf_same_padding_1d(k) == jutils.tf_same_padding_1d(k)

    def test_gabor_filters(self):
        rng = np.random.RandomState(0)
        params = np.stack([rng.uniform(0, np.pi, 40),
                           rng.uniform(2, 150, 40)], 1).astype("float32")
        for size in (401, 400):
            got = impulse_responses.gabor_filters_real_imag(_t(params), size)
            ref = jir.gabor_filters_real_imag(jnp.asarray(params), size)
            for g, r in zip(got, ref):
                np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                           atol=ATOL, rtol=RTOL)

    def test_gaussian_lowpass(self):
        sigma = np.random.RandomState(1).uniform(-0.1, 0.7, 40).astype("float32")
        np.testing.assert_allclose(
            impulse_responses.gaussian_lowpass(_t(sigma), 401).numpy(),
            np.asarray(jir.gaussian_lowpass(jnp.asarray(sigma), 401)),
            atol=ATOL, rtol=RTOL)

    def test_constraint(self):
        k = np.random.RandomState(2).uniform(-1, 200, (64, 2)).astype("float32")
        np.testing.assert_array_equal(
            gabor_constraint(_t(k), 401).numpy(),
            np.asarray(jconstraint(jnp.asarray(k), 401)))

    @pytest.mark.parametrize("t", [16000, 12345, 161])
    def test_depthwise_strided_conv(self, t):
        rng = np.random.RandomState(3)
        x = rng.rand(2, t, 8).astype("float32")
        w = rng.rand(8, 401).astype("float32")
        np.testing.assert_allclose(
            pooling.depthwise_strided_conv(_t(x), _t(w), 160, (200, 200)).numpy(),
            np.asarray(jpool.depthwise_strided_conv(
                jnp.asarray(x), jnp.asarray(w), 160, (200, 200))),
            atol=ATOL, rtol=RTOL)


class TestModules:
    def test_gaussian_lowpass_module(self):
        rng = np.random.RandomState(4)
        x = rng.rand(2, 1000, 16).astype("float32")
        jm = jpool.GaussianLowPass(in_channels=16, kernel_size=401, strides=160)
        v = _np_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
        v["params"]["weights"] = rng.uniform(0.1, 0.5, 16).astype("float32")
        v["params"]["bias"] = rng.randn(16).astype("float32")
        pm = pooling.GaussianLowPass(16, 401, strides=160, device="cpu")
        with torch.no_grad():
            pm.weights.copy_(_t(v["params"]["weights"]).reshape(1, 1, 16, 1))
            pm._bias.copy_(_t(v["params"]["bias"]))
            got = pm(_t(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(jm.apply(v, jnp.asarray(x))),
                                   atol=ATOL, rtol=RTOL)

    @pytest.mark.parametrize("t", [100, 300])  # ema_matmul / ema_scan
    def test_pcen(self, t):
        rng = np.random.RandomState(5)
        x = (rng.rand(2, t, 40) + 1e-3).astype("float32")
        jm = jpost.PCENLayer(in_channels=40, floor=1e-12)
        v = _np_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
        p = v["params"]
        p["alpha"] = rng.uniform(0.8, 1.1, 40).astype("float32")
        p["delta"] = rng.uniform(1.0, 3.0, 40).astype("float32")
        p["root"] = rng.uniform(0.9, 3.0, 40).astype("float32")
        p["ema"]["weights"] = rng.uniform(0.01, 0.2, 40).astype("float32")
        pm = postprocessing.PCENLayer(40, floor=1e-12, device="cpu")
        with torch.no_grad():
            for name in ("alpha", "delta", "root"):
                getattr(pm, name).copy_(_t(p[name]))
            pm.ema._weights.copy_(_t(p["ema"]["weights"]))
            got = pm(_t(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(jm.apply(v, jnp.asarray(x))),
                                   atol=ATOL, rtol=RTOL)

    def test_ema_forms_agree(self):
        rng = np.random.RandomState(6)
        x, w = _t(rng.rand(2, 200, 8)), _t(rng.uniform(0, 1, 8))
        np.testing.assert_allclose(postprocessing.ema_matmul(x, w).numpy(),
                                   postprocessing.ema_scan(x, w).numpy(),
                                   atol=ATOL, rtol=RTOL)


def _leaf_pair(x, **kw):
    jm = JaxLeaf(use_fused_kernel="off", **kw)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    pm = load_jax_variables(Leaf(use_fused_kernel="off", device="cpu", **kw),
                            _np_tree(v))
    return np.asarray(jm.apply(v, jnp.asarray(x))), pm


class TestLeaf:
    @pytest.mark.parametrize("t", [16000, 12345, 48000])
    def test_off_matches_jax(self, t):
        x = (np.random.RandomState(7).randn(2, t) * 0.1).astype("float32")
        ref, pm = _leaf_pair(x)
        with torch.no_grad():
            got = pm(_t(x)).numpy()
            # reference (B, 1, T) and channels-last (B, T, 1) layouts
            np.testing.assert_array_equal(pm(_t(x)[:, None, :]).numpy(), got)
            np.testing.assert_array_equal(pm(_t(x)[:, :, None]).numpy(), got)
        assert got.shape == ref.shape == (2, (t - 1) // 160 + 1, 40)
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)

    def test_preemp_matches_jax(self):
        x = (np.random.RandomState(8).randn(2, 4000) * 0.1).astype("float32")
        ref, pm = _leaf_pair(x, preemp=True)
        with torch.no_grad():
            got = pm(_t(x)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)

    def test_mean_var_norm_matches_jax(self):
        # the normalisation divides by each channel's std over time, small
        # for these stationary noise features, which scales the last-bit
        # differences of the two convs up: atol 5e-4 on unit-variance output
        x = (np.random.RandomState(9).randn(2, 16000) * 0.1).astype("float32")
        ref, pm = _leaf_pair(x, mean_var_norm=True)
        with torch.no_grad():
            got = pm(_t(x)).numpy()
        np.testing.assert_allclose(got, ref, atol=5e-4, rtol=1e-5)

    def test_get_frontend_reads_cfg_like_jax(self):
        cfg = {"frontend": {"name": "leaf", "n_filters": 24, "preemp": True,
                            "min_freq": 100.0, "pcen_compress": False},
               "audio_config": {"sample_rate": 16000, "window_len": 30.0,
                                "window_stride": 12.5}}
        pm, jm = get_frontend(cfg, device="cpu"), jhelper.get_frontend(cfg)
        assert (pm.n_filters, pm.window_size, pm.stride, pm.preemp) == (
            jm.n_filters, jm.window_size, jm.stride, jm.preemp)
        assert pm._compression is None
        np.testing.assert_array_equal(
            pm._complex_conv._kernel.detach().numpy(),
            jfilters.GaborParams(n_filters=24, min_freq=100.0, max_freq=7800.0,
                                 sample_rate=16000,
                                 window_len=pm.window_size
                                 ).gabor_params_from_mels())
        with pytest.raises(NotImplementedError):
            get_frontend({"frontend": {"name": "sincnet"}}, device="cpu")


def _guarded(tree):
    """Import nodes inside a ``try`` that catches ImportError (an optional
    dependency used only where it is installed)."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Try) and any(
                isinstance(h.type, ast.Name)
                and h.type.id in ("ImportError", "ModuleNotFoundError")
                for h in node.handlers):
            out |= {id(n) for stmt in node.body for n in ast.walk(stmt)}
    return out


def _in_functions(tree):
    """Import nodes inside a function body (run only when it is called)."""
    return {id(n) for node in ast.walk(tree)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            for n in ast.walk(node)}


def _imports(path):
    """(module, guarded, in a function) for every absolute import of a
    source file."""
    tree = ast.parse(path.read_text(), str(path))
    guarded, lazy = _guarded(tree), _in_functions(tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from ((a.name, id(node) in guarded, id(node) in lazy)
                        for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, id(node) in guarded, id(node) in lazy


def test_port_imports_no_jax():
    """No module of the port, nor chip_smoke.py, imports the JAX stack,
    sklearn, the JAX package, or a package the card's machine lacks
    (PyYAML, pandas, msgpack; soundfile only behind an ImportError guard,
    as an optional decoder; google-cloud-storage only inside the function
    that opens a bucket). An AST scan: the interpreter may have jax
    loaded; the card's machine has none of them."""
    sources = sorted((REPO / "leaf_tpu_torch").rglob("*.py"))
    sources.append(REPO / "chip_smoke.py")
    assert len(sources) > 10
    assert {"streaming.py", "serving.py", "export_serving.py",
            "histograms.py", "steps.py", "msgpack_lite.py",
            "pack_dataset.py", "pretrained.py", "synthetic_convergence.py",
            "import_torch_classifier.py", "convert_torch_checkpoint.py",
            "depthwise.py"} <= {p.name for p in sources}
    # the measurement tools, each the counterpart of a JAX scripts/ file
    tools = {"_measure", "step_profile", "serving_latency",
             "streaming_latency", "kernel_microbench", "kernel_profile",
             "e2e_gap", "scan_ab", "scan_profile", "dw_ab", "dw_layout_ab"}
    assert {f"{t}.py" for t in tools} <= {
        p.name for p in sources if p.parent.name == "scripts"}
    banned = {"jax", "jaxlib", "flax", "optax", "orbax", "sklearn",
              "leaf_tpu", "yaml", "pandas", "soundfile", "msgpack",
              "msgpack_numpy", "google"}
    optional, lazy_only = {"soundfile"}, {"google"}
    found = [(p.name, m, guarded, lazy) for p in sources
             for m, guarded, lazy in _imports(p)]
    bad = [(name, m) for name, m, guarded, lazy in found
           if m.split(".")[0] in banned
           and not (guarded and m.split(".")[0] in optional)
           and not (lazy and m.split(".")[0] in lazy_only)]
    assert not bad, bad
    assert ("dataset.py", "google.cloud", False, True) in found
