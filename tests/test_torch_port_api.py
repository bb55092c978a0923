"""The port's public API against the JAX package's, on the CPU.

- Every name the JAX package exports (``leaf_tpu``'s top level and the
  ``__all__`` of ``.frontend``, ``.models``, ``.ops``, ``.training``,
  ``.data`` and ``.parallel``) is in the matching port ``__all__`` and
  importable from it.
- The complex Gabor filters (``gabor_impulse_response``,
  ``gabor_filters``) equal the JAX ones to 1e-6, real and imaginary
  parts, at sizes 401 and 64, and their parts are the port's float32
  ``gabor_filters_real_imag`` to 1e-6; ``GaborConstraint`` equals the
  JAX module; ``efficientnet_params`` equals JAX's for every name and
  raises ``KeyError`` alike.
- ``import_torch_classifier`` on a reference-named ``state_dict``
  (``module.``-prefixed, as a DataParallel checkpoint holds it) of
  efficientnet-b0, resnet-18 and cifar_resnet-20 (behind a Leaf of 8
  filters, 3 classes) gives the source's tensors exactly, and the same
  weights as the JAX ``import_torch_classifier`` of the same dict: the
  port's eval forward of the two imports gives equal logits, and the JAX
  forward of JAX's import is within 1e-5 of their scale (ResNet-18:
  5e-5, its ReLU and max-pool kinks amplify the two frameworks' float32
  conv rounding; measured 1.6e-5); missing, extra and misshaped keys raise
  and leave the model as it was, and ``densenet`` raises
  ``NotImplementedError``.
- ``import leaf_tpu_torch`` (and every subpackage) builds and loads no
  kernel.
"""

import functools
import importlib
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leaf_tpu.frontend import impulse_responses as jir
from leaf_tpu.frontend.convolution import GaborConstraint as JaxGaborConstraint
from leaf_tpu.models import Classifier as JaxClassifier
from leaf_tpu.models import efficientnet as jeff
from leaf_tpu.models import import_torch_classifier as jax_import
from leaf_tpu_torch.frontend import (GaborConstraint, gabor_filters,
                                     gabor_impulse_response)
from leaf_tpu_torch.frontend.impulse_responses import gabor_filters_real_imag
from leaf_tpu_torch.models import (Classifier, efficientnet_params,
                                   import_torch_classifier, load_jax_variables)
from leaf_tpu_torch.models.common import set_batch_norm_stats_

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 16000
FILTER_TOL = 1e-6
LOGIT_TOL = {"efficientnet": 1e-5, "cifar_resnet": 1e-5, "resnet": 5e-5}
_RNG = np.random.RandomState(11)
CALIB = torch.from_numpy((_RNG.randn(8, T) * 0.1).astype(np.float32))
X = (_RNG.randn(2, T) * 0.1).astype(np.float32)

# the JAX package's top level has no __all__: the names it imports
TOP_LEVEL = ("Leaf", "get_frontend", "ServingModel", "StreamingServingModel",
             "save_exported", "save_exported_streaming", "__version__")
# names of a JAX __all__ that the port does not export, with the reason
EXCEPTIONS = {}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    # the test runner shares the cores among its workers
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("sub", ["", ".frontend", ".models", ".ops",
                                 ".training", ".data", ".parallel"])
def test_port_exports_every_jax_name(sub):
    jax_mod = importlib.import_module(f"leaf_tpu{sub}")
    port_mod = importlib.import_module(f"leaf_tpu_torch{sub}")
    names = TOP_LEVEL if not sub else tuple(jax_mod.__all__)
    assert names
    want = set(names) - set(EXCEPTIONS.get(sub, {}))
    assert want <= set(port_mod.__all__), sorted(want - set(port_mod.__all__))
    for name in port_mod.__all__:
        assert hasattr(port_mod, name), name
    if not sub:
        assert port_mod.__version__ == jax_mod.__version__


def _gabor_kernel(n: int, seed: int) -> np.ndarray:
    """(n, 2) (μ, σ): μ across [0, π], σ across the constraint's range."""
    rng = np.random.RandomState(seed)
    return np.stack([rng.uniform(0.0, math.pi, n),
                     rng.uniform(1.5, 90.0, n)], axis=1).astype(np.float32)


@pytest.mark.parametrize("size", [401, 64])
def test_gabor_filters_match_jax(size):
    k = _gabor_kernel(16, seed=size)
    got = gabor_filters(torch.from_numpy(k), size)
    ref = np.asarray(jir.gabor_filters(jnp.asarray(k), size))
    assert got.dtype == torch.complex64 and got.shape == (16, size)
    assert ref.dtype == np.complex64
    np.testing.assert_allclose(got.real.numpy(), ref.real, atol=FILTER_TOL,
                               rtol=0)
    np.testing.assert_allclose(got.imag.numpy(), ref.imag, atol=FILTER_TOL,
                               rtol=0)
    t = np.arange(-(size // 2), (size + 1) // 2, dtype=np.float32)
    resp = gabor_impulse_response(torch.from_numpy(t),
                                  torch.from_numpy(k[:, 0]),
                                  torch.from_numpy(k[:, 1]))
    jresp = np.asarray(jir.gabor_impulse_response(
        jnp.asarray(t), jnp.asarray(k[:, 0]), jnp.asarray(k[:, 1])))
    np.testing.assert_allclose(resp.numpy(), jresp, atol=FILTER_TOL, rtol=0)
    # the frontend's float32 form is the complex filters' two parts
    real, imag = gabor_filters_real_imag(torch.from_numpy(k), size)
    np.testing.assert_allclose(real.numpy(), got.real.numpy(),
                               atol=FILTER_TOL, rtol=0)
    np.testing.assert_allclose(imag.numpy(), got.imag.numpy(),
                               atol=FILTER_TOL, rtol=0)


def test_gabor_constraint_module_matches_jax():
    k = _gabor_kernel(12, seed=5)
    k[:3, 0] = [-0.5, 3.5, 1.0]       # μ below, above, inside [0, π]
    k[3:6, 1] = [0.1, 500.0, 10.0]    # σ below, above, inside its range
    got = GaborConstraint(kernel_size=401)(torch.from_numpy(k)).numpy()
    ref = np.asarray(JaxGaborConstraint(kernel_size=401).apply(
        {}, jnp.asarray(k)))
    np.testing.assert_array_equal(got, ref)
    assert not np.array_equal(got, k)


def test_efficientnet_params_match_jax():
    assert jeff.VALID_MODELS
    for name in jeff.VALID_MODELS:
        assert efficientnet_params(name) == jeff.efficientnet_params(name)
    for fn in (efficientnet_params, jeff.efficientnet_params):
        with pytest.raises(KeyError):
            fn("efficientnet-b9")


def _cfg(arch: str, depth) -> dict:
    return {"frontend": {"name": "leaf", "default_args": False,
                         "n_filters": 8},
            "audio_config": {"sample_rate": T},
            "model": {"arch": arch, "model_depth": depth, "num_classes": 3,
                      "type": "multiclass"}}


ARCHS = {"efficientnet": "b0", "resnet": 18, "cifar_resnet": 20}


@functools.lru_cache(maxsize=None)
def _source(arch: str):
    """A port classifier with a moved frontend and set BN statistics,
    and its reference checkpoint dict (``module.``-prefixed keys)."""
    model = Classifier(_cfg(arch, ARCHS[arch]), device="cpu",
                       generator=torch.Generator().manual_seed(3)).eval()
    g = torch.Generator().manual_seed(103)
    with torch.no_grad():
        for p in model.features.parameters():
            p.mul_(1 + 0.05 * torch.randn(p.shape, generator=g))
        set_batch_norm_stats_(model, CALIB)
        for bn in model.modules():
            if isinstance(bn, torch.nn.BatchNorm2d):
                bn.running_var.add_(0.1 * bn.running_var.mean())
    return model, {f"module.{k}": v.clone()
                   for k, v in model.state_dict().items()}


def _fresh(arch: str) -> Classifier:
    return Classifier(_cfg(arch, ARCHS[arch]), device="cpu",
                      generator=torch.Generator().manual_seed(9)).eval()


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_import_torch_classifier_matches_jax(arch):
    src, sd = _source(arch)
    model = import_torch_classifier(sd, _fresh(arch), arch)
    got_sd, want_sd = model.state_dict(), src.state_dict()
    assert list(got_sd) == list(want_sd)
    for k in want_sd:
        assert torch.equal(got_sd[k], want_sd[k]), k
    with torch.no_grad():
        logits = model(torch.from_numpy(X)).numpy()

    jm = JaxClassifier(cfg=_cfg(arch, ARCHS[arch]))
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((2, T)), train=False))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                      dict(shapes))
    variables = jax_import({k: v.numpy() for k, v in sd.items()}, template,
                           arch)
    with torch.no_grad():
        carried = load_jax_variables(_fresh(arch), variables)
        np.testing.assert_array_equal(
            carried(torch.from_numpy(X)).numpy(), logits)
    ref = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        variables, X))
    scale = float(np.abs(ref).max())
    assert scale > 1e-2   # not a vanished net
    assert float(np.abs(logits - ref).max()) <= LOGIT_TOL[arch] * scale


@pytest.mark.parametrize("misfit", ["missing", "extra", "misshaped"])
def test_import_torch_classifier_refuses_misfits(misfit):
    _, sd = _source("cifar_resnet")
    sd = dict(sd)
    if misfit == "missing":
        del sd["module.model.layer2.1.bn1.running_var"]
        match = "Missing key"
    elif misfit == "extra":
        sd["module.model.layer9.weight"] = torch.zeros(3)
        match = "Unexpected key"
    else:
        sd["module.model.linear.weight"] = sd["module.model.linear.weight"][:2]
        match = "size mismatch"
    model = _fresh("cifar_resnet")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with pytest.raises(RuntimeError, match=match):
        import_torch_classifier(sd, model, "cifar_resnet")
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_import_torch_classifier_refuses_densenet():
    _, sd = _source("cifar_resnet")
    with pytest.raises(NotImplementedError, match="densenet"):
        import_torch_classifier(sd, _fresh("cifar_resnet"), "densenet")
    with pytest.raises(NotImplementedError, match="densenet"):
        jax_import({}, {"params": {}}, "densenet")


def test_import_builds_and_loads_no_kernel():
    from leaf_tpu_torch.ops._build import BUILD_DIR

    def listing():
        if not BUILD_DIR.exists():
            return None
        return sorted((p.name, p.stat().st_mtime_ns)
                      for p in BUILD_DIR.iterdir())

    before = listing()
    code = ("import json, leaf_tpu_torch, leaf_tpu_torch.frontend, "
            "leaf_tpu_torch.models, leaf_tpu_torch.ops, "
            "leaf_tpu_torch.training, leaf_tpu_torch.data, "
            "leaf_tpu_torch.parallel, leaf_tpu_torch.serving\n"
            "from leaf_tpu_torch.ops import _build\n"
            "print(json.dumps(_build.load_library.cache_info().currsize))")
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=env, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert json.loads(r.stdout.strip().splitlines()[-1]) == 0
    assert listing() == before
