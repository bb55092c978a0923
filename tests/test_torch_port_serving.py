"""The port's ServingModel (leaf_tpu_torch.serving): pad-to-bucket dispatch
over the live classifier, on the CPU.

Requests of 3, 8 and 70 clips (padding into the 8 bucket, an exact bucket,
and chunking 64 + 6) must give the logits of the direct module call:
max|served − direct| ≤ 1e-3·max|logit|. The arithmetic per clip is the
same (BN in eval mode), but the CPU convolutions pick their algorithm,
and so their float32 summation order, by batch size; the network
amplifies those last-bit differences to ~1e-4 of the logits' scale.
Weights arrive either as a port state_dict or, through the JAX
package's importer, as a JAX variables tree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leaf_tpu.models import Classifier as JaxClassifier
from leaf_tpu.models.torch_import import import_torch_classifier
from leaf_tpu_torch.models import Classifier
from leaf_tpu_torch.models.common import set_batch_norm_stats_
from leaf_tpu_torch.serving import DEFAULT_BATCH_SIZES, ServingModel

# the flagship cfg with a 16-filter frontend and 5 classes: the same code
# paths at a smaller size
CFG = {"frontend": {"name": "leaf", "n_filters": 16},
       "audio_config": {"sample_rate": 16000},
       "model": {"arch": "efficientnet", "model_depth": "b0",
                 "num_classes": 5}}


@pytest.fixture(scope="module")
def model():
    m = Classifier(CFG, device="cpu",
                   generator=torch.Generator().manual_seed(0)).eval()
    calib = np.random.RandomState(0).randn(4, 16000).astype("float32") * 0.1
    set_batch_norm_stats_(m, torch.from_numpy(calib))
    return m


def _direct(model, x):
    with torch.no_grad():
        return model(torch.from_numpy(x)).numpy()


def test_buckets():
    assert DEFAULT_BATCH_SIZES == (8, 64)
    s = ServingModel.__new__(ServingModel)
    s.batch_sizes = [8, 64]
    assert [s._bucket(n) for n in (1, 8, 9, 64, 65)] == [8, 8, 64, 64, 64]


@pytest.mark.parametrize("n", [3, 8, 70])
def test_serving_matches_direct_call(model, n):
    server = ServingModel(CFG, state_dict=model.state_dict(), device="cpu")
    x = (np.random.RandomState(n).randn(n, 16000) * 0.1).astype("float32")
    got = server(x)
    ref = _direct(model, x)
    assert got.shape == (n, 5)
    assert np.abs(got - ref).max() <= 1e-3 * np.abs(ref).max()


def test_serving_from_jax_variables(model):
    jm = JaxClassifier(cfg=CFG)
    x = (np.random.RandomState(4).randn(3, 16000) * 0.1).astype("float32")
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                            jnp.asarray(x), train=False))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                      dict(shapes))
    variables = import_torch_classifier(model.state_dict(), template,
                                        "efficientnet")
    server = ServingModel(CFG, jax_variables=variables, device="cpu")
    ref = _direct(model, x)
    assert np.abs(server(x) - ref).max() <= 1e-3 * np.abs(ref).max()


def test_wrong_clip_length_raises(model):
    server = ServingModel(CFG, state_dict=model.state_dict(), device="cpu")
    with pytest.raises(ValueError, match="16000"):
        server(np.zeros((2, 8000), np.float32))
    with pytest.raises(ValueError):
        ServingModel(CFG, device="cpu")  # no weights


def test_default_device_is_cuda(model):
    if torch.cuda.is_available():
        pytest.skip("checks the no-card behaviour")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingModel(CFG, state_dict=model.state_dict())
    with pytest.raises(RuntimeError, match="CUDA"):
        Classifier(CFG)
