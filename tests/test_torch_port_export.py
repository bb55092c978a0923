"""The port's serving artifacts (leaf_tpu_torch.serving: ``save_exported``,
``ServingModel.load``, ``save_exported_streaming``,
``StreamingServingModel``), the export CLI that writes them and the
kernels' torch.library ops, on the CPU.

The flagship cfg with a 16-filter frontend and 5 classes; seeded weights
(BatchNorm statistics from one seeded batch, so that the logits are O(1))
as JAX variables, loaded through ``load_jax_variables``, checkpointed in
an experiment directory and exported by ``python -m
leaf_tpu_torch.export_serving`` (in process). An artifact is a
``torch.export`` program of the live classifier, so it gives the live
module's logits (atol 1e-5 of max|logit|, tests/test_serving.py's atol);
both are held against the JAX ``Classifier.apply`` at
tests/test_torch_port_classifier.py's 1e-4 of max|logit| (torch's and
XLA's convolutions sum in other orders). Streaming artifacts mirror
tests/test_serving.py: the live streamer to rtol 1e-6, atol 1e-7, the
offline Leaf and the JAX streamer to tests/test_streaming.py's TOL.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from leaf_tpu.frontend.streaming import LeafStreamer as JaxStreamer
from leaf_tpu.models import Classifier as JaxClassifier
from leaf_tpu.models.torch_import import import_torch_classifier
from leaf_tpu.serving import save_exported as jax_save_exported
from leaf_tpu.serving import \
    save_exported_streaming as jax_save_exported_streaming
from leaf_tpu_torch import export_serving
from leaf_tpu_torch.frontend import LeafStreamer
from leaf_tpu_torch.models import Classifier, load_jax_variables
from leaf_tpu_torch.models.common import set_batch_norm_stats_
from leaf_tpu_torch.ops import fused_frontend as ff
from leaf_tpu_torch.serving import ServingModel, StreamingServingModel
from leaf_tpu_torch.training import TrainState
from leaf_tpu_torch.training.checkpoint import save_checkpoint, save_hparams

SR = 16000
CFG = {"frontend": {"name": "leaf", "n_filters": 16},
       "audio_config": {"sample_rate": SR},
       "model": {"arch": "efficientnet", "model_depth": "b0",
                 "num_classes": 5}}
ARTIFACT_TOL, JAX_TOL = 1e-5, 1e-4
SERVED_STREAM_TOL = dict(rtol=1e-6, atol=1e-7)
STREAM_TOL = dict(rtol=2e-5, atol=2e-6)


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


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def _wave(n, seed, t=SR):
    return (np.random.RandomState(seed).randn(n, t) * 0.1).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    """(JAX model, JAX variables with O(1) BN statistics, the port model
    holding them through ``load_jax_variables``)."""
    jm = JaxClassifier(cfg=CFG)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                            jnp.zeros((2, SR)), train=False))
    template = jax.tree_util.tree_map(lambda t: np.zeros(t.shape, t.dtype),
                                      dict(shapes))
    seeded = Classifier(CFG, device="cpu",
                        generator=torch.Generator().manual_seed(0)).eval()
    set_batch_norm_stats_(seeded, torch.from_numpy(_wave(8, 1)))
    v = import_torch_classifier(seeded.state_dict(), template, "efficientnet")
    port = load_jax_variables(Classifier(CFG, device="cpu"), v).eval()
    return jm, v, port


@pytest.fixture(scope="module")
def exported(weights, tmp_path_factory):
    """The export CLI run on an experiment directory that holds the
    weights as its checkpoint: buckets (1, 4) and the streaming cells
    (chunk 1600, 2 streams); (artifact dir, manifest, loaded artifact,
    live ServingModel of the JAX variables)."""
    _, v, port = weights
    exp = str(tmp_path_factory.mktemp("exp"))
    save_hparams(exp, CFG)
    save_checkpoint(exp, TrainState(port, None), 0, 0.0, 0.0, 0.5)
    assert export_serving.main(["--exp_dir", exp, "--device", "cpu",
                                "--batch_sizes", "1,4",
                                "--streaming_chunk", "1600",
                                "--streaming_streams", "2"]) == 0
    out = os.path.join(exp, "serving")
    with open(os.path.join(out, "serving.json")) as f:
        manifest = json.load(f)
    live = ServingModel(CFG, jax_variables=v, device="cpu",
                        batch_sizes=(1, 4))
    return out, manifest, ServingModel.load(out, device="cpu"), live


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["fused_fwd", "fused_fwd_save", "fused_bwd"])
def test_ops_pass_opcheck(op, dtype):
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 1000).astype(np.float32)).to(dtype)
    gabor = (torch.from_numpy(rng.randn(401, 8).astype(np.float32))
             * 0.05).to(dtype)
    windows = torch.from_numpy(rng.rand(4, 401).astype(np.float32))
    if op == "fused_bwd":
        out, conv = ff.fused_fwd_save_op(x, gabor, windows)
        args = (x, conv, windows, torch.from_numpy(
            rng.randn(*out.shape).astype(np.float32)))
    else:
        args = (x, gabor, windows)
    fn = getattr(torch.ops.leaf_tpu_torch, op)
    torch.library.opcheck(fn, args)
    # the CPU implementation is the plain version
    plain = {"fused_fwd": lambda *a: (ff.fused_reference(*a),),
             "fused_fwd_save": ff.fused_forward_saving_reference,
             "fused_bwd": ff.fused_backward_reference}[op]
    got = fn(*args)
    for a, b in zip(got if isinstance(got, tuple) else (got,), plain(*args)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_manifest_keys_match_jax(exported, tmp_path):
    out, manifest, _, _ = exported
    cfg = {"frontend": {"name": "leaf", "default_args": False,
                        "n_filters": 8},
           "audio_config": {"sample_rate": SR},
           "model": {"arch": "cifar_resnet", "model_depth": 20,
                     "num_classes": 5, "type": "multiclass"}}
    jm = JaxClassifier(cfg=cfg)
    v = jax.jit(lambda k: jm.init({"params": k}, jnp.zeros((1, SR)),
                                  train=False))(jax.random.PRNGKey(0))
    jax_manifest = jax_save_exported(str(tmp_path), cfg, v, batch_sizes=(1,))
    assert set(manifest) == set(jax_manifest) | {"device"}
    assert manifest["batch_sizes"] == [1, 4]
    assert manifest["num_classes"] == 5 and manifest["clip_samples"] == SR
    assert manifest["model"] == {"arch": "efficientnet", "model_depth": "b0"}
    assert manifest["device"] == "cpu"
    assert sorted(os.listdir(out)) == [
        "model_b1.pt2", "model_b4.pt2", "serving.json",
        "serving_stream.json", "stream_first.pt2", "stream_flush_0.pt2",
        "stream_steady.pt2"]
    for name in manifest["files"].values():
        assert os.path.getsize(os.path.join(out, name)) > 1000


@pytest.fixture(scope="module")
def requests(weights):
    """Seeded clips and their JAX logits (one jitted apply; eval mode
    scores each clip on its own)."""
    jm, v, _ = weights
    x = _wave(14, seed=10)
    return x, np.asarray(jax.jit(lambda w: jm.apply(v, w, train=False))(
        jnp.asarray(x)))


@pytest.mark.parametrize("n", [1, 3, 4, 6])
def test_artifact_matches_live_and_jax(exported, requests, n):
    # n=3 pads into the 4 bucket; n=6 is a chunk of 4 and one of 2 (→ 4)
    _, _, art, live = exported
    x, jax_ref = (a[n:2 * n] for a in requests)
    got, ref = art(x), live(x)
    assert got.shape == (n, 5) and got.dtype == np.float32
    assert np.abs(ref).max() > 1e-2  # O(1) logits, not a vanished net
    assert np.abs(got - ref).max() <= ARTIFACT_TOL * np.abs(ref).max()
    assert _rel(got, jax_ref) < JAX_TOL, _rel(got, jax_ref)


def test_artifact_records_the_depthwise_op(exported):
    """Each of b0's 16 MBConv depthwise convs is the custom op in the
    exported program (its fake implementation traced it), and none is a
    grouped aten convolution; the stem and the 1×1 convs stay aten's."""
    out, manifest, _, _ = exported
    program = torch.export.load(os.path.join(out, manifest["files"]["4"]))
    calls = [n for n in program.graph.nodes if n.op == "call_function"]
    targets = [str(n.target) for n in calls]
    assert targets.count("leaf_tpu_torch.depthwise_fwd.default") == 16
    # aten.conv2d(input, weight, bias, stride, padding, dilation, groups):
    # the stem, 15 expand and 16 project convs and the head
    groups = [n.args[6] if len(n.args) > 6 else n.kwargs.get("groups", 1)
              for n in calls if str(n.target).startswith("aten.conv2d")]
    assert len(groups) == 1 + 15 + 16 + 1 and set(groups) == {1}, groups


def test_wrong_length_raises(exported):
    _, _, art, _ = exported
    with pytest.raises(ValueError, match=str(SR)):
        art(np.zeros((2, SR + 1), np.float32))


def test_device_mismatch_raises(exported, tmp_path):
    out, manifest, _, _ = exported
    moved = tmp_path / "moved"
    shutil.copytree(out, moved)
    (moved / "serving.json").write_text(json.dumps({**manifest,
                                                    "device": "cuda"}))
    with pytest.raises(ValueError, match="exported for 'cuda'"):
        ServingModel.load(str(moved), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ServingModel.load(out)  # the default device is cuda


@pytest.fixture(scope="module")
def streaming_artifact(weights, exported):
    """The export CLI's streaming cells, beside the JAX Leaf of the same
    frontend weights (the JAX export script's ``params["features"]``)."""
    from leaf_tpu.frontend import get_frontend as jax_frontend
    _, v, port = weights
    out = exported[0]
    with open(os.path.join(out, "serving_stream.json")) as f:
        manifest = json.load(f)
    return (jax_frontend(CFG), {"params": v["params"]["features"]},
            port.features, out, manifest)


def test_streaming_manifest_and_files(streaming_artifact, tmp_path):
    jl, v, _, out, manifest = streaming_artifact
    jax_manifest = jax_save_exported_streaming(str(tmp_path), jl, v,
                                               chunk_size=1600, n_streams=2)
    assert set(manifest) == set(jax_manifest) | {"device"}
    assert {k: manifest[k] for k in jax_manifest if k != "files"} == {
        k: v for k, v in jax_manifest.items() if k != "files"}
    assert set(manifest["files"]) == {"first", "steady", "flush_0"}
    for name in manifest["files"].values():
        assert os.path.exists(os.path.join(out, name))


def test_streaming_roundtrip_matches_live_streamer(streaming_artifact):
    jl, v, leaf, out, _ = streaming_artifact
    wave = _wave(2, 0, t=8000)
    live = LeafStreamer(leaf, chunk_size=1600)
    served = StreamingServingModel.load(out, device="cpu")
    jax_live = JaxStreamer(jl, v, chunk_size=1600)
    outs = {"live": [], "served": [], "jax": []}
    for i in range(5):
        c = wave[:, i * 1600:(i + 1) * 1600]
        for name, st in (("live", live), ("served", served),
                         ("jax", jax_live)):
            outs[name].append(np.asarray(st.process(c)))
    for name, st in (("live", live), ("served", served), ("jax", jax_live)):
        outs[name].append(np.asarray(st.flush()))
    a, b, j = (np.concatenate(outs[k], axis=1)
               for k in ("live", "served", "jax"))
    assert a.shape == b.shape == (2, 50, 16)
    np.testing.assert_allclose(b, a, **SERVED_STREAM_TOL)
    with torch.no_grad():
        offline = leaf(torch.from_numpy(wave)).numpy()
    np.testing.assert_allclose(b, offline, **STREAM_TOL)
    np.testing.assert_allclose(b, j, **STREAM_TOL)


def test_streaming_served_rejects_remainder_flush(streaming_artifact):
    out = streaming_artifact[3]
    served = StreamingServingModel.load(out, device="cpu")
    served.process(np.zeros((2, 1600), np.float32))
    with pytest.raises(ValueError, match="no 'flush_160' variant"):
        served.flush(np.zeros((2, 160), np.float32))


def test_streaming_served_reset(streaming_artifact):
    out = streaming_artifact[3]
    served = StreamingServingModel.load(out, device="cpu")
    wave = _wave(2, 1, t=3200)
    a = [np.asarray(served.process(wave[:, :1600])),
         np.asarray(served.process(wave[:, 1600:])),
         np.asarray(served.flush())]
    served.reset()
    b = [np.asarray(served.process(wave[:, :1600])),
         np.asarray(served.process(wave[:, 1600:])),
         np.asarray(served.flush())]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_export_cli_serves_the_checkpoint(weights, exported):
    # the CLI's artifact gives the logits of the module it read
    _, _, port = weights
    _, _, art, _ = exported
    x = _wave(3, 2)
    with torch.no_grad():
        ref = port(torch.from_numpy(x)).numpy()
    assert np.abs(art(x) - ref).max() <= 1e-3 * np.abs(ref).max()
    served = StreamingServingModel.load(exported[0], device="cpu")
    assert served.chunk_size == 1600 and served.manifest["n_streams"] == 2
