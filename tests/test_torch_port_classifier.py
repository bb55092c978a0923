"""The port's EfficientNet classifier (leaf_tpu_torch.models) held against
the JAX package.

One JAX ``Classifier`` (the flagship SpeechCommands cfg: LEAF + b0, 35
classes) is initialised once for the module; its variables are carried
into the port by ``load_jax_variables`` and the logits compared at B=2,
T=16000. The BN running stats are first set from one seeded batch
(``set_batch_norm_stats_``; the JAX package's own ``import_torch_classifier``
carries them back) so that the logits are O(1) rather than the ~1e-8 of a
random init with unit stats. Tolerance: max|port − JAX| ≤ 1e-4·max|JAX|
— float32 torch vs float32 XLA through a frontend and 16 MBConv blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from leaf_tpu.models import Classifier as JaxClassifier
from leaf_tpu.models import efficientnet as jeff
from leaf_tpu.models.torch_import import import_torch_classifier
from leaf_tpu_torch.models import Classifier, get_classifier, load_jax_variables
from leaf_tpu_torch.models import efficientnet as eff
from leaf_tpu_torch.models.common import Conv2dSame, set_batch_norm_stats_

CFG = {"frontend": {"name": "leaf", "default_args": True},
       "audio_config": {"sample_rate": 16000},
       "model": {"arch": "efficientnet", "model_depth": "b0",
                 "num_classes": 35}}


def _np_tree(variables):
    return jax.tree_util.tree_map(np.asarray, dict(variables))


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


class TestBlockArgs:
    def test_block_strings(self):
        for s in eff.B0_BLOCK_STRINGS + ("r1_k3_s11_e1_i32_o16_noskip",):
            assert (eff.decode_block_string(s).__dict__
                    == jeff.decode_block_string(s).__dict__)
        with pytest.raises(ValueError):
            eff.decode_block_string("r1_k3_s12_e1_i32_o16")

    @pytest.mark.parametrize("name", eff.VALID_MODELS)
    def test_scaling(self, name):
        blocks, gp = eff.get_model_params(name, num_classes=35)
        jblocks, jgp = jeff.get_model_params(name, num_classes=35)
        assert gp.__dict__ == jgp.__dict__
        for f in (1, 16, 32, 40, 112, 320, 1280):
            assert eff.round_filters(f, gp) == jeff.round_filters(f, jgp)
        for r in (1, 2, 3, 4):
            assert eff.round_repeats(r, gp) == jeff.round_repeats(r, jgp)


@pytest.mark.parametrize("size", [(9, 9), (40, 100), (7, 12)])
def test_same_padding_matches_flax(size):
    # stride-2 TF-SAME pads (lo, hi) = (total//2, total − total//2)
    rng = np.random.RandomState(0)
    x = rng.randn(2, *size, 3).astype("float32")
    jm = nn.Conv(5, (3, 3), strides=(2, 2), padding="SAME", use_bias=False)
    v = _np_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    pm = Conv2dSame(3, 5, 3, stride=2, bias=False)
    with torch.no_grad():
        pm.weight.copy_(torch.from_numpy(
            np.transpose(v["params"]["kernel"], (3, 2, 0, 1)).copy()))
        got = pm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    ref = np.asarray(jm.apply(v, jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("hw", [(9, 13), (10, 14)])
def test_stride2_mbconv_block_matches_jax(hw):
    """One narrow stride-2 MBConv (expand, 5×5 depthwise, SE) on odd and
    even spatial sizes, with random BN statistics; atol/rtol 1e-5."""
    ba = jeff.BlockArgs(num_repeat=1, kernel_size=5, stride=2, expand_ratio=6,
                        input_filters=8, output_filters=16, se_ratio=0.25)
    rng = np.random.RandomState(1)
    x = rng.randn(2, *hw, 8).astype("float32")
    jm = jeff.MBConvBlock(block_args=ba, bn_momentum=0.99, bn_epsilon=1e-3)
    v = _np_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.5, 2.0, a.shape).astype("float32"),
        v["batch_stats"])
    pm = load_jax_variables(
        eff.MBConvBlock(eff.BlockArgs(**ba.__dict__), 0.99, 1e-3), v).eval()
    assert pm._bn1.eps == 1e-3 and abs(pm._bn1.momentum - 0.01) < 1e-12
    with torch.no_grad():
        got = pm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    ref = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def flagship():
    """(JAX model, its variables, the port classifier holding them)."""
    wav = np.random.RandomState(2).randn(2, 16000).astype("float32") * 0.1
    jm = JaxClassifier(cfg=CFG)
    v = _np_tree(jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(wav),
                         train=False))
    port = load_jax_variables(Classifier(CFG, device="cpu"), v).eval()
    return jm, v, port


class TestWholeSlice:
    def test_round_trip_through_jax_importer(self, flagship):
        # the JAX package's own router reads the port's state_dict names
        _, v, port = flagship
        back = import_torch_classifier(port.state_dict(), v, "efficientnet")
        flat = jax.tree_util.tree_leaves_with_path(v)
        assert len(flat) == len(jax.tree_util.tree_leaves(back))
        for (path, a), b in zip(flat, jax.tree_util.tree_leaves(back)):
            np.testing.assert_array_equal(np.asarray(b), a, err_msg=str(path))

    def test_logits_match_jax(self, flagship):
        jm, v, port = flagship
        rng = np.random.RandomState(3)
        calib = torch.from_numpy(
            (rng.randn(8, 16000) * 0.1).astype("float32"))
        set_batch_norm_stats_(port, calib)
        v = import_torch_classifier(port.state_dict(), v, "efficientnet")
        wav = (rng.randn(2, 16000) * 0.1).astype("float32")
        ref = np.asarray(jm.apply(v, jnp.asarray(wav), train=False))
        with torch.no_grad():
            got = port(torch.from_numpy(wav)).numpy()
            feats = port.features_only(torch.from_numpy(wav)).numpy()
        assert got.shape == ref.shape == (2, 35)
        assert np.abs(ref).max() > 1e-2  # O(1) logits, not a vanished net
        assert _rel(got, ref) < 1e-4, _rel(got, ref)
        np.testing.assert_allclose(
            feats, np.asarray(jm.apply(v, jnp.asarray(wav),
                                       method="features_only")),
            atol=1e-5, rtol=1e-5)

    def test_load_refuses_partial_or_misshaped(self, flagship):
        _, v, _ = flagship
        target = Classifier(CFG, device="cpu")
        missing = jax.tree_util.tree_map(lambda a: a, v)
        del missing["batch_stats"]["model"]["bn1"]
        with pytest.raises(KeyError, match="lack"):
            load_jax_variables(target, missing)
        extra = jax.tree_util.tree_map(lambda a: a, v)
        extra["params"]["model"]["stray"] = {"kernel": np.zeros(3, "float32")}
        with pytest.raises(KeyError, match="no port tensor"):
            load_jax_variables(target, extra)
        bad = jax.tree_util.tree_map(lambda a: a, v)
        bad["params"]["model"]["fc"]["bias"] = np.zeros(36, "float32")
        with pytest.raises(ValueError, match="shape mismatch"):
            load_jax_variables(target, bad)


class TestFactory:
    def test_dispatch_errors(self):
        with pytest.raises(ValueError, match="transformer"):
            get_classifier({"arch": "transformer", "num_classes": 2},
                           device="cpu")
        with pytest.raises(ValueError, match="999"):
            get_classifier({"arch": "densenet", "model_depth": 999,
                            "num_classes": 2}, device="cpu")
        with pytest.raises(ValueError, match="b99"):
            get_classifier({"arch": "efficientnet", "model_depth": "b99",
                            "num_classes": 2}, device="cpu")

    @pytest.mark.parametrize("arch,depth,cls", [
        ("resnet", 18, "ResNet"), ("cifar_resnet", 20, "CifarResNet"),
        ("densenet", 121, "DenseNet")])
    def test_later_slice_arches_raise(self, arch, depth, cls):
        # the rest of the zoo is ported: these arches build, on the CPU,
        # with the head width asked for; only an unknown depth raises
        model = get_classifier({"arch": arch, "model_depth": depth,
                                "num_classes": 2}, device="cpu")
        head = {"ResNet": "fc", "CifarResNet": "linear",
                "DenseNet": "classifier"}[cls]
        assert type(model).__name__ == cls
        assert getattr(model, head).out_features == 2
        assert next(model.parameters()).device.type == "cpu"
        with pytest.raises(ValueError, match=f"{depth + 1} of depth"):
            get_classifier({"arch": arch, "model_depth": depth + 1,
                            "num_classes": 2}, device="cpu")

    def test_seeded_and_train_mode_guarded(self):
        def build(seed):
            return Classifier(CFG, device="cpu",
                              generator=torch.Generator().manual_seed(seed))
        a, b = build(0).state_dict(), build(0).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert not torch.equal(a["model._fc.weight"],
                               build(1).state_dict()["model._fc.weight"])
        # modules start in train mode: BN on batch statistics, dropout and
        # drop-connect drawn from the generator
        m = build(0)
        x = torch.from_numpy(np.random.RandomState(4).randn(2, 16000)
                             .astype("float32") * 0.1)
        logits = m(x, torch.Generator().manual_seed(0))
        assert m.training and logits.shape == (2, 35)
        assert bool(torch.isfinite(logits).all())


def test_backbone_init_is_flax_lecun_normal():
    # Flax's lecun_normal(): a normal truncated at ±2σ with
    # σ = √(1/fan_in)/0.87962566, so the std stays √(1/fan_in) and no
    # |w|·√fan_in exceeds 2/0.87962566 ≈ 2.274
    model = get_classifier(CFG["model"], device="cpu",
                           generator=torch.Generator().manual_seed(0))
    layers = [m for m in model.modules()
              if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    assert len(layers) == 82
    bound = 2.0 / 0.87962566 + 1e-6
    for m in layers:
        w = m.weight.detach()
        assert float(w.abs().max()) * w[0].numel() ** 0.5 <= bound
    largest = sorted(layers, key=lambda m: m.weight.numel())[-5:]
    for m in largest:   # ≥ 400k draws each
        w = m.weight.detach()
        std = float(w.std()) * w[0].numel() ** 0.5
        assert abs(std - 1.0) < 0.02, (m, std)
