"""AST, the port's transformer backbone (``leaf_tpu_torch/models/ast.py``),
on the CPU at a tiny size (d 64, 2 blocks, 4 heads of 16, 16 LEAF filters,
1 s clips: 1 × 9 patches + 2 tokens), held against the benchmark's plain
reference (``leafbench/reference/ast.py``: the attention written out as
matmul → softmax → matmul, no SDPA) on the same seeded weights. This file
imports no JAX: the JAX package has no AST.

Tolerances: both sides compute in float32 on the CPU and differ only in
the order of their sums (SDPA's blocked softmax against the plain one,
the port's and the reference's LEAF ops), ~1e-6 of each value; logits
are held to 1e-5 of their largest, gradients to 1e-4 of each leaf's
largest entry (a sum over the batch and the tokens), the train steps as
``leafbench/tests/test_leafbench_reference.py`` holds the CNN backbones.
"""

import copy
import json
import re

import numpy as np
import pytest
import torch

from leaf_tpu_torch import tracing
from leaf_tpu_torch.data import leaf_device_augment
from leaf_tpu_torch.data.audio import write_wav
from leaf_tpu_torch.models import ASTModel, Classifier, get_classifier
from leaf_tpu_torch.models.ast import ast_options, get_shape
from leaf_tpu_torch.serving import ServingModel
from leaf_tpu_torch.training import (TrainState, get_config,
                                     make_train_multistep,
                                     optimization_helper)
from leafbench import check, inputs
from leafbench.loops.train import port_state
from leafbench.reference import ast as ref_ast
from leafbench.reference import step as ref_step
from leafbench.reference.classifier import Classifier as RefClassifier

SR, T, B = 16000, 16000, 4
RECIPE = "leaf_tpu_torch/recipes/audioset/ast-base-leaf.cfg"
TINY = {"fstride": 10, "tstride": 10, "embed_dim": 64, "depth": 2,
        "num_heads": 4, "mlp_ratio": 4}
# the image 16 filters over 1 s clips give; the port derives it, the
# reference reads it from the model section as AST's constructor does
IMAGE = {"input_fdim": 16, "input_tdim": 100}
CFG = {"frontend": {"name": "leaf", "default_args": False, "n_filters": 16},
       "audio_config": {"sample_rate": SR, "random_clip_size": T / SR},
       "model": {"arch": "ast", "num_classes": 7, "type": "multilabel",
                 **TINY},
       "opt": {"optimizer": "Adam", "lr": 1e-3, "weight_decay": 5e-7,
               "scheduler": "step", "step_size": 1, "gamma": 0.5}}
REF_CFG = {**CFG, "model": {**CFG["model"], **IMAGE}}


@pytest.fixture(scope="module")
def pair():
    """The reference and the port on the reference's seeded weights, and
    a batch of tones with 1–3 labels each."""
    ref = RefClassifier(REF_CFG, device="cpu")
    weights = inputs.make_weights(ref, 11, ref_ast.weight_std)
    port = Classifier(CFG, device="cpu")
    port.load_state_dict(weights)
    x = torch.from_numpy(inputs.tone_clips(5, 2 * B, T, SR, "cpu"))
    ids = inputs.labels(np.random.default_rng(0), 2 * B, 7, True, (1, 3))
    y = inputs.label_targets(ids, 7, True)
    return ref, port, weights, x, y


def test_get_shape_is_asts():
    assert get_shape(10, 10, 128, 1024) == (12, 101)
    assert get_shape(10, 10, 16, 100) == (1, 9)
    assert get_shape(16, 16, 128, 1024) == (8, 64)
    m = ASTModel(num_classes=3, **TINY, **IMAGE, device="cpu")
    assert m.v.pos_embed.shape == (1, 11, 64)


def test_tokens_run_frequency_major():
    # a patch conv that reads each patch's top-left pixel into channel 0:
    # with the tokens and positions zeroed, the first block's input token
    # 2 + f·t_dim + t holds pixel (10 f, 10 t) of the image
    m = ASTModel(num_classes=3, **{**TINY, "input_fdim": 36,
                                   "input_tdim": 46}, device="cpu")
    f_dim, t_dim = get_shape(10, 10, 36, 46)
    with torch.no_grad():
        for p in (m.v.cls_token, m.v.dist_token, m.v.pos_embed,
                  m.v.patch_embed.proj.weight, m.v.patch_embed.proj.bias):
            p.zero_()
        m.v.patch_embed.proj.weight[0, 0, 0, 0] = 1.0
    image = torch.arange(36 * 46, dtype=torch.float32).reshape(1, 36, 46, 1)
    seen = []
    m.v.blocks[0].register_forward_pre_hook(
        lambda mod, args: seen.append(args[0][0, :, 0]))
    m(image)
    want = [float(image[0, 10 * f, 10 * t, 0]) for f in range(f_dim)
            for t in range(t_dim)]
    assert seen[0][:2].tolist() == [0.0, 0.0]
    assert seen[0][2:].tolist() == want


def test_logits_and_gradients_match_the_reference(pair):
    ref, port, _, x, y = pair
    ref.eval(), port.eval()
    with torch.no_grad():
        a, b = ref(x), port(x)
    assert (a - b).abs().max() <= 1e-5 * a.abs().max()
    ref.train(), port.train()
    grads = []
    for model in (ref, port):
        model.zero_grad(set_to_none=True)
        ref_step.loss_fn("multilabel")(model(x), y).backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    assert set(grads[0]) == set(grads[1])
    for name, g in grads[0].items():
        gap = (g - grads[1][name]).abs().max()
        assert gap <= 1e-4 * g.abs().max() + 1e-12, (name, float(gap))


def test_two_train_steps_match_the_reference_trainer(pair):
    ref, _, weights, x, y = pair
    port = Classifier(CFG, device="cpu")
    port.load_state_dict(weights)
    opt, sched, _, _ = optimization_helper(CFG, port.parameters(),
                                           num_tr_steps_per_epoch=10,
                                           num_epochs=2)
    state = TrainState(port, opt, sched)
    multi = make_train_multistep(2, "multilabel",
                                 augment_fn=leaf_device_augment)
    loss = float(multi(state, x.reshape(2, B, T), y.reshape(2, B, 7),
                       torch.Generator().manual_seed(7))["loss"])
    ref = copy.deepcopy(ref)
    ref.load_state_dict(weights)
    trainer = ref_step.Trainer(ref, torch.Generator().manual_seed(7),
                               "multilabel", 5e-7)
    lr = ref_step.schedule(CFG["opt"], 10, 2)
    got, _ = trainer.call([(x[:B], y[:B]), (x[B:], y[B:])], [lr(0), lr(1)])
    assert loss == pytest.approx(float(np.mean(got)), rel=1e-4)
    before = check.start_state(weights)
    p = check.call_readings(before, port_state(state))
    r = check.call_readings(before, trainer.state())
    assert set(p["grad"]) == set(r["grad"]) == set(dict(
        port.named_parameters()))
    assert check.leaf_gap(p["grad"], r["grad"]) < 1e-3
    assert check.leaf_gap(p["moment"], r["moment"]) < 1e-3
    # Adam's first steps move entries at float-noise level by ±lr
    assert check.leaf_gap(p["change"], r["change"],
                          check.moving_leaves(r["grad"])) < 0.05


def test_loads_ast_named_state_dicts():
    ref = ref_ast.Backbone({"num_classes": 7, **TINY, **IMAGE},
                           device="cpu")
    m = get_classifier({"arch": "ast", "num_classes": 7, **TINY},
                       device="cpu", image=(16, 100))
    assert set(m.state_dict()) == set(ref.state_dict())
    names = {"v.blocks.1.attn.qkv.weight", "v.blocks.0.mlp.fc2.bias",
             "v.norm.weight", "mlp_head.0.bias", "mlp_head.1.weight",
             "v.patch_embed.proj.weight", "v.cls_token", "v.dist_token",
             "v.pos_embed", "v.blocks.0.norm1.weight",
             "v.blocks.0.attn.proj.bias", "v.blocks.1.norm2.bias",
             "v.blocks.0.mlp.fc1.weight"}
    assert names <= set(m.state_dict())
    # a state_dict under AST's names loads, and both compute alike
    gen = torch.Generator().manual_seed(1)
    state = {k: torch.randn(v.shape, generator=gen)
             for k, v in ref.state_dict().items()}
    m.load_state_dict(state)
    ref.load_state_dict(state)
    image = torch.randn(2, 16, 100, 1, generator=gen)
    with torch.no_grad():
        a = ref(image.permute(0, 3, 1, 2))
        b = m(image)
    assert (a - b).abs().max() <= 1e-5 * a.abs().max()


def test_bf16_raises():
    with pytest.raises(ValueError, match="bf16 AST is not supported"):
        get_classifier({"arch": "ast", "num_classes": 3,
                        "compute_dtype": "bfloat16", **TINY}, device="cpu")


def test_options_and_checks():
    assert ast_options({"arch": "ast", "num_classes": 3}) == {}
    assert ast_options({"arch": "ast", **TINY, "pool": "avg"}) == TINY
    for bad, what in (({"depth": 0}, "depth must be a whole number"),
                      ({"mlp_ratio": 4.0}, "mlp_ratio must be"),
                      ({"num_heads": True}, "num_heads must be")):
        with pytest.raises(ValueError, match=what):
            ast_options({**TINY, **bad})
    for bad, what in (({"embed_dim": 70}, "multiple of num_heads"),
                      ({"input_tdim": 15}, "less than one 16 x 16 patch")):
        with pytest.raises(ValueError, match=what):
            ASTModel(**{**TINY, **IMAGE, **bad}, device="cpu")
    with pytest.raises(ValueError, match="depth must be"):
        get_classifier({"arch": "ast", "num_classes": 3, **TINY,
                        "depth": -1}, device="cpu")


@pytest.mark.parametrize("filters, seconds, image",
                         [(16, 1, (16, 100)), (16, 0.5, (16, 50)),
                          (20, 0.2501, (20, 26))])
def test_classifier_sizes_ast_from_frontend_and_clip(filters, seconds,
                                                      image):
    # the image is (n_filters, frames of a random_clip_size clip): the
    # frames the frontend gives, ceil(samples / 160) under SAME padding
    cfg = {**CFG, "frontend": {**CFG["frontend"], "n_filters": filters},
           "audio_config": {"sample_rate": SR,
                            "random_clip_size": seconds}}
    m = Classifier(cfg, device="cpu")
    assert m.model.input_shape == image
    x = torch.zeros(1, int(seconds * SR))
    assert tuple(m.features(x).shape[1:]) == (image[1], image[0])


def test_recipe_builds_asts_published_sizes():
    # the recipe as get_config reads it, built on the meta device (no
    # memory): 128 filters over 10.24 s give AST's 128 × 1024 image and
    # 1214 tokens of d 768 in 12 blocks
    cfg = get_config(RECIPE)
    assert cfg["model"]["arch"] == "ast" and cfg["model"]["depth"] == 12
    assert not {"input_fdim", "input_tdim"} & set(cfg["model"])
    m = Classifier(cfg, device="meta")
    assert m.model.input_shape == (128, 1024)
    assert m.model.v.pos_embed.shape == (1, 1214, 768)
    assert len(m.model.v.blocks) == 12


def test_get_classifier_dispatches_ast():
    m = get_classifier({"arch": "ast", "num_classes": 3, **TINY},
                       device="cpu", generator=torch.Generator()
                       .manual_seed(0), image=(16, 100))
    assert isinstance(m, ASTModel)
    again = get_classifier({"arch": "ast", "num_classes": 3, **TINY},
                           device="cpu", generator=torch.Generator()
                           .manual_seed(0), image=(16, 100))
    for (n, a), b in zip(m.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), n
    with torch.no_grad():
        assert float(m.v.blocks[0].norm1.weight.min()) == 1.0
        assert float(m.v.blocks[0].attn.qkv.bias.abs().max()) == 0.0
        assert float(m.v.pos_embed.std()) == pytest.approx(0.02, rel=0.1)
    with pytest.raises(ValueError, match="random_clip_size"):
        m(torch.zeros(2, 16, 90, 1))
    # without an image, AST's own 128 × 1024
    assert get_classifier({"arch": "ast", "num_classes": 3, **TINY},
                          device="cpu").input_shape == (128, 1024)


def test_serving_model_matches_the_reference(pair):
    ref, _, weights, x, _ = pair
    serving = ServingModel(CFG, state_dict=weights, device="cpu",
                           batch_sizes=(2, 4), clip_samples=T)
    got = serving(x[:5].numpy())
    want = ref_step.eval_logits(ref, x[:5]).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_markers_bracket_each_attention_core(monkeypatch, pair):
    # markers on (their launch recorded by name): per block the forward's
    # pair at the core, the backward's in reverse block order; values and
    # gradients bit for bit those of the unmarked run
    _, port, _, x, y = pair
    got = []
    runs = []
    for on in (False, True):
        if on:
            monkeypatch.setattr(tracing, "_marking", lambda t: True)
            monkeypatch.setattr(tracing, "_launch",
                                lambda name, t: got.append(name))
        port.zero_grad(set_to_none=True)
        logits = port.train()(x[:B])
        ref_step.loss_fn("multilabel")(logits, y[:B]).backward()
        runs.append([logits.detach()] + [p.grad.clone()
                                        for p in port.parameters()])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    fwd = ["mark_attention", "mark_attention_end"] * 2
    bwd = ["mark_attention_grad", "mark_attention_grad_end"] * 2
    assert got == (["mark_forward", "mark_frontend"] + fwd
                   + ["mark_backbone"] + bwd + ["mark_backbone_grad"])


def _tiny_experiment(root):
    """8 train and 4 val tone WAVs of 1 s with 1–2 of 3 labels, and a tiny
    copy of the recipe: every AST key at the tiny size, 16 filters, 1 s
    clips, batch 4."""
    rng = np.random.RandomState(0)
    rows = {"train": [], "val": []}
    for i in range(12):
        x = 0.3 * np.sin(2 * np.pi * (300 + 150 * (i % 3)) * np.arange(SR)
                         / SR) + 0.01 * rng.randn(SR)
        path = str(root / f"c{i}.wav")
        write_wav(path, x.astype(np.float32), SR)
        labels = [f"class{i % 3}"] + ([f"class{(i + 1) % 3}"] if i % 2
                                      else [])
        rows["train" if i < 8 else "val"].append(
            f'{path},"{",".join(labels)}"')
    for split, lines in rows.items():
        (root / f"{split}.csv").write_text("files,labels\n"
                                           + "\n".join(lines) + "\n")
    (root / "lbl_map.json").write_text(
        json.dumps({f"class{i}": i for i in range(3)}))
    text = open(RECIPE).read()
    for key, value in {"n_filters": 16, "num_classes": 3, "batch_size": 4,
                       "min_duration": 1, "random_clip_size": 1,
                       "val_clip_size": 1, "lr": "1e-4", **TINY}.items():
        text = re.sub(rf"(\n    {key}: ).*", rf"\g<1>{value}", text)
    text = re.sub(r'meta_root: .*', f'meta_root: "{root}"', text)
    text = text.replace('train_manifest: "balanced_train.csv"',
                        "train_manifest: train.csv")
    (root / "cfg.cfg").write_text(text)
    return root / "cfg.cfg"


def test_train_and_evaluate_clis_on_the_recipe(tmp_path, capsys):
    from leaf_tpu_torch import evaluate, train
    cfg = _tiny_experiment(tmp_path)
    assert get_config(str(cfg))["model"]["depth"] == 2
    expdir = tmp_path / "exp"
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        assert train.main(["--cfg_file", str(cfg), "--expdir", str(expdir),
                           "--epochs", "1", "--num_workers", "1",
                           "--log_steps", "1", "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        m = re.search(r"epoch 0: tr_loss (\S+) ", out)
        assert m and np.isfinite(float(m.group(1))), out[-2000:]
        assert len(re.findall(r"step \d+", out)) >= 2, out[-2000:]
        assert evaluate.main(["--exp_dir", str(expdir), "--meta_dir",
                              str(tmp_path), "--test_csv_name", "val.csv",
                              "--metrics", "multilabel", "--device", "cpu"]) == 0
    finally:
        torch.set_num_threads(before)
    header, row = (expdir / "results.txt").read_text().splitlines()
    assert header == "model,mAP,mAUC,dprime,ckpt" and row.startswith("ast,")
