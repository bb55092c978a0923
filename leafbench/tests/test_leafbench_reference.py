"""The plain reference held against leaf_tpu_torch at a tiny size on the
CPU (the test imports both; the reference itself imports nothing of the
port)."""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from leafbench import check, inputs
from leafbench.loops.train import port_state
from leafbench.reference import step as ref_step
from leafbench.reference.classifier import Classifier, backbone_module

CFGS = {
    "efficientnet": {"frontend": {"name": "leaf", "default_args": False,
                                  "n_filters": 8},
                     "audio_config": {"sample_rate": 16000},
                     "model": {"arch": "efficientnet", "model_depth": "b0",
                               "num_classes": 10, "type": "multiclass"},
                     "opt": {"lr": 1e-3, "weight_decay": 1e-4,
                             "scheduler": "warmupcosine",
                             "warmup_epochs": 10}},
    "resnet": {"frontend": {"name": "leaf", "default_args": False,
                            "n_filters": 8},
               "audio_config": {"sample_rate": 16000},
               "model": {"arch": "resnet", "model_depth": 18,
                         "num_classes": 10, "pool": "avgpool",
                         "type": "multilabel"},
               "opt": {"lr": 1e-3, "weight_decay": 1e-4,
                       "scheduler": "warmupcosine", "warmup_epochs": 10}},
}


def _pair(arch):
    from leaf_tpu_torch.models import Classifier as PortClassifier
    cfg = CFGS[arch]
    ref = Classifier(cfg, device="cpu")
    weights = inputs.make_weights(ref, 11, backbone_module(cfg).weight_std)
    port = PortClassifier(cfg, device="cpu")
    port.load_state_dict(weights)
    x = torch.from_numpy(inputs.tone_clips(5, 16, 4000, 16000, "cpu"))
    return cfg, ref, port, weights, x


@pytest.mark.parametrize("arch", sorted(CFGS))
def test_forward_matches_the_port(arch):
    from leaf_tpu_torch.data import leaf_device_augment
    cfg, ref, port, _, x = _pair(arch)
    ref.eval(), port.eval()
    torch.testing.assert_close(ref(x), port(x), rtol=1e-4, atol=1e-5)
    # train mode: the same augment and mask draws from the same generator
    ref.train(), port.train()
    g_ref = torch.Generator().manual_seed(3)
    g_port = torch.Generator().manual_seed(3)
    a = ref(ref_step.augment(g_ref, x), g_ref)
    b = port(leaf_device_augment(g_port, x), g_port)
    assert (a - b).abs().max() <= 1e-4 * a.abs().max()
    assert torch.equal(g_ref.get_state(), g_port.get_state())


@pytest.mark.parametrize("arch", sorted(CFGS))
def test_train_steps_match_the_port(arch):
    from leaf_tpu_torch.data import leaf_device_augment
    from leaf_tpu_torch.training import (TrainState, make_train_step,
                                         optimization_helper)
    cfg, ref, port, weights, x = _pair(arch)
    mtype = cfg["model"]["type"]
    y = (torch.arange(16) % 10 if mtype == "multiclass"
         else (torch.rand(16, 10, generator=torch.Generator()
                          .manual_seed(0)) < 0.3).float())
    batches = [(x[:8], y[:8]), (x[8:], y[8:])]
    # the warm-up's small first updates: at a full lr, Adam's sign-like
    # first steps carry float noise at ReLU kinks into every gradient
    opt, sched, _, _ = optimization_helper(cfg, port.parameters(),
                                           num_tr_steps_per_epoch=10,
                                           num_epochs=40)
    state = TrainState(port, opt, sched)
    step = make_train_step(mtype, augment_fn=leaf_device_augment)
    g = torch.Generator().manual_seed(7)
    losses, states = [], []
    for xb, yb in batches:
        losses.append(float(step(state, xb, yb, g)["loss"]))
        states.append(port_state(state))
    # the reference's second step starts from the port's state after the
    # first, as a run's check of the graph's first replay does
    lr = ref_step.schedule(cfg["opt"], 10, 40)
    trainer = ref_step.Trainer(ref, torch.Generator().manual_seed(7), mtype,
                               1e-4)
    got, ref_states = [], []
    for c, batch in enumerate(batches):
        if c == 1:
            trainer.load(states[0])
        got += trainer.call([batch], [lr(c)])[0]
        ref_states.append(trainer.state())
    np.testing.assert_allclose(got, losses, rtol=1e-4)
    before = [check.start_state(weights), states[0]]
    for c in range(2):
        p = check.call_readings(before[c], states[c])
        r = check.call_readings(before[c], ref_states[c])
        assert set(p["grad"]) == set(r["grad"]) == set(weights) & set(
            r["grad"])
        assert check.leaf_gap(p["grad"], r["grad"]) < 1e-3
        assert check.leaf_gap(p["moment"], r["moment"]) < 1e-3
        assert check.leaf_gap(p["change"], r["change"],
                              check.moving_leaves(r["grad"])) < 0.05


def test_eval_logits_in_blocks():
    cfg, ref, _, _, x = _pair("resnet")
    torch.testing.assert_close(ref_step.eval_logits(ref, x, block=5),
                               ref.eval()(x), rtol=1e-5, atol=1e-6)


def test_seeds_give_the_same_inputs():
    a = inputs.Seeds(2 ** 33 + 1)
    b = inputs.Seeds(2 ** 33 + 1)
    assert a.torch_seed("w") == b.torch_seed("w") != a.torch_seed("x")
    x = inputs.tone_clips(a.torch_seed("c"), 3, 800, 16000, "cpu")
    y = inputs.tone_clips(b.torch_seed("c"), 3, 800, 16000, "cpu")
    assert np.array_equal(x, y) and np.abs(x).max() < 1.0
    ids = inputs.labels(a.numpy("l"), 50, 527, True, (1, 5))
    assert all(1 <= len(set(i)) == len(i) <= 5 for i in ids)
    _ = copy.deepcopy(ids)
