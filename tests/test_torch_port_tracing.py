"""The port's spans and device phase markers (leaf_tpu_torch.tracing) on
the CPU: what a span costs with the profiler off, where the spans and
markers fall, and that neither changes a value. The markers launch only
on the card (tests/test_torch_port_cuda.py runs them there); here their
launch is replaced by a recorder where a test needs to see the order."""

import copy
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from leaf_tpu_torch import tracing
from leaf_tpu_torch.data import loader
from leaf_tpu_torch.models import Classifier
from leaf_tpu_torch.serving import ServingModel, save_exported
from leaf_tpu_torch.training import (TrainState, make_train_multistep,
                                     make_train_step, optimization_helper)

T = 800
CFG = {"frontend": {"name": "leaf", "default_args": False, "n_filters": 4},
       "audio_config": {"sample_rate": 16000},
       "model": {"arch": "cifar_resnet", "model_depth": 20, "num_classes": 3},
       "opt": {"optimizer": "Adam", "lr": 1e-3, "weight_decay": 1e-4,
               "scheduler": "warmupcosine", "warmup_epochs": 1}}


@pytest.fixture(scope="module")
def weights():
    return Classifier(CFG, device="cpu",
                      generator=torch.Generator().manual_seed(0)).state_dict()


@pytest.fixture
def launches(monkeypatch):
    """Markers on: every ``mark``/``boundary`` decision reads True and
    each launch is recorded by name instead of reaching the card."""
    got = []
    monkeypatch.setattr(tracing, "_marking", lambda x: True)
    monkeypatch.setattr(tracing, "_launch", lambda name, x: got.append(name))
    return got


def _waveforms(n, seed=0):
    return (np.random.RandomState(seed).randn(n, T) * 0.1).astype(np.float32)


def _serving(weights):
    return ServingModel(CFG, state_dict=weights, device="cpu",
                        batch_sizes=(2, 4), clip_samples=T)


def _port_spans(prof):
    return sorted((e for e in prof.events()
                   if e.name.startswith("leaf_tpu_torch.")),
                  key=lambda e: e.time_range.start)


def test_names():
    assert len(set(tracing.SPANS)) == 6 and len(set(tracing.MARKS)) == 7
    assert all(s.startswith("leaf_tpu_torch.") for s in tracing.SPANS)
    assert tracing.MARKS[0] == "mark_step" and \
        tracing.MARKS[-1] == "mark_update"
    assert sorted(tracing.__all__) == ["ATTENTION_MARKS", "MARKS", "SPANS",
                                       "attention", "boundary", "mark",
                                       "span"]
    assert len(set(tracing.MARKS + tracing.ATTENTION_MARKS)) == 11


def test_span_off_enters_no_profiler_op(monkeypatch, weights):
    entered = []
    real = torch.ops.profiler._record_function_enter_new
    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        lambda *a: entered.append(a[0]) or real(*a))
    with tracing.span("leaf_tpu_torch.serve.h2d"):
        pass
    _serving(weights)(_waveforms(3))
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("leaf_tpu_torch.serve.h2d"):
            pass
    assert entered == ["leaf_tpu_torch.serve.h2d"]


def test_serving_records_its_spans_per_chunk(weights):
    model = _serving(weights)
    x = _waveforms(6)                    # chunks of 4 and 2 clips
    plain = model(x)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("caller"):
            traced = model(x)
    assert np.array_equal(plain, traced)
    spans = _port_spans(prof)
    per_chunk = ["prepare", "h2d", "forward", "fetch"]
    assert [e.name.rsplit(".", 1)[1] for e in spans] == \
        ["prepare"] + per_chunk * 2 + ["fetch"]
    caller, = [e for e in prof.events() if e.name == "caller"]
    for e in spans:
        assert caller.time_range.start <= e.time_range.start
        assert e.time_range.end <= caller.time_range.end
    for a, b in zip(spans, spans[1:]):
        assert a.time_range.end <= b.time_range.start


def test_serving_outputs_are_bitwise_the_models(weights, launches):
    model = _serving(weights)
    x = _waveforms(5)
    live = Classifier(CFG, device="cpu")
    live.load_state_dict(weights)
    live.eval()
    with torch.inference_mode():
        want = np.concatenate([live(torch.from_numpy(x[:4])).numpy(),
                               live(torch.from_numpy(
                                   np.concatenate([x[4:], 0 * x[:1]])))
                               .numpy()[:1]])
    launches.clear()
    assert np.array_equal(model(x), want)
    assert launches == ["mark_forward", "mark_frontend",
                        "mark_backbone"] * 2


def _items(n):
    return [(np.full((2, 3), i, np.float32),) for i in range(n)]


@pytest.mark.parametrize("slow", [True, False])
def test_prefetch_records_starved_waits_only(slow):
    def produce():
        for item in _items(4):
            if slow:
                time.sleep(0.05)         # the feeder is late every time
            yield item

    feed = loader.prefetch_to_device(produce(), lambda b: b, size=2)
    got = [next(feed)]                   # starts the feeder, untraced
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for item in feed:
            got.append(item)
            if not slow:
                time.sleep(0.05)         # the queue refills meanwhile
    starved = [e for e in _port_spans(prof)
               if e.name == "leaf_tpu_torch.feed.starved"]
    assert [g[0].tolist() for g in got] == [i[0].tolist() for i in _items(4)]
    assert (len(starved) >= 3) if slow else (starved == [])


@pytest.mark.parametrize("marking", [False, True])
def test_boundary_is_the_identity_bitwise(monkeypatch, marking):
    got = []
    if marking:
        monkeypatch.setattr(tracing, "_marking", lambda x: True)
        monkeypatch.setattr(tracing, "_launch",
                            lambda name, x: got.append(name))
    x = torch.randn(3, 5, requires_grad=True)
    y = tracing.boundary(x * 2.0)
    assert torch.equal(y, x * 2.0)
    w = torch.randn(3, 5)
    (y * w).sum().backward()
    assert torch.equal(x.grad, 2.0 * w)
    assert got == (["mark_frontend", "mark_backbone_grad"] if marking
                   else [])
    with torch.no_grad():
        z = x * 3.0
        out = tracing.boundary(z)
    assert torch.equal(out, z) and out.grad_fn is None
    if marking:             # marks its forward, records no backward
        assert got[2:] == ["mark_frontend"]
    else:
        assert out is z


class _Card:
    """Stands for a CUDA tensor in the launch rule (only ``is_cuda`` is
    read before the rule decides)."""
    is_cuda = True


@pytest.mark.parametrize("cuda,compiling,profiling,capturing,want", [
    (False, False, True, True, False),      # the CPU: never
    (True, True, True, True, False),        # compile/export: never
    (True, False, False, False, False),     # eager, tracing off
    (True, False, True, False, True),       # a profiler is on
    (True, False, False, True, True),       # a graph is being captured
])
def test_launch_rule(monkeypatch, cuda, compiling, profiling, capturing,
                     want):
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: compiling)
    monkeypatch.setattr(tracing, "_profiling", lambda: profiling)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing)
    x = _Card() if cuda else torch.zeros(1)
    assert tracing._marking(x) is want


def test_markers_are_off_where_their_library_fails(monkeypatch):
    # no nvcc (or no loadable library): one warning per device, then the
    # markers are skipped and the step runs on
    from leaf_tpu_torch.ops import _build
    calls = []

    def no_build():
        calls.append(1)
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "load_library", no_build)
    monkeypatch.setattr(tracing, "_LOADED", {})
    card = _Card()
    card.device = torch.device("cuda", 0)
    with pytest.warns(UserWarning, match="markers off on cuda:0"):
        assert tracing._load_marks(card.device) is None
    tracing._launch("mark_step", card)
    assert tracing._load_marks(torch.device("cuda", 0)) is None
    assert calls == [1]


def test_mark_is_a_no_op_on_the_cpu(monkeypatch):
    def refuse(name, x):
        raise AssertionError(f"{name} launched on the CPU")

    monkeypatch.setattr(tracing, "_launch", refuse)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    x = torch.randn(2, 3, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]):
        for name in tracing.MARKS:
            tracing.mark(name, x)
        y = tracing.boundary(x)
        y.sum().backward()
    assert y is x


def _state(weights):
    model = Classifier(CFG, device="cpu")
    model.load_state_dict(weights)
    opt, sched, _, _ = optimization_helper(
        CFG, model.parameters(), num_tr_steps_per_epoch=2, num_epochs=2)
    return TrainState(model, opt, sched)


def _batches(k):
    rng = np.random.RandomState(1)
    return (torch.from_numpy((rng.randn(k, 2, T) * 0.1).astype(np.float32)),
            torch.from_numpy(rng.randint(0, 3, (k, 2))))


@pytest.mark.parametrize("k", [1, 2])
def test_train_steps_mark_their_phases_in_order(weights, launches, k):
    xs, ys = _batches(k)
    st = _state(weights)
    if k == 1:
        make_train_step()(st, xs[0], ys[0], torch.Generator())
    else:
        make_train_multistep(k)(st, xs, ys, torch.Generator())
    assert launches == list(tracing.MARKS) * k


def test_traced_train_step_is_bitwise_the_plain_one(weights, monkeypatch):
    xs, ys = _batches(2)
    runs = []
    for traced in (False, True):
        st = _state(copy.deepcopy(weights))
        step = make_train_multistep(2)
        if traced:
            got = []
            monkeypatch.setattr(tracing, "_marking", lambda x: True)
            monkeypatch.setattr(tracing, "_launch",
                                lambda name, x: got.append(name))
            with profile(activities=[ProfilerActivity.CPU]):
                out = step(st, xs, ys, torch.Generator().manual_seed(5))
            assert len(got) == 14
        else:
            out = step(st, xs, ys, torch.Generator().manual_seed(5))
        runs.append((out, st.model.state_dict()))
    (a, sa), (b, sb) = runs
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert all(torch.equal(sa[n], sb[n]) for n in sa)


def test_exported_program_holds_no_marker(weights, tmp_path, monkeypatch):
    def refuse(name, x):
        raise AssertionError(f"{name} launched while exporting")

    monkeypatch.setattr(tracing, "_launch", refuse)
    with profile(activities=[ProfilerActivity.CPU]):
        save_exported(str(tmp_path), CFG, state_dict=weights,
                      batch_sizes=(2,), clip_samples=T, device="cpu")
    program = torch.export.load(str(tmp_path / "model_b2.pt2"))
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert targets and not any("mark" in t or "Boundary" in t
                               for t in targets)
    x = _waveforms(2)
    assert np.array_equal(ServingModel.load(str(tmp_path), device="cpu")(x),
                          _serving(weights)(x))
