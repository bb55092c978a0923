"""The readers of the port's own spans and phase markers
(``measure/phases.py`` and ``metrics/*_phase_ms.*``, ``feed_starved_ms``,
``serve_*_ms``) on timelines written by hand."""

from __future__ import annotations

import pytest

from leafbench import run
from leafbench.measure import categories, phases, trace

TRAIN_METRICS = ("augment_phase_ms.train", "frontend_phase_ms.train",
                 "backbone_phase_ms.train", "optimizer_phase_ms.train",
                 "feed_starved_ms.train")
SERVE_METRICS = ("frontend_phase_ms.serve", "backbone_phase_ms.serve",
                 "serve_prepare_ms.serve", "serve_h2d_ms.serve",
                 "serve_launch_ms.serve")


def _mark(name, start):
    return (f"leaf_tpu_torch::{name}()", start, start + 2)


def _train_step(t):
    """One step's rows from t: markers and the kernels between them
    (augment 10, frontend 20 + 20, backbone 50 + 5, optimizer 10 ns)."""
    return [_mark("mark_step", t), ("aug", t + 5, t + 15),
            _mark("mark_forward", t + 20), ("fused_fwd", t + 25, t + 45),
            _mark("mark_frontend", t + 50), ("conv", t + 55, t + 105),
            _mark("mark_backbone", t + 110), ("loss", t + 115, t + 120),
            _mark("mark_backbone_grad", t + 125), ("fused_bwd", t + 130,
                                                   t + 150),
            _mark("mark_backward", t + 155), ("adam", t + 160, t + 170),
            _mark("mark_update", t + 175)]


def _train_timeline():
    dev = ([_mark("mark_backbone_grad", 90), _mark("mark_backward", 110),
            _mark("mark_update", 130)]           # a step cut by the start
           + _train_step(200) + _train_step(400)
           + [_mark("mark_step", 900), _mark("mark_forward", 910),
              _mark("mark_frontend", 999)])      # a step cut by the end
    host = [("leaf_tpu_torch.feed.starved", 150, 170),
            ("leaf_tpu_torch.feed.starved", 600, 630),
            ("leaf_tpu_torch.feed.starved", 40, 60),     # before the window
            ("leaf_tpu_torch.train.replay", 180, 190)]
    return trace.Timeline(dev, host, {trace.WINDOW: [(100, 1000)]})


def _serve_forward(t):
    return [_mark("mark_forward", t), ("fused_fwd", t + 5, t + 25),
            _mark("mark_frontend", t + 30), ("conv", t + 35, t + 95),
            _mark("mark_backbone", t + 100)]


def _serve_timeline():
    dev = ([_mark("mark_frontend", -10), _mark("mark_backbone", 5)]
           + [("Memcpy HtoD (Pageable -> Device)", 50, 90)]
           + _serve_forward(100) + _serve_forward(400)
           + [_mark("mark_forward", 990), _mark("mark_frontend", 1001)])
    host = []
    for t in (20, 320):
        host += [("leaf_tpu_torch.serve.prepare", t, t + 10),
                 ("leaf_tpu_torch.serve.h2d", t + 10, t + 80),
                 ("leaf_tpu_torch.serve.forward", t + 80, t + 120),
                 ("leaf_tpu_torch.serve.fetch", t + 120, t + 270)]
    return trace.Timeline(dev, host, {trace.WINDOW: [(0, 1000)],
                                      "leafbench.request": [(20, 300),
                                                            (320, 600)]})


def _ctx(kind, tl, units):
    return {"kind": kind, "timeline": tl, "units": units}


def test_train_readers_by_hand():
    tl = _train_timeline()
    seqs = phases.sequences(tl, phases.TRAIN_SEQUENCE)
    assert seqs.shape == (2, 7, 2) and seqs[0, 0, 0] == 200
    ctx = _ctx("train", tl, 2)
    got = {name: run.read_metric(name, ctx) for name in TRAIN_METRICS}
    assert got == pytest.approx({
        "augment_phase_ms.train": 10e-6,
        "frontend_phase_ms.train": 40e-6,
        # the backbone's kernels, the loss and the mark_backbone row
        "backbone_phase_ms.train": 57e-6,
        "optimizer_phase_ms.train": 10e-6,
        "feed_starved_ms.train": 50e-6 / 2})


def test_serve_readers_by_hand():
    tl = _serve_timeline()
    assert len(phases.sequences(tl, phases.SERVE_SEQUENCE)) == 2
    ctx = _ctx("serve", tl, 2)
    got = {name: run.read_metric(name, ctx) for name in SERVE_METRICS}
    assert got == pytest.approx({
        "frontend_phase_ms.serve": 20e-6, "backbone_phase_ms.serve": 60e-6,
        "serve_prepare_ms.serve": 10e-6, "serve_h2d_ms.serve": 70e-6,
        "serve_launch_ms.serve": 40e-6})
    # two forwards a request: each forward's phase counts twice
    tl.host_names += ["leaf_tpu_torch.serve.forward"] * 2
    tl.host_start = tl.host_start.tolist() + [700, 750]
    tl.host_end = tl.host_end.tolist() + [710, 760]
    assert run.read_metric("frontend_phase_ms.serve", ctx) == \
        pytest.approx(40e-6)


def test_no_starved_wait_reads_zero_where_the_port_records_spans():
    tl = _train_timeline()
    keep = [i for i, n in enumerate(tl.host_names)
            if n != "leaf_tpu_torch.feed.starved"]
    tl.host_names = [tl.host_names[i] for i in keep]
    tl.host_start, tl.host_end = tl.host_start[keep], tl.host_end[keep]
    assert run.read_metric("feed_starved_ms.train", _ctx("train", tl, 2)) \
        == 0.0


@pytest.mark.parametrize("name", TRAIN_METRICS + SERVE_METRICS)
def test_readers_find_nothing_without_the_ports_trace(name):
    kind = name.rsplit(".", 1)[1]
    assert run.read_metric(name, _ctx(kind, None, 2)) is None
    # a program without the port's spans and markers (the parent's)
    bare = trace.Timeline([("conv", 10, 20)], [("cudaLaunchKernel", 5, 9)],
                          {trace.WINDOW: [(0, 100)]})
    assert run.read_metric(name, _ctx(kind, bare, 2)) is None
    other = "serve" if kind == "train" else "train"
    tl = _train_timeline() if kind == "train" else _serve_timeline()
    assert run.read_metric(name, _ctx(other, tl, 2)) is None


def test_marker_names_fall_in_no_category():
    for m in phases.MARKS:
        for name in (f"leaf_tpu_torch::{m}()", f"void leaf_tpu_torch::{m}()",
                     f"_ZN14leaf_tpu_torch{len(m)}{m}Ev"):
            assert phases.marker(name) == m
            assert categories.category(name) == categories.OTHER
    assert phases.marker("void at::native::mark_step_kernel()") is None
    assert phases.marker("leaf_tpu_torch::mark_other()") is None


def test_frozen_names_are_the_ports():
    from leaf_tpu_torch import tracing
    assert phases.SPANS == tracing.SPANS
    assert phases.MARKS == tracing.MARKS


def test_each_new_metric_is_declared_for_its_cells():
    bench = run.load_bench()
    by_name = {m["name"]: m for m in bench["per_layer"]}
    for name in TRAIN_METRICS + SERVE_METRICS:
        m = by_name[name]
        assert m["source"] == "program_span"
        assert m["workloads"] == (["sc-b0-train", "as-r18-train"]
                                  if name.endswith(".train")
                                  else ["sc-b0-score256"])
