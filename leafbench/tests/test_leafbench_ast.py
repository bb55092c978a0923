"""The AST cell (``as-ast-train``): a tiny AST configuration through the
harness on the CPU, the attention core's readers
(``measure/attention.py``, ``metrics/attention_*.train``) on a timeline
written by hand, and its work count against a count made by hand."""

from __future__ import annotations

import pytest

from leafbench import run
from leafbench.measure import attention, categories, trace, work
from leafbench.tests.tiny import tiny_cell

CELL = "as-ast-train"
METRICS = ("attention_phase_ms.train", "attention_roofline.train")
# the cell's train shapes: (kind, B, T, F, bytes)
CALLS = [("fwd_save", 32, 163840, 128, 4), ("bwd", 32, 163840, 128, 4)]


def test_tiny_ast_cell_through_the_harness():
    # tiny_cell's overrides (0.25 s clips, B = 4, K = 2, 32 clips), with
    # 16 filters (one 16-wide patch) and a tiny AST: 25 frames, one patch
    # row of 1 patch, d 32, 2 blocks, 2 heads. The port derives the 16 × 25
    # image from the frontend and the clip; the reference reads it from
    # the model section, as AST's constructor (its default is 128 × 1024)
    bench, cell = tiny_cell(CELL)
    cell.config["cfg"]["frontend"]["n_filters"] = 16
    cell.config["cfg"]["model"].update(input_fdim=16, input_tdim=25,
                                       embed_dim=32, depth=2, num_heads=2)
    record, lines = run.run_cell(bench, cell)
    assert record["correct"], record["checks"]
    assert record["attempted"] > 0 and record["failed"] == 0
    assert set(record["metrics"]) == set(run.end_to_end(bench, CELL))
    assert set(record["metrics"]) == {"train_clips_per_s", "setup_s"}


def _mark(name, start):
    return (f"leaf_tpu_torch::{name}()", start, start + 2)


def _ast_step(t, cores):
    """One step's rows from t: the seven step markers, and in the
    backbone phase ``cores`` forward cores of 10 ns busy each (one kernel
    of 10) and ``cores`` backward cores of 20 (two kernels of 10)."""
    rows = [_mark("mark_step", t), _mark("mark_forward", t + 5),
            _mark("mark_frontend", t + 10)]
    at = t + 15
    for _ in range(cores):
        rows += [_mark("mark_attention", at), ("fmha_fwd", at + 3, at + 13),
                 _mark("mark_attention_end", at + 14), ("gemm", at + 17,
                                                        at + 19)]
        at += 20
    rows.append(_mark("mark_backbone", at))
    at += 5
    for _ in range(cores):
        rows += [_mark("mark_attention_grad", at),
                 ("fmha_bwd", at + 3, at + 13), ("fmha_bwd", at + 15,
                                                 at + 25),
                 _mark("mark_attention_grad_end", at + 26)]
        at += 30
    rows += [_mark("mark_backbone_grad", at), _mark("mark_backward", at + 5),
             _mark("mark_update", at + 10)]
    return rows, at + 12


def _timeline(cores):
    dev = [_mark("mark_attention_grad", 90),      # a step cut by the start
           _mark("mark_attention_grad_end", 95), _mark("mark_update", 98)]
    t = 200
    for _ in range(2):
        rows, t = _ast_step(t, cores)
        dev += rows
        t += 20
    dev += [_mark("mark_step", t), _mark("mark_forward", t + 5),
            _mark("mark_attention", t + 20)]     # a step cut by the end
    return trace.Timeline(dev, [], {trace.WINDOW: [(100, t + 30)]})


def _ctx(tl, calls=CALLS):
    return {"kind": "train", "timeline": tl, "units": 2,
            "frontend_calls": calls}


def test_readers_by_hand():
    # two complete steps of the configuration's 12 cores: (10 + 20) × 12
    # = 360 ns a step; a step that holds fewer cores (2 here: rows lost)
    # is not counted
    tl = _timeline(cores=12)
    assert run.read_metric("attention_phase_ms.train", _ctx(tl)) == \
        pytest.approx(12 * 30e-6)
    model = attention.ast_model(_ctx(tl))
    want = 100.0 * attention.step_bound_ms(model, 32) / (12 * 30e-6)
    assert run.read_metric("attention_roofline.train", _ctx(tl)) == \
        pytest.approx(want)
    assert run.read_metric("attention_phase_ms.train",
                           _ctx(_timeline(cores=2))) is None


@pytest.mark.parametrize("name", METRICS)
def test_readers_find_nothing_elsewhere(name):
    ctx = _ctx(_timeline(cores=12))
    assert run.read_metric(name, {**ctx, "timeline": None}) is None
    assert run.read_metric(name, {**ctx, "kind": "serve"}) is None
    # the shapes of no AST configuration (another cell's)
    other = [("fwd_save", 128, 80000, 64, 4), ("bwd", 128, 80000, 64, 4)]
    assert run.read_metric(name, _ctx(ctx["timeline"], other)) is None
    # a program without the attention markers (the parent's, a CNN's)
    bare = trace.Timeline(
        [r for r in _ast_step(200, 12)[0] if "attention" not in r[0]],
        [], {trace.WINDOW: [(0, 10_000)]})
    assert run.read_metric(name, _ctx(bare)) is None


def test_work_by_hand():
    # B 2, n 5, H 3, d 4: 150 scores; QKᵀ, PV, dQ, dK, dV, dP 12·150·4
    # products in 3×TF32, the softmax 8 a score, 8 operands of 2·3·5·4
    # floats
    w = attention.core_work(2, 5, 3, 4)
    assert w == {"flops": 1200, "tc_flops": 3 * 7200, "nbytes": 8 * 4 * 120,
                 "tc_peak": work.TF32_PEAK_FLOPS}
    model = {"input_fdim": 128, "input_tdim": 1024, "fstride": 10,
             "tstride": 10, "embed_dim": 768, "num_heads": 12, "depth": 12}
    assert attention.tokens(model) == 12 * 101 + 2
    scores = 32 * 12 * 1214 ** 2
    tc_ms = 3 * 12 * scores * 64 / 494.7e12 * 1e3
    cuda_ms = 8 * scores / 67e12 * 1e3
    assert attention.step_bound_ms(model, 32) == pytest.approx(
        12 * (tc_ms + cuda_ms))
    assert 31 < attention.step_bound_ms(model, 32) < 33


def test_attention_marker_names():
    from leaf_tpu_torch import tracing
    assert attention.ATTENTION_MARKS == tracing.ATTENTION_MARKS
    for m in attention.ATTENTION_MARKS:
        for name in (f"void leaf_tpu_torch::{m}()",
                     f"_ZN14leaf_tpu_torch{len(m)}{m}Ev"):
            assert attention.marker(name) == m
            assert categories.category(name) == categories.OTHER
    assert attention.marker("leaf_tpu_torch::mark_step()") is None


def test_the_cell_is_declared():
    bench = run.load_bench()
    e2e = run.end_to_end(bench, CELL)
    assert set(e2e) == {"train_clips_per_s", "setup_s"}
    reported = {m["name"] for m in bench["per_layer"]
                if run.applies(m, CELL, e2e)}
    assert set(METRICS) <= reported
    assert {"mfu.train", "frontend_roofline.train", "idle_share.train",
            "backbone_ms.train", "data_wait_ms.train"} <= reported
    for m in bench["per_layer"]:
        if m["name"] in METRICS:
            assert m["workloads"] == [CELL]
    model = attention.ast_model(_ctx(None))
    assert model["depth"] == 12
    assert (model["input_fdim"], model["input_tdim"]) == (128, 1024)


def test_two_ast_configurations_of_one_shape_raise(tmp_path, monkeypatch):
    # the run's shapes alone cannot tell them apart: the lookup raises
    # rather than read nothing
    text = open(f"{attention._CONFIGS}/as-ast.json").read()
    for name in ("as-ast.json", "as-ast-twin.json"):
        (tmp_path / name).write_text(text)
    monkeypatch.setattr(attention, "_CONFIGS", str(tmp_path))
    with pytest.raises(ValueError, match="same train shapes"):
        attention.ast_model(_ctx(None))
    (tmp_path / "as-ast-twin.json").unlink()
    assert attention.ast_model(_ctx(None))["depth"] == 12
