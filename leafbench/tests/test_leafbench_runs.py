"""Tiny runs of each traffic kind on the CPU through the harness (its
look for a card skipped): the record's keys, the metrics each run
reports, and ``correct`` false when the timed path is broken underneath."""

from __future__ import annotations

import json

import numpy as np
import pytest

from leafbench import run
from leafbench.tests.tiny import tiny_run

TRAIN, SERVE = "sc-b0-train", "sc-b0-score256"


def _keys(record, trace):
    assert list(record)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(record)[-1] == "checks"
    assert set(record["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    if trace:
        assert set(record["device"]) >= {"busy_s", "window_s"}
        assert set(record["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(record)
    for name, check in record["checks"].items():
        assert set(check) == {"value", "limit"}, name


@pytest.mark.parametrize("workload,trace", [(TRAIN, False), (TRAIN, True),
                                            (SERVE, False), (SERVE, True)])
def test_tiny_run(workload, trace):
    record, lines = tiny_run(workload, trace=trace)
    _keys(record, trace)
    assert record["correct"], record["checks"]
    assert record["attempted"] > 0 and record["failed"] == 0
    bench = run.load_bench()
    e2e = run.end_to_end(bench, workload)
    if not trace:
        assert set(record["metrics"]) == set(e2e)
    else:
        # on the CPU the trace holds no device rows: only the host's
        # metrics are read, the device's left out
        assert set(record["metrics"]) <= {m["name"] for m in
                                          bench["per_layer"]}
        assert not any(n.startswith(("idle_share", "backbone_ms",
                                     "frontend_roofline"))
                       for n in record["metrics"])
    for name, check in record["checks"].items():
        assert f"check {name} {check['value']!r} limit " \
               f"{check['limit']!r} ok" in lines


def _step_keeps_state(monkeypatch):
    from leaf_tpu_torch.training import state
    monkeypatch.setattr(state.TrainState, "apply_gradients",
                        lambda self: setattr(self, "step", self.step + 1))


def _half_batch(monkeypatch):
    from leaf_tpu_torch.training import steps
    orig = steps.cross_entropy_loss

    def half(logits, y):
        n = logits.shape[0] // 2
        return orig(logits[n:], y[n:])
    monkeypatch.setattr(steps, "cross_entropy_loss", half)


def _answer_altered(monkeypatch):
    from leaf_tpu_torch import serving
    orig = serving.ServingModel.__call__

    def altered(self, waveforms):
        out = orig(self, waveforms)
        out[[0, 1]] = out[[1, 0]]
        return out
    monkeypatch.setattr(serving.ServingModel, "__call__", altered)


@pytest.mark.parametrize("workload,plant,fails", [
    (TRAIN, _step_keeps_state, "change_gap"),
    (TRAIN, _half_batch, "moment_gap"),
    (SERVE, _answer_altered, "logit_gap")])
def test_broken_timed_path_is_not_correct(monkeypatch, workload, plant,
                                          fails):
    plant(monkeypatch)
    record, lines = tiny_run(workload)
    assert not record["correct"]
    check = record["checks"][fails]
    assert check["value"] > check["limit"]
    assert any(line.startswith(f"check {fails} ") and
               line.endswith("FAILED") for line in lines)


def test_fed_rows_that_are_not_the_seeds_clips_fail(monkeypatch):
    from leafbench.loops import train
    orig = train.port_readings

    def corrupt(cell, prog):
        out = orig(cell, prog)
        xs, ys = out["fed"][0]
        out["fed"][0] = (xs.flip(1), ys)
        return out
    monkeypatch.setattr(train, "port_readings", corrupt)
    record, _ = tiny_run(TRAIN)
    assert not record["correct"]
    assert record["checks"]["rows_bad"]["value"] > 0


def test_p95_is_over_all_requests():
    lat = np.arange(1.0, 101.0)
    assert np.percentile(lat, 95) == pytest.approx(95.05)
