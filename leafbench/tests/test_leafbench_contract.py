"""BENCHMARK.json against the benchmark's contract, and the files each of
its names leads the harness to."""

from __future__ import annotations

import json
import os
import re

import pytest

from leafbench import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = run.load_bench()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(run.ROOT, "BENCHMARK.json")) < 65536
    assert BENCH["paths"] == ["leafbench"]
    assert BENCH["command"][:3] == ["python3", "-m", "leafbench.run"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its 43200 s
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (BENCH["run_seconds"] + 60) + cells * 180 + 1200 <= 43200


def test_names_units_and_entries():
    names = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"})):
        for e in BENCH[group]:
            assert set(e) == keys, e
            assert NAME.match(e["name"]), e["name"]
            assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for e in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(e["name"]) and e["name"] not in names
        names.add(e["name"])
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        assert e["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(e.get("workloads", CELLS)) <= set(CELLS)
    for e in BENCH["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert e["source"] in ("device_trace", "host_clock")
        assert 0.01 <= e["bound"] <= 0.25
    e2e = {e["name"] for e in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for e in BENCH["per_layer"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert e["moves"] in e2e


def test_every_cell_reports_enough():
    for cell in CELLS:
        e2e = run.end_to_end(BENCH, cell)
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(run.applies(m, cell, e2e) for m in BENCH["per_layer"])
        for m in BENCH["per_layer"]:
            if cell in m.get("workloads", []):
                assert m["moves"] in e2e, (cell, m["name"])


@pytest.mark.parametrize("cell", CELLS)
def test_each_name_finds_its_files(cell):
    w = run.entry(BENCH, cell)
    assert w["chips"] == 1
    config = run._json(run.HERE, "configs", f"{w['config']}.json")
    assert {"cfg", "precision", "schedule", "source", "reduced"} <= set(config)
    traffic = run._json(run.HERE, "traffic", f"{w['traffic']}.json")
    assert os.path.exists(os.path.join(run.HERE, "loops",
                                       f"{traffic['kind']}.py"))
    limits = run._json(run.HERE, "limits", f"{cell}.json")
    assert any(v is not None for v in limits.values())


def test_config_files_and_metric_readers_exist():
    for c in BENCH["configs"]:
        assert c["file"] == f"leafbench/configs/{c['name']}.json"
        assert os.path.exists(os.path.join(run.ROOT, c["file"]))
        assert set(c["reduced"]) <= set(
            run._json(run.ROOT, c["file"])["cfg"])
    for m in BENCH["per_layer"]:
        assert os.path.exists(os.path.join(run.HERE, "metrics",
                                           f"{m['name']}.py")), m["name"]


def test_configs_hold_the_recipes_cfg():
    """Each configuration's cfg is the repo recipe's, as the port's reader
    reads it, but for the keys its ``reduced`` lists."""
    from leaf_tpu_torch.training import get_config
    for c in BENCH["configs"]:
        config = run._json(run.ROOT, c["file"])
        recipe = get_config(os.path.join(
            run.ROOT, config["cfg_file"].split(" ")[0]))
        for key, value in config["cfg"].items():
            if key not in c["reduced"]:
                assert json.loads(json.dumps(recipe[key])) == value, key
