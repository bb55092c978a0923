"""Run one cell of BENCHMARK.json once and print its result.

    python3 -m leafbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout. The cell's entry in BENCHMARK.json names its
configuration (``leafbench/configs/<config>.json``) and traffic mix
(``leafbench/traffic/<traffic>.json``, whose ``kind`` picks the loop
``leafbench/loops/<kind>.py``); its limits are in
``leafbench/limits/<cell>.json`` and each per-layer metric's reader in
``leafbench/metrics/<metric>.py``. The run builds and warms up the port's
system, measures for ``--seconds`` (under torch.profiler with
``--trace 1``), checks what the timed path produced against the plain
reference, and prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and ``checks`` (each
number compared, with its limit), which the last lines of standard error
repeat. Without a CUDA card (or with fewer than the cell asks for), or
with JAX or the JAX package loaded after the window, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "leafbench")
# what no process of a run may load, compared by whole top-level names
BANNED = ("jax", "jaxlib", "flax", "optax", "leaf_tpu")


def parse(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m leafbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_bench() -> dict:
    return _json(ROOT, "BENCHMARK.json")


def entry(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def applies(metric: dict, workload: str, e2e: list) -> bool:
    """Whether a metric is reported in ``workload`` (which reports the
    end-to-end metrics ``e2e``)."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e


def end_to_end(bench: dict, workload: str) -> list:
    return [m["name"] for m in bench["end_to_end"]
            if "workloads" not in m or workload in m["workloads"]]


def read_metric(name: str, ctx: dict):
    """``leafbench/metrics/<name>.py``'s ``read(ctx)``."""
    spec = importlib.util.spec_from_file_location(
        f"leafbench_metric_{name}", os.path.join(HERE, "metrics",
                                                 f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def make_cell(bench: dict, workload: str, seed: int, seconds: float,
              trace: bool, device, t0: float = T0, **override):
    """The Cell of ``workload``; ``override`` may replace its config,
    traffic or limits (the CPU tests run tiny ones)."""
    from leafbench.cell import Cell
    w = entry(bench, workload)
    return Cell(
        name=workload,
        config=override.get("config") or _json(HERE, "configs",
                                               f"{w['config']}.json"),
        traffic=override.get("traffic") or _json(HERE, "traffic",
                                                 f"{w['traffic']}.json"),
        limits=override.get("limits") or _json(HERE, "limits",
                                               f"{workload}.json"),
        seed=seed, seconds=seconds, trace=trace, device=device, t0=t0,
        tmpdir=tempfile.gettempdir())


def set_precision(cell) -> None:
    """The configuration's precision: TF32 on or off for cuBLAS and cuDNN."""
    import torch
    tf32 = bool(cell.config["precision"]["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def run_cell(bench: dict, cell, chips: int = 1):
    """Run the cell; (record, stderr lines)."""
    from leafbench.measure.card import card
    set_precision(cell)
    loop = importlib.import_module(f"leafbench.loops.{cell.traffic['kind']}")
    out = loop.run(cell)
    e2e = end_to_end(bench, cell.name)
    units = {m["name"]: m["unit"]
             for m in bench["end_to_end"] + bench["per_layer"]}
    metrics = {}
    if not cell.trace:
        for name in e2e:
            metrics[name] = {"value": out.e2e[name], "unit": units[name]}
    else:
        for m in bench["per_layer"]:
            if applies(m, cell.name, e2e):
                value = read_metric(m["name"], out.ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    info = card(cell.device)
    device = {"platform": "gpu" if cell.device.type == "cuda" else "cpu",
              "kind": info["kind"], "count": chips,
              "memory_peak_bytes": out.memory_peak_bytes}
    record = {"correct": out.correct, "attempted": out.attempted,
              "failed": out.failed, "metrics": metrics, "device": device}
    tl = out.ctx.get("timeline")
    if cell.trace and tl is not None:
        device["busy_s"] = tl.busy_s
        device["window_s"] = tl.window_s
        record["breakdown"] = tl.breakdown()
    record["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in out.checks}
    lines = list(out.notes)
    lines.append(f"card {info['kind']}, power limit {info['power_limit']}, "
                 f"setup_s {out.e2e['setup_s']:.6f}, memory peak "
                 f"{out.memory_peak_bytes} bytes")
    lines += [f"check {name} {v!r} limit {lim!r} "
              f"{'ok' if v <= lim else 'FAILED'}"
              for name, v, lim in out.checks]
    return record, lines


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in BANNED})


def main(argv=None) -> int:
    args = parse(argv)
    os.environ.setdefault("USE_FLAX", "0")
    bench = load_bench()
    chips = int(entry(bench, args.workload)["chips"])
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"leafbench: the cell asks for {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    cell = make_cell(bench, args.workload, args.seed, args.seconds,
                     bool(args.trace), torch.device("cuda", 0))
    record, lines = run_cell(bench, cell, chips)
    banned = banned_modules()
    if banned:
        print(f"leafbench: the run loaded {', '.join(banned)}; no result",
              file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
