"""The readings that the limits of ``limits/<workload>.json`` are set from
(the benchmark's own runs do not run this).

    python3 -m leafbench.study --workload <cell> --seeds <n> [<n> ...]
        [--readings port control fault]

For each seed, on the card, at the cell's own sizes, with the plain
reference in the port's place:

- ``control``: the reference computed one precision step below the
  configuration's (TF32 on for its float32) against the reference as
  stated;
- training cells, ``fault.half_batch``: the reference whose loss leaves
  out half of each batch (the mean taken over the rest) against the
  reference as stated (a step that returns its state unchanged reads 1
  on ``change_gap`` and ``replay_change_gap`` by their definition and
  needs no run); each runs both calls from the seed, and the reference's
  second call starts from its state after the first, as a run's check
  starts from the port's;
- scoring cells, ``fault.answer_altered``: one clip's logits in one
  request swapped with its neighbour's, against the reference;
- ``port`` (training cells): the port's two checked calls, the run's
  set-up path without its window, against the reference.

The port's own (the lower) readings are these and the ``checks`` of the
benchmark's runs. Each training reading adds the median leaf's gap and
the worst leaves of each call's gradient, moment and change. One JSON
line per seed and reading.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile

import numpy as np

import torch

from leafbench import check, run
from leafbench.loops import serve, train
from leafbench.reference import step as ref_step


def _look(start: dict, port: dict, ref: dict, top: int = 4) -> dict:
    """Of each call's gradient, moment and change: the median leaf's gap
    and the ``top`` worst leaves (name, gap, reference norm)."""
    out = {}
    before = [start, port["states"][0]]
    for c, prefix in enumerate(("", "replay_")):
        p = check.call_readings(before[c], port["states"][c])
        r = check.call_readings(before[c], ref["states"][c])
        for key in ("grad", "moment", "change"):
            med = float(np.median(list(r[key].values())))
            gaps = {n: abs(p[key][n] - r[key][n]) / max(r[key][n], med,
                                                         1e-30)
                    for n in r[key]}
            worst = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
            out[f"{prefix}{key}_median_leaf_gap"] = check.median_gap(p[key],
                                                                     r[key])
            out[f"{prefix}{key}_worst"] = [[n, g, r[key][n]]
                                           for n, g in worst]
    return out


def _numbers(data: dict, port: dict, ref: dict) -> dict:
    out = train.numbers(data, port, ref)
    if not out["rows_bad"]:
        out.update(_look(check.start_state(data["weights"]), port, ref))
    return out


def port_train_readings(cell) -> dict:
    """The port's two checked calls (the run's set-up path, no window)."""
    data = train.make_inputs(cell)
    root = tempfile.mkdtemp(prefix="leafbench-", dir=cell.tmpdir)
    try:
        prog = train.Program(cell, data, root)
        port = train.port_readings(cell, prog)
        prog.close()
        del prog
        train.free(cell.device)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    ref = train.reference_readings(cell, data, port["fed"],
                                   restart=port["states"][0])
    return {"port": _numbers(data, port, ref)}


def train_readings(cell, readings) -> dict:
    """The control and the planted fault, each in the port's place: run
    from the seed through both calls, against the reference whose second
    call starts from its state after the first."""
    data = train.make_inputs(cell)
    sh = train.shapes(cell)
    # the first 2·K·B clips in the seed's order stand in for the fed rows
    n = sh["k"] * sh["b"]
    fed = [(torch.from_numpy(data["pcm"][c * n:(c + 1) * n])
            .to(cell.device).reshape(sh["k"], sh["b"], sh["t"]),
            data["targets"][c * n:(c + 1) * n].to(cell.device)
            .reshape(sh["k"], sh["b"], *data["targets"].shape[1:]))
           for c in range(2)]
    out = {}
    for name, kw, tf32 in (("control", {}, True),
                           ("fault.half_batch", {"keep_rows": sh["b"] // 2},
                            False)):
        if name.split(".")[0] not in readings:
            continue
        with ref_step.tf32(tf32):
            got = train.reference_readings(cell, data, fed, **kw)
        ref = train.reference_readings(cell, data, fed,
                                       restart=got["states"][0])
        out[name] = _numbers(data, got, ref)
    return out


def serve_readings(cell) -> dict:
    data = serve.make_inputs(cell)
    used = list(range(len(data["requests"])))
    ref = serve.reference_logits(cell, data, used)
    low = serve.reference_logits(cell, data, used, tf32=True)
    altered = {j: v.copy() for j, v in ref.items()}
    altered[0][[0, 1]] = altered[0][[1, 0]]
    return {"control": {"logit_gap": max(check.logit_gap(low[j], ref[j])
                                         for j in used)},
            "fault.answer_altered": {"logit_gap": max(
                check.logit_gap(altered[j], ref[j]) for j in used)}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m leafbench.study")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--readings", nargs="+", default=["control", "fault"],
                   choices=["port", "control", "fault"],
                   help="port: the port's checked calls (training cells)")
    args = p.parse_args(argv)
    bench = run.load_bench()
    if not torch.cuda.is_available():
        print("leafbench.study: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        cell = run.make_cell(bench, args.workload, seed, 0.0, False,
                             torch.device("cuda", 0))
        run.set_precision(cell)
        kind = cell.traffic["kind"]
        got = (train_readings(cell, args.readings) if kind == "train"
               else serve_readings(cell))
        if "port" in args.readings and kind == "train":
            got.update(port_train_readings(cell))
        for name, numbers in got.items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "reading": name, **numbers}), flush=True)
        train.free(cell.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
