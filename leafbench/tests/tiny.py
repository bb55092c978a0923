"""Tiny versions of the benchmark's cells for the CPU tests: 8 LEAF
filters, 0.25 s clips, batches of 4, K = 2, a few requests of 8 clips."""

from __future__ import annotations

import copy

import torch

from leafbench import run

# limits at this size: the port reads ~1e-3 and below on each number
TINY_LIMITS = {
    "train": {"first_logit_gap": 1e-2, "loss_gap": 1e-2, "grad_gap": 0.1,
              "moment_gap": 0.1, "change_gap": 0.1, "replay_loss_gap": 1e-2,
              "replay_grad_gap": 0.1, "replay_moment_gap": 0.1,
              "replay_change_gap": 0.1, "replay_grad_median_gap": 1e-2,
              "rows_bad": 0},
    "serve": {"logit_gap": 1e-3},
}


def tiny_cell(workload: str, trace: bool = False, seconds: float = 0.5,
              seed: int = 2 ** 31 + 77):
    bench = run.load_bench()
    w = run.entry(bench, workload)
    config = copy.deepcopy(run._json(run.HERE, "configs",
                                     f"{w['config']}.json"))
    cfg = config["cfg"]
    cfg["frontend"] = {"name": "leaf", "default_args": False, "n_filters": 8}
    cfg["opt"]["batch_size"] = 4
    for key in ("random_clip_size", "val_clip_size", "min_duration"):
        cfg["audio_config"][key] = 0.25
    traffic = copy.deepcopy(run._json(run.HERE, "traffic",
                                      f"{w['traffic']}.json"))
    if traffic["kind"] == "train":
        traffic.update(clips=32, steps_per_call=2)
    else:
        traffic.update(clips_per_request=8, distinct_requests=3)
    return bench, run.make_cell(
        bench, workload, seed, seconds, trace, torch.device("cpu"),
        config=config, traffic=traffic,
        limits=dict(TINY_LIMITS[traffic["kind"]]))


def tiny_run(workload: str, **kw):
    bench, cell = tiny_cell(workload, **kw)
    return run.run_cell(bench, cell)
