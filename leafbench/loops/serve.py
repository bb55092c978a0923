"""Scoring traffic: a closed loop of requests into ``ServingModel``.

The mix's data file gives the clips per request, how many distinct
requests the seed makes, the serving buckets (``batch_sizes``; the
port's default where it names none) and the callers (one, no think
time); the configuration gives the clip length (``val_clip_size``) and
the model. Set-up makes the requests as host float32 arrays, the weights
(the backbone's BatchNorm running statistics set by the reference from a
batch of the seed's clips, so that eval-mode logits are O(1)), the
port's ``ServingModel`` (the live module, eval mode) and warms it on a
request. The window sends the requests in a seeded order, each when the
previous one's logits are on the host, and times each from the call to
its logits on the host. After it the port is freed and the reference
scores each distinct request once; every request of the window is
compared with it (``check.logit_gap``).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch
from torch.profiler import record_function

from leafbench import check, inputs
from leafbench.cell import Cell, Outcome
from leafbench.measure import trace
from leafbench.reference import step as ref_step
from leafbench.reference.classifier import Classifier as RefClassifier
from leafbench.reference.classifier import backbone_module
from leafbench.reference.common import set_running_stats

WARMUP_REQUESTS = 2      # set-up's requests, before the window
STATS_CLIPS = 64         # the clips that set the BatchNorm statistics


def shapes(cell: Cell) -> dict:
    cfg, tr = cell.cfg, cell.traffic
    sr = int(cfg["audio_config"]["sample_rate"])
    return {"r": int(tr["clips_per_request"]),
            "n": int(tr["distinct_requests"]),
            "t": int(float(cfg["audio_config"]["val_clip_size"]) * sr),
            "sr": sr,
            "f": int(40 if cfg["frontend"].get("default_args")
                     else cfg["frontend"].get("n_filters", 40))}


def make_inputs(cell: Cell) -> dict:
    sh = shapes(cell)
    seeds = inputs.Seeds(cell.seed)
    clips = inputs.tone_clips(seeds.torch_seed("clips"), sh["n"] * sh["r"],
                              sh["t"], sh["sr"], cell.device)
    stats = torch.from_numpy(inputs.tone_clips(
        seeds.torch_seed("stats"), STATS_CLIPS,
        sh["t"], sh["sr"], cell.device)).to(cell.device)
    ref = RefClassifier(cell.cfg, device=cell.device)
    inputs.make_weights(ref, seeds.torch_seed("weights"),
                        backbone_module(cell.cfg).weight_std)
    ref.train()
    with torch.no_grad():
        set_running_stats(ref.model, lambda: ref(stats))
    weights = {k: v.detach().clone() for k, v in ref.state_dict().items()}
    del ref, stats
    return {"requests": [clips[j * sh["r"]:(j + 1) * sh["r"]]
                         for j in range(sh["n"])],
            "weights": weights,
            "order": seeds.numpy("order").integers(0, sh["n"], 1 << 20)}


def reference_logits(cell: Cell, data: dict, used, *, tf32: bool = False
                     ) -> dict:
    """The reference's eval-mode logits of each request in ``used``."""
    model = RefClassifier(cell.cfg, device=cell.device)
    model.load_state_dict(data["weights"])
    with ref_step.tf32(tf32):
        return {j: ref_step.eval_logits(model, torch.from_numpy(
            data["requests"][j]).to(cell.device)).cpu().numpy()
            for j in sorted(set(used))}


def run(cell: Cell) -> Outcome:
    from leaf_tpu_torch import ServingModel
    sh = shapes(cell)
    marks = [("start", time.monotonic() - cell.t0)]
    data = make_inputs(cell)
    marks.append(("inputs", time.monotonic() - cell.t0))
    buckets = cell.traffic.get("batch_sizes")
    model = ServingModel(cell.cfg, state_dict=data["weights"],
                         device=cell.device, clip_samples=sh["t"],
                         **({"batch_sizes": tuple(buckets)} if buckets
                            else {}))
    for j in range(WARMUP_REQUESTS):
        model(data["requests"][j])
    marks.append(("warm", time.monotonic() - cell.t0))
    order, outs, lat = data["order"], [], []
    with trace.traced(cell.trace) as traced:
        with record_function(trace.WINDOW):
            t_start = time.perf_counter()
            setup_s = time.monotonic() - cell.t0
            deadline = t_start + cell.seconds
            while True:
                j = int(order[len(outs) % len(order)])
                t = time.perf_counter()
                with record_function("leafbench.request"):
                    logits = model(data["requests"][j])
                done = time.perf_counter()
                lat.append((done - t) * 1e3)
                outs.append((j, logits))
                if done >= deadline:
                    break
            t_end = time.perf_counter()
    window_s = t_end - t_start
    peak = (torch.cuda.max_memory_allocated(cell.device)
            if cell.device.type == "cuda" else 0)
    del model
    gc.collect()
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    failed = sum(1 for _, o in outs if o.shape != (sh["r"], o.shape[1])
                 or not np.isfinite(o).all())
    t_ref = time.perf_counter()
    ref = reference_logits(cell, data, [j for j, _ in outs])
    gap = max(check.logit_gap(o, ref[j]) for j, o in outs)
    t_ref = time.perf_counter() - t_ref
    n = len(outs)
    ctx = {"kind": "serve", "timeline": traced.timeline,
           "window_s": window_s, "units": n, "clips": n * sh["r"],
           "frontend_calls": [("fwd", sh["r"], sh["t"], sh["f"], 4)],
           "flops_per_unit": (lambda: _flops(cell))}
    return Outcome(
        e2e={"serve_clips_per_s": n * sh["r"] / window_s,
             "serve_p95_ms": float(np.percentile(lat, 95)),
             "setup_s": setup_s},
        attempted=n, failed=failed, memory_peak_bytes=int(peak), ctx=ctx,
        checks=[("logit_gap", gap, float(cell.limits["logit_gap"]))],
        notes=[f"set-up at s: " + ", ".join(f"{k} {v:.3f}" for k, v in marks),
               f"reference check {t_ref:.3f} s",
               f"window {window_s:.6f} s, {n} requests of {sh['r']} clips; "
               f"latency median {float(np.median(lat)):.6f} ms, p95 "
               f"{float(np.percentile(lat, 95)):.6f} ms, max "
               f"{max(lat):.6f} ms"])


def _flops(cell: Cell) -> float:
    from leafbench.reference.flops import count
    sh = shapes(cell)
    return count(cell.cfg, sh["r"], sh["t"], train=False)
