"""Serving latency per batch bucket, the counterpart of the JAX repo's
``scripts/serving_latency.py``.

What a serving replica pays per request at each bucket, on the flagship
Leaf + EfficientNet-b0 (seeded weights, BN statistics from one seeded
batch) through ``ServingModel`` — the live module, and with
``--artifact`` also its ``save_exported`` → ``ServingModel.load``
program, the two in turns (live, artifact, artifact, live):

- ``device_busy_ms``: the device time per request (torch.profiler's
  kernel rows over ``--trace-execs`` requests), the cost a capacity plan
  should use, and ``clips_per_sec_busy`` from it;
- ``wall_ms_p50`` / ``wall_ms_min`` / ``wall_ms_p90``: the host clock
  around ``ServingModel.__call__`` (it returns host numpy, so it ends in a
  synchronize), ``--wall-reps`` requests per turn;
- ``idle_share`` of the median, ``kernels_per_request``, the fused
  frontend kernel's device ms, and ``top_host_ops``: the host ops by
  self CPU time per request, the first split of where an artifact's
  extra host time goes;
- ``replays`` (by bucket) and ``graph_launch_counts``: the server's CUDA
  graph replays so far and the wrapper launches they made (empty on the
  CPU, where nothing is captured).

One JSON line per bucket (and mode).

    python -m leaf_tpu_torch.scripts.serving_latency [--buckets 1,8,64,256]
        [--f32] [--artifact] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

from leaf_tpu_torch.scripts import _measure
from leaf_tpu_torch.scripts.step_profile import SR, flagship_cfg


def measure_request(server, x: np.ndarray, device, wall_reps: int = 30,
                    trace_execs: int = 8, walls=None, host_top: int = 8
                    ) -> dict:
    """One bucket's record for ``server`` on the request ``x``: the host
    clock of ``wall_reps`` requests after 3 (or the given ``walls``, ms),
    and on the card a torch.profiler window of ``trace_execs`` requests
    (device rows, idle share against the median) and the top host ops."""
    call = lambda: server(x)  # noqa: E731  (returns numpy: synchronized)
    if walls is None:
        walls = _measure.host_times_ms(call, wall_reps, device)
    p50 = float(np.median(walls))
    rec = {"batch": int(x.shape[0]), "device_busy_ms": None,
           "wall_ms_p50": p50, "wall_ms_min": float(min(walls)),
           "wall_ms_p90": float(np.percentile(walls, 90)),
           "clips_per_sec_busy": None, "idle_share": None,
           "kernels_per_request": None, "fused_frontend_ms": None,
           "top_kernels": [], "top_host_ops": [], **_graph_counts(server)}
    if torch.device(device).type != "cuda":
        return rec
    prof = _measure.device_profile(call, trace_execs, host_ms=p50)
    if prof.busy_ms:
        rec.update(device_busy_ms=prof.busy_ms,
                   clips_per_sec_busy=x.shape[0] / prof.busy_ms * 1e3,
                   idle_share=prof.idle, kernels_per_request=prof.launches,
                   fused_frontend_ms=prof.ms("fused_fwd"),
                   top_kernels=[{"name": n, "count": c, "ms": m}
                                for n, c, m in prof.rows[:5]])
    rec["top_host_ops"] = [
        {"name": n, "count": c, "self_cpu_ms": m}
        for n, c, m in _measure.host_profile(call, trace_execs, host_top)]
    rec.update(_graph_counts(server))
    return rec


def _graph_counts(server) -> dict:
    return {"replays": {str(b): n for b, n in server.replays.items()},
            "graph_launch_counts": server.graph_launch_counts()}


def in_turns(servers: dict, x: np.ndarray, device, wall_reps: int = 30,
             trace_execs: int = 8) -> dict:
    """``measure_request`` of each server of ``servers`` (name → server) on
    ``x``, their host-clock windows in turns (a b … b a: each name's two
    windows pooled; one window for a lone server), then each one's
    profile."""
    names = list(servers)
    walls = {n: [] for n in names}
    for n in names + names[::-1] if len(names) > 1 else names:
        walls[n] += _measure.host_times_ms(lambda: servers[n](x), wall_reps,
                                           device)
    return {n: measure_request(servers[n], x, device, trace_execs=trace_execs,
                               walls=walls[n]) for n in names}


def describe(tag: str, rec: dict) -> str:
    """A log line of one record."""
    line = (f"{tag} bucket {rec['batch']}: wall p50 {rec['wall_ms_p50']:.3f}"
            f" ms, min {rec['wall_ms_min']:.3f}, p90 {rec['wall_ms_p90']:.3f}"
            f" (host clock)")
    if rec["device_busy_ms"] is None:
        return line + "; device time not measured"
    line += (f"; device busy {rec['device_busy_ms']:.3f} ms per request "
             f"({rec['kernels_per_request']:.0f} kernels; graph replays "
             f"{rec['replays']}, their launches "
             f"{rec['graph_launch_counts']}), idle "
             f"{rec['idle_share']:.1%}; fused frontend kernel "
             f"{rec['fused_frontend_ms']:.3f} ms")
    ops = ", ".join(f"{o['name'][:40]} {o['self_cpu_ms']:.3f}"
                    for o in rec["top_host_ops"][:4])
    return line + f"; top host ops (self ms): {ops}"


def seeded_state(cfg: dict, device, seed: int = 0) -> dict:
    """Seeded weights with BN statistics from one seeded batch (O(1)
    logits)."""
    from leaf_tpu_torch.models import Classifier
    from leaf_tpu_torch.models.common import set_batch_norm_stats_
    clf = Classifier(cfg, device=device,
                     generator=torch.Generator().manual_seed(seed)).eval()
    rng = np.random.RandomState(seed)
    set_batch_norm_stats_(clf, torch.from_numpy(
        (rng.randn(8, SR) * 0.1).astype(np.float32)).to(device))
    return clf.state_dict()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m leaf_tpu_torch.scripts.serving_latency",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--buckets", type=str, default="1,8,64,256")
    ap.add_argument("--wall-reps", type=int, default=30)
    ap.add_argument("--trace-execs", type=int, default=8)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--arch", type=str, default="efficientnet:b0")
    ap.add_argument("--artifact", action="store_true",
                    help="also serve save_exported's programs, in turns "
                         "with the live module")
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (the default) or cpu (no device metric)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = _measure.open_device(args.device, "serving_latency")
    if device is None:
        return 1
    from leaf_tpu_torch.serving import ServingModel, save_exported
    buckets = [int(s) for s in args.buckets.split(",")]
    cfg = flagship_cfg(not args.f32, args.arch)
    state = seeded_state(cfg, device)
    servers = {"live": ServingModel(cfg, state_dict=state, device=device,
                                    batch_sizes=buckets)}
    card = _measure.card(device)
    with tempfile.TemporaryDirectory(prefix="serving_latency_") as tmp:
        if args.artifact:
            out = os.path.join(tmp, "serving")
            save_exported(out, cfg, state_dict=state, device=device,
                          batch_sizes=buckets)
            servers["artifact"] = ServingModel.load(out, device=device)
        rng = np.random.RandomState(2)
        for b in buckets:
            x = (rng.randn(b, SR) * 0.1).astype(np.float32)
            recs = in_turns(servers, x, device, args.wall_reps,
                            args.trace_execs)
            for mode, rec in recs.items():
                print(describe(f"{mode}", rec), file=sys.stderr)
                _measure.emit({"metric": f"serving_latency_{device.type}",
                               "mode": mode, "arch": args.arch,
                               "dtype": "f32" if args.f32 else "bf16",
                               **rec, **card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
