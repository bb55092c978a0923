"""Streaming-frontend latency per chunk, the counterpart of the JAX repo's
``scripts/streaming_latency.py``.

What a live-audio replica pays per chunk at several chunk sizes, with
``--batch`` concurrent streams: the flagship Leaf (seeded) streamed
exactly by ``LeafStreamer`` (live) and by the ``save_exported_streaming``
→ ``StreamingServingModel.load`` programs (``artifact``), each after its
first-call variant:

- ``device_busy_ms``: device time per steady ``process()`` call
  (torch.profiler's kernel rows over ``--trace-execs`` calls);
- ``wall_ms_p50``: the host clock per call, ending in a synchronize;
- ``realtime_factor_busy``: (chunk seconds × streams) / device-busy
  seconds, the seconds of audio one card ingests per second.

One JSON line per chunk size and mode.

    python -m leaf_tpu_torch.scripts.streaming_latency
        [--chunks 640,1600,4800,16000] [--batch 8] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

from leaf_tpu_torch.scripts import _measure

SR = 16000


def stream(streamer, wave: np.ndarray, chunk: int, sync_times=None):
    """Stream ``wave`` (B, T) in chunks, the remainder to ``flush``;
    returns the frames (numpy). With ``sync_times`` (a list) each
    ``process()`` call's host-clock ms, synchronized, is appended."""
    n = wave.shape[1] // chunk
    outs = []
    for i in range(n):
        t0 = time.perf_counter()
        outs.append(streamer.process(wave[:, i * chunk:(i + 1) * chunk]))
        if sync_times is not None:
            if outs[-1].is_cuda:
                torch.cuda.synchronize()
            sync_times.append((time.perf_counter() - t0) * 1e3)
    rem = wave[:, n * chunk:]
    outs.append(streamer.flush(rem if rem.shape[1] else None))
    return torch.cat(outs, dim=1).float().cpu().numpy()


def measure_chunks(streamer, chunk: int, streams: int, device,
                   wall_reps: int = 30, trace_execs: int = 8,
                   seed: int = 0) -> dict:
    """The steady per-call cost of ``streamer.process`` on ``streams`` ×
    ``chunk`` samples (after one first call): host-clock ms of
    ``wall_reps`` calls, and on the card the device time of
    ``trace_execs`` calls."""
    rng = np.random.RandomState(seed)
    xs = [(rng.randn(streams, chunk) * 0.1).astype(np.float32)
          for _ in range(4)]
    streamer.process(xs[0])
    turn = iter(range(10 ** 9))
    call = lambda: streamer.process(xs[next(turn) % 4])  # noqa: E731
    walls = _measure.host_times_ms(call, wall_reps, device, warmup=2)
    p50 = float(np.median(walls))
    rec = {"chunk_samples": chunk, "streams": streams,
           "device_busy_ms": None, "wall_ms_p50": p50,
           "wall_ms_p90": float(np.percentile(walls, 90)),
           "realtime_factor_busy": None, "idle_share": None,
           "kernels_per_chunk": None}
    if torch.device(device).type == "cuda":
        prof = _measure.device_profile(call, trace_execs, host_ms=p50)
        if prof.busy_ms:
            rec.update(device_busy_ms=prof.busy_ms, idle_share=prof.idle,
                       kernels_per_chunk=prof.launches,
                       realtime_factor_busy=chunk / SR * streams
                       / (prof.busy_ms / 1e3))
    return rec


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m leaf_tpu_torch.scripts.streaming_latency",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--chunks", type=str, default="640,1600,4800,16000")
    ap.add_argument("--batch", type=int, default=8,
                    help="concurrent streams per replica")
    ap.add_argument("--wall-reps", type=int, default=30)
    ap.add_argument("--trace-execs", type=int, default=8)
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (the default) or cpu (no device metric)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = _measure.open_device(args.device, "streaming_latency")
    if device is None:
        return 1
    from leaf_tpu_torch.frontend import Leaf, LeafStreamer
    from leaf_tpu_torch.serving import (StreamingServingModel,
                                        save_exported_streaming)
    leaf = Leaf(device=device, generator=torch.Generator().manual_seed(0))
    card = _measure.card(device)
    with tempfile.TemporaryDirectory(prefix="streaming_latency_") as tmp:
        for chunk in [int(s) for s in args.chunks.split(",")]:
            def exported(chunk=chunk):
                out = os.path.join(tmp, f"stream_{chunk}")
                save_exported_streaming(out, leaf, chunk, args.batch)
                return StreamingServingModel.load(out, device=device)
            modes = {"live": lambda: LeafStreamer(leaf, chunk),
                     "artifact": exported}
            for mode, make in modes.items():
                rec = measure_chunks(make(), chunk, args.batch, device,
                                     args.wall_reps, args.trace_execs)
                _measure.emit({"metric": "streaming_frontend_latency_"
                               f"{device.type}", "mode": mode, **rec, **card})
    return 0


if __name__ == "__main__":
    sys.exit(main())
