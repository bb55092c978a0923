"""Export a trained experiment as serving artifacts — the port of the JAX
package's ``scripts/export_serving.py``.

Loads the best (or the given) checkpoint of an experiment directory and
writes weight-embedded ``torch.export`` programs, one per batch bucket,
with ``serving.json`` (``leaf_tpu_torch.serving.save_exported``); with
``--streaming_chunk`` also the streaming frontend's programs
(``save_exported_streaming``). The cfg, and with it the compute dtype
(bf16 after ``train --bf16``), is the run's ``hparams.json``. The
programs run on the device type they were exported for (``--device``,
default cuda), where ``ServingModel.load`` / ``StreamingServingModel
.load`` read them.

Example:

    python -m leaf_tpu_torch.export_serving --exp_dir ./exp_scv2_b0 \\
        --out_dir ./exp_scv2_b0/serving --batch_sizes 8,64
"""

from __future__ import annotations

import argparse
import os

import torch

from leaf_tpu_torch import resolve_device
from leaf_tpu_torch.models import Classifier
from leaf_tpu_torch.serving import save_exported, save_exported_streaming
from leaf_tpu_torch.training import TrainState
from leaf_tpu_torch.training.checkpoint import (best_checkpoint,
                                                load_checkpoint, load_hparams)

_DROPPED = ("scripts/export_serving.py's --platforms and --platform are "
            "dropped: --device picks the one device type the artifacts "
            "run on.")


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__, epilog=_DROPPED,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--exp_dir", type=str, required=True)
    p.add_argument("--out_dir", type=str, default=None,
                   help="default: <exp_dir>/serving")
    p.add_argument("--ckpt", type=str, default=None,
                   help="explicit checkpoint dir (default: best by val_acc)")
    p.add_argument("--batch_sizes", type=str, default="8,64",
                   help="buckets; no b=1 by default: a single clip is "
                        "padded into the 8 bucket")
    p.add_argument("--streaming_chunk", type=int, default=0,
                   help="also export the streaming frontend for this chunk "
                        "size (samples; a multiple of the hop, LEAF min "
                        "640); 0 = off")
    p.add_argument("--streaming_streams", type=int, default=8,
                   help="concurrent streams per replica for the streaming "
                        "artifact (its fixed batch)")
    p.add_argument("--device", type=str, default="cuda",
                   help="device the artifacts are exported for and run on "
                        "(default cuda)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = load_hparams(args.exp_dir)
    ckpt = args.ckpt or best_checkpoint(args.exp_dir)
    if not ckpt:
        raise SystemExit(f"no checkpoint found under {args.exp_dir}")
    model = Classifier(cfg, device=device, generator=torch.Generator())
    state, meta = load_checkpoint(ckpt, TrainState(model, None),
                                  with_opt=False)
    print(f"loaded {ckpt} (val metric {meta.get('val_acc', 'n/a')}; "
          f"compute dtype {model.features.compute_dtype})", flush=True)

    out = args.out_dir or os.path.join(args.exp_dir, "serving")
    manifest = save_exported(
        out, cfg, state_dict=state.model.state_dict(), device=device,
        batch_sizes=[int(b) for b in args.batch_sizes.split(",")])
    print(f"exported {manifest['files']} to {out}", flush=True)
    if args.streaming_chunk:
        smanifest = save_exported_streaming(
            out, state.model.features, chunk_size=args.streaming_chunk,
            n_streams=args.streaming_streams)
        print(f"exported streaming {smanifest['files']} to {out} "
              f"(chunk {args.streaming_chunk}, {args.streaming_streams} "
              f"streams)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
