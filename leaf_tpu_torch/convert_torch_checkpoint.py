"""Convert a reference (leaf-pytorch) torch checkpoint's LEAF frontend into
the JAX package's parameter layout: ``frontend_params.npz`` and a JSON
manifest of the shapes — the port's counterpart of
``scripts/convert_torch_checkpoint.py``, writing the same files.

The reference's pretrained-model story extracts ``model.features`` (the
LEAF frontend) from a trained classifier checkpoint and re-uses it
(reference: README.md:94-114, frontend_helper.py:30-46). The npz is what
``frontend.pretrained`` names in a cfg: the port reads it with
``leaf_tpu_torch.training.checkpoint.load_converted_frontend``, the JAX
package with its own loader.

Key map (reference state_dict → npz path):
  features._complex_conv._kernel  (F, 2)      → complex_conv/kernel
  features._pooling.weights       (1,1,C,1)   → pooling/weights (C,)
  features._pooling._bias         (C,)        → pooling/bias
  features._compression.alpha/delta/root (C,) → compression/{alpha,delta,root}
  features._compression.ema._weights (C,)     → compression/ema/weights

Usage:

    python -m leaf_tpu_torch.convert_torch_checkpoint ckpt.pth out_dir/ \\
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from leaf_tpu_torch import resolve_device
from leaf_tpu_torch.models.torch_import import (convert_frontend_state_dict,
                                                load_reference_checkpoint)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("torch_ckpt")
    p.add_argument("out_dir")
    p.add_argument("--device", type=str, default="cuda",
                   help="device the checkpoint is loaded onto (default "
                        "cuda; raises without a card)")
    args = p.parse_args(argv)
    state_dict, _ = load_reference_checkpoint(args.torch_ckpt,
                                              resolve_device(args.device))
    flat = convert_frontend_state_dict(state_dict)
    if not flat:
        print("no LEAF frontend keys found in checkpoint", file=sys.stderr)
        return 1
    os.makedirs(args.out_dir, exist_ok=True)
    np.savez(os.path.join(args.out_dir, "frontend_params.npz"), **flat)
    with open(os.path.join(args.out_dir, "manifest.json"), "w") as f:
        json.dump({k: list(v.shape) for k, v in flat.items()}, f, indent=2)
    print(f"wrote {len(flat)} tensors to {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
