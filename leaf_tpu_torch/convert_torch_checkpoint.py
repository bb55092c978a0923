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
import torch

from leaf_tpu_torch import resolve_device

KEY_MAP = {
    "_complex_conv._kernel": ("complex_conv", "kernel", None),
    "_pooling.weights": ("pooling", "weights", lambda a: a.reshape(-1)),
    "_pooling._bias": ("pooling", "bias", None),
    "_compression.alpha": ("compression", "alpha", None),
    "_compression.delta": ("compression", "delta", None),
    "_compression.root": ("compression", "root", None),
    "_compression.ema._weights": ("compression", "ema", "weights", None),
}


def convert_frontend_state_dict(state_dict: dict) -> dict:
    """A reference ``state_dict`` (torch tensors or arrays) → the LEAF
    frontend's tensors as a flat {npz path: float32 ndarray}; every other
    key is passed over."""
    out = {}
    for key, value in state_dict.items():
        # strip common prefixes: 'features.' (Classifier) or 'module.'
        k = key
        for prefix in ("module.", "features.", "model.features."):
            if k.startswith(prefix):
                k = k[len(prefix):]
        if k not in KEY_MAP:
            continue
        *path, transform = KEY_MAP[k]
        arr = np.asarray(value.detach().cpu().numpy()
                         if hasattr(value, "detach") else value,
                         dtype=np.float32)
        if transform is not None:
            arr = transform(arr)
        out["/".join(path)] = arr
    return out


def load_reference_checkpoint(path: str, device) -> tuple:
    """(state_dict, the raw object) of a reference ``.pth``: training
    checkpoints hold the weights under ``model_state_dict`` (reference
    train_xla.py:38-41); exports may use ``state_dict`` or ``model``, or
    be a bare ``state_dict`` or ``nn.Module``. The file is unpickled whole
    (it may hold more than tensors): open only checkpoints you trust."""
    raw = torch.load(path, map_location=device, weights_only=False)
    state_dict = raw
    if isinstance(raw, dict):
        state_dict = (raw.get("model_state_dict") or raw.get("state_dict")
                      or raw.get("model") or raw)
    if hasattr(state_dict, "state_dict"):
        state_dict = state_dict.state_dict()
    return state_dict, raw


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
