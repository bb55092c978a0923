"""Import a FULL reference (leaf-pytorch) classifier checkpoint into an
experiment directory — the port's counterpart of
``scripts/import_torch_classifier.py``.

Loads a torch ``.pth`` trained by the reference's train_xla.py (weights
under ``model_state_dict``, reference train_xla.py:38-41; also
``state_dict``, ``model`` or a bare ``state_dict``), strips the
``module.`` prefix a DataParallel wrapper adds, and loads the
``state_dict`` strictly into ``Classifier(cfg)`` built from the
experiment cfg (``leaf_tpu_torch.models.import_torch_classifier``, the
library function): the port keeps the reference's tensor names (frontend,
backbone, BatchNorm running statistics), so no key is mapped. A missing,
extra or misshaped tensor (a checkpoint of another arch, depth or class
count) raises before anything is written.

Writes ``<out_expdir>/epoch_NNN`` (NNN the source's epoch, 000 without
one) through the port's ``save_checkpoint``, with the source's
``epoch``/``tr_loss``/``tr_acc``/``val_acc`` in meta.json where it has
them (−1 where not), and ``hparams.json`` holding the cfg, so that
``python -m leaf_tpu_torch.evaluate --exp_dir <out_expdir>`` scores it
and ``python -m leaf_tpu_torch.train --continue_from_ckpt
<out_expdir>/epoch_NNN`` fine-tunes it (with a fresh optimizer: the
checkpoint holds none).

Usage:

    python -m leaf_tpu_torch.import_torch_classifier ckpt.pth cfg_file \\
        out_expdir [--device cuda]
"""

from __future__ import annotations

import argparse

import torch

from leaf_tpu_torch import resolve_device
from leaf_tpu_torch.models import Classifier
from leaf_tpu_torch.models.torch_import import (import_torch_classifier,
                                                load_reference_checkpoint)
from leaf_tpu_torch.training import TrainState
from leaf_tpu_torch.training.checkpoint import save_checkpoint, save_hparams
from leaf_tpu_torch.training.config import parse_config

_META = ("epoch", "tr_loss", "tr_acc", "val_acc")


def import_classifier(torch_ckpt: str, cfg_file: str, out_expdir: str,
                      device="cuda") -> str:
    """Write the experiment directory; returns the checkpoint's path."""
    device = resolve_device(device)
    state_dict, raw = load_reference_checkpoint(torch_ckpt, "cpu")
    meta = {}
    if isinstance(raw, dict):
        meta = {k: raw[k] for k in _META
                if isinstance(raw.get(k), (int, float))}
    cfg = parse_config(cfg_file)
    model = import_torch_classifier(
        state_dict, Classifier(cfg, device=device,
                               generator=torch.Generator().manual_seed(0)),
        cfg["model"]["arch"])
    path = save_checkpoint(
        out_expdir, TrainState(model, None), epoch=int(meta.get("epoch", 0)),
        tr_loss=float(meta.get("tr_loss", -1.0)),
        tr_acc=float(meta.get("tr_acc", -1.0)),
        val_acc=float(meta.get("val_acc", -1.0)))
    save_hparams(out_expdir, cfg)
    return path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("torch_ckpt")
    p.add_argument("cfg_file")
    p.add_argument("out_expdir")
    p.add_argument("--device", type=str, default="cuda",
                   help="device the classifier is built on (default cuda; "
                        "raises without a card)")
    args = p.parse_args(argv)
    path = import_classifier(args.torch_ckpt, args.cfg_file,
                             args.out_expdir, args.device)
    print(f"imported the reference classifier -> {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
