#!/usr/bin/env python
"""Convert a ``leaf_tpu`` (JAX) training checkpoint into a checkpoint of
the PyTorch port, ``leaf_tpu_torch``.

The inverse of ``leaf_tpu.models.torch_import``: the orbax ``state`` of
an ``epoch_NNN`` directory is restored to numpy (as
``leaf_tpu.training.checkpoint`` restores it), its ``params`` and
``batch_stats`` are copied into a port ``Classifier`` built from the
experiment's config by ``leaf_tpu_torch.models.load_jax_variables``
(which refuses a partial or misshaped tree), and the result is written in
the port's layout:

  <out_exp_dir>/<epoch dir name>/state.pt   the model's state_dict and
                                            the step (no optimizer)
  <out_exp_dir>/<epoch dir name>/meta.json  copied from the JAX checkpoint
  <out_exp_dir>/hparams.json                the config, where the JAX
                                            experiment has one

The written directory can be given to ``frontend.pretrained`` (the
port's ``apply_pretrained_frontend``), to
``leaf_tpu_torch.training.checkpoint.load_pretrained_backbone`` and to
``load_checkpoint(..., with_opt=False)``; ``<out_exp_dir>`` to
``python -m leaf_tpu_torch.evaluate``. The script needs JAX and orbax
(the port itself does not).

Usage:
  python scripts/leaf_tpu_to_torch_checkpoint.py <jax exp>/epoch_004 \\
      <out_exp_dir> [--cfg_file cfg.cfg]
The config is read from ``--cfg_file`` or else from the ``hparams.json``
beside the checkpoint directory.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def convert(jax_ckpt: str, out_exp_dir: str, cfg_file: str = None) -> str:
    """Write the port checkpoint; returns its directory."""
    import numpy as np
    import torch

    from leaf_tpu.training.checkpoint import _restore_raw
    from leaf_tpu_torch.models import Classifier, load_jax_variables
    from leaf_tpu_torch.training.config import get_config

    jax_ckpt = os.path.abspath(jax_ckpt)
    hparams = os.path.join(os.path.dirname(jax_ckpt), "hparams.json")
    if cfg_file:
        cfg = get_config(cfg_file)
    elif os.path.exists(hparams):
        with open(hparams) as f:
            cfg = json.load(f)
    else:
        raise SystemExit(f"no config: pass --cfg_file, or keep "
                         f"hparams.json beside {jax_ckpt}")
    restored, meta = _restore_raw(jax_ckpt)
    variables = {"params": restored["params"],
                 "batch_stats": restored["batch_stats"]}
    model = Classifier(cfg, device="cpu")
    load_jax_variables(model, variables)

    out = os.path.join(os.path.abspath(out_exp_dir),
                       os.path.basename(jax_ckpt.rstrip(os.sep)))
    os.makedirs(out, exist_ok=True)
    torch.save({"step": int(np.asarray(restored["step"])),
                "model": model.state_dict(), "optimizer": None,
                "scheduler": None}, os.path.join(out, "state.pt"))
    with open(os.path.join(out, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(hparams):
        shutil.copyfile(hparams, os.path.join(out_exp_dir, "hparams.json"))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("jax_ckpt", help="a leaf_tpu epoch_NNN directory")
    p.add_argument("out_exp_dir")
    p.add_argument("--cfg_file", type=str, default=None)
    args = p.parse_args(argv)
    out = convert(args.jax_ckpt, args.out_exp_dir, args.cfg_file)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
