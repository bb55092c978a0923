"""Checkpoints of the train state, with JSON metadata.

``leaf_tpu.training.checkpoint``'s layout and rules, with ``torch.save``
where the JAX package uses orbax:

- one directory per save, ``<exp_dir>/epoch_NNN[_preempt]/``, holding
  ``state.pt`` (the model's ``state_dict`` — parameters and BatchNorm
  buffers —, the optimizer's and the per-batch scheduler's state dicts,
  and the step counter) and ``meta.json`` with the JAX keys ``epoch``,
  ``tr_loss``, ``tr_acc``, ``val_acc`` and, where there is one, the
  plateau controller's state under ``scheduler``;
- ``hparams.json`` in ``exp_dir`` holds the config;
- ``latest_checkpoint`` ranks a completed ``epoch_N`` above
  ``epoch_N_preempt``; ``best_checkpoint`` never returns a preempt save.

Checkpoints load on the CPU and then move to the model's device, so one
written on the card reads anywhere. The pretrained-weight loaders of the
JAX module are a later slice (ROADMAP Queue 1 item 12).
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional, Tuple

import torch

from leaf_tpu_torch.training.state import TrainState, rewind_steps

__all__ = ["save_checkpoint", "load_checkpoint", "latest_checkpoint",
           "best_checkpoint", "save_hparams", "load_hparams"]

_CKPT_RE = re.compile(r"^epoch_(\d+)(_preempt)?$")
_STATE_FILE = "state.pt"


def _ckpt_dir(exp_dir: str, epoch: int, suffix: str = "") -> str:
    return os.path.join(os.path.abspath(exp_dir),
                        f"epoch_{epoch:03d}{suffix}")


def save_checkpoint(exp_dir: str, state: TrainState, epoch: int,
                    tr_loss: float, tr_acc: float, val_acc: float,
                    scheduler_state: Optional[dict] = None,
                    dir_suffix: str = "", meta_epoch: Optional[int] = None
                    ) -> str:
    """Write state + metrics for one epoch; returns the directory.

    ``dir_suffix='_preempt'`` + ``meta_epoch=epoch-1`` is the mid-epoch
    preemption save: the directory carries the interrupted epoch's number
    (so ``latest_checkpoint`` orders it after the last completed epoch),
    while the metadata epoch makes resume redo the interrupted epoch; its
    val_acc of -1 keeps it out of ``best_checkpoint``. ``meta.json`` is
    written last, and ``state.pt`` through a temporary file, so a save
    cut short is never picked up.
    """
    path = _ckpt_dir(exp_dir, epoch, dir_suffix)
    os.makedirs(path, exist_ok=True)
    blob = {
        "step": int(state.step),
        "model": state.model.state_dict(),
        "optimizer": (state.optimizer.state_dict()
                      if state.optimizer is not None else None),
        "scheduler": (state.scheduler.state_dict()
                      if state.scheduler is not None else None),
    }
    tmp = os.path.join(path, _STATE_FILE + ".tmp")
    torch.save(blob, tmp)
    os.replace(tmp, os.path.join(path, _STATE_FILE))
    meta = {"epoch": epoch if meta_epoch is None else meta_epoch,
            "tr_loss": float(tr_loss),
            "tr_acc": float(tr_acc), "val_acc": float(val_acc)}
    if scheduler_state is not None:
        meta["scheduler"] = scheduler_state
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    return path


def _read_meta(path: str) -> Dict:
    meta_path = os.path.join(path, "meta.json")
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def load_checkpoint(path: str, state: TrainState, with_opt: bool = True
                    ) -> Tuple[TrainState, Dict]:
    """Restore ``state`` in place from a checkpoint; returns (state, meta).

    ``with_opt=False`` restores only the step and the model (parameters
    and BatchNorm buffers) — for evaluation, whose state carries no
    training optimizer.
    """
    blob = torch.load(os.path.join(path, _STATE_FILE), map_location="cpu",
                      weights_only=True)
    state.model.load_state_dict(blob["model"])
    state.step = int(blob["step"])
    if with_opt:
        state.optimizer.load_state_dict(blob["optimizer"])
        if state.scheduler is not None and blob["scheduler"] is not None:
            state.scheduler.load_state_dict(blob["scheduler"])
            # the saved lr came from the saving run's schedule; a resumed
            # run may stretch it (more epochs): read the lr at the
            # restored clock from this run's schedule, as optax does
            rewind_steps(state, 0)
    return state, _read_meta(path)


def latest_checkpoint(exp_dir: str) -> Optional[str]:
    """Newest epoch directory — enables ``--continue_from_ckpt latest``
    auto-resume after preemption."""
    if not os.path.isdir(exp_dir):
        return None
    epochs = []
    for name in os.listdir(exp_dir):
        m = _CKPT_RE.match(name)
        if m and os.path.exists(os.path.join(exp_dir, name, "meta.json")):
            # A completed epoch_N outranks epoch_N_preempt (same number):
            # the preempt save was mid-epoch-N; once N completed, its
            # snapshot is strictly newer.
            epochs.append((int(m.group(1)), 0 if m.group(2) else 1, name))
    if not epochs:
        return None
    return os.path.join(exp_dir, max(epochs)[2])


def best_checkpoint(exp_dir: str, key: str = "val_acc") -> Optional[str]:
    """The checkpoint with the best metric in its meta.json.

    ``epoch_N_preempt`` snapshots are mid-epoch saves with no validation
    metric (val_acc=-1) and are never eligible: a run preempted before its
    first completed epoch must not serve a mid-epoch model."""
    best_path, best_val = None, float("-inf")
    if not os.path.isdir(exp_dir):
        return None
    for name in sorted(os.listdir(exp_dir)):
        m = _CKPT_RE.match(name)
        if not m or m.group(2):  # not a checkpoint dir, or a _preempt save
            continue
        meta_path = os.path.join(exp_dir, name, "meta.json")
        if not os.path.exists(meta_path):
            continue
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get(key, float("-inf")) > best_val:
            best_val = meta[key]
            best_path = os.path.join(exp_dir, name)
    return best_path


def save_hparams(exp_dir: str, cfg: dict) -> None:
    """hparams.json ≙ the reference's hparams.pickle."""
    os.makedirs(exp_dir, exist_ok=True)
    with open(os.path.join(exp_dir, "hparams.json"), "w") as f:
        json.dump(cfg, f, indent=2)


def load_hparams(exp_dir: str) -> dict:
    with open(os.path.join(exp_dir, "hparams.json")) as f:
        return json.load(f)
