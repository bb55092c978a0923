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
written on the card reads anywhere.

Pretrained weights, as the JAX module loads them, into a port model in
place: ``apply_pretrained_frontend`` is the config's ``frontend.pretrained``
(a converted leaf-pytorch frontend, ``frontend_params.npz`` from
``scripts/convert_torch_checkpoint.py``, or a checkpoint directory of a
port run, e.g. one ``scripts/leaf_tpu_to_torch_checkpoint.py`` wrote
from a ``leaf_tpu`` run); ``load_pretrained_backbone`` copies a
checkpoint's backbone parameters and keeps the head fresh.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from leaf_tpu_torch.training.state import (TrainState, rewind_steps,
                                           set_group_lr)

__all__ = ["save_checkpoint", "load_checkpoint", "latest_checkpoint",
           "best_checkpoint", "save_hparams", "load_hparams",
           "load_converted_frontend", "load_pretrained_frontend",
           "apply_pretrained_frontend", "load_pretrained_backbone"]

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
        live = [(g["lr"], g.get("capturable")) for g in
                state.optimizer.param_groups]
        state.optimizer.load_state_dict(blob["optimizer"])
        _keep_capture_setup(state.optimizer, live)
        if state.scheduler is not None and blob["scheduler"] is not None:
            state.scheduler.load_state_dict(blob["scheduler"])
            # the saved lr came from the saving run's schedule; a resumed
            # run may stretch it (more epochs): read the lr at the
            # restored clock from this run's schedule, as optax does
            rewind_steps(state, 0)
    return state, _read_meta(path)


def _keep_capture_setup(optimizer: torch.optim.Optimizer, live) -> None:
    """After ``load_state_dict``: each group keeps this run's lr object (a
    device tensor under ``capturable``, else a float) with the loaded
    value, and this run's ``capturable`` flag; Adam's step counts move to
    where that flag keeps them (the device, or the CPU). So a checkpoint
    of a ``--steps_per_call 1`` run resumes under K > 1 and back."""
    for group, (lr, capturable) in zip(optimizer.param_groups, live):
        value = float(group["lr"])
        group["lr"] = lr
        set_group_lr(group, value)
        if capturable is None:
            continue
        group["capturable"] = capturable
        for p in group["params"]:
            step = optimizer.state.get(p, {}).get("step")
            if torch.is_tensor(step):
                optimizer.state[p]["step"] = step.to(
                    p.device if capturable else "cpu", torch.float32)


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


def _read_model_state(path: str) -> Dict[str, torch.Tensor]:
    return torch.load(os.path.join(path, _STATE_FILE), map_location="cpu",
                      weights_only=True)["model"]


def _copy_into(module: nn.Module, values: Dict[str, object],
               what: str) -> None:
    """Copy ``values`` ({state_dict key: array}) into ``module``'s tensors
    in place; an unknown key or a shape that differs raises (nothing is
    broadcast), and nothing is copied unless every key fits."""
    state = module.state_dict()
    values = {k: torch.as_tensor(v) for k, v in values.items()}
    for key, value in values.items():
        if key not in state:
            raise KeyError(f"{what}: '{key}' is not a tensor of "
                           f"{type(module).__name__}")
        if value.shape != state[key].shape:
            raise ValueError(f"{what}: '{key}' has shape "
                             f"{tuple(value.shape)}, the model's "
                             f"{tuple(state[key].shape)}")
    with torch.no_grad():
        for key, value in values.items():
            state[key].copy_(value)


def load_converted_frontend(npz_dir: str, model: nn.Module) -> nn.Module:
    """Load a converted leaf-pytorch frontend (``frontend_params.npz`` in
    ``npz_dir``, scripts/convert_torch_checkpoint.py) into a port
    ``Classifier``'s ``features`` (or into a ``Leaf``), in place.

    The npz holds the JAX paths (``complex_conv/kernel``,
    ``pooling/weights`` (C,), ``compression/ema/weights``, …); each maps
    to its port tensor with ``load_jax_variables``' transforms (the
    pooling weights to leaf-pytorch's (1, 1, C, 1)). Tensors the npz does
    not name keep their values, as in the JAX loader."""
    from leaf_tpu_torch.models.jax_import import _FRONTEND
    by_path = {"/".join(path): (key, transform)
               for key, (_, path, transform) in _FRONTEND.items()}
    with np.load(os.path.join(npz_dir, "frontend_params.npz")) as flat:
        values = {}
        for name in flat.files:
            if name not in by_path:
                raise KeyError(f"frontend_params.npz: '{name}' is not a "
                               f"LEAF frontend parameter")
            key, transform = by_path[name]
            arr = flat[name]
            values[key] = arr if transform is None else transform(arr)
    _copy_into(getattr(model, "features", model), values,
               "frontend_params.npz")
    return model


def load_pretrained_frontend(path: str, model: nn.Module) -> nn.Module:
    """Swap in the LEAF frontend of a port checkpoint directory (its
    ``state.pt``'s ``features.*``), in place; nothing else changes."""
    weights = _read_model_state(path)
    features = {k[len("features."):]: v for k, v in weights.items()
                if k.startswith("features.")}
    if not features:
        raise KeyError(f"{path}: the checkpoint holds no features.* tensors")
    model.features.load_state_dict(features)
    return model


def apply_pretrained_frontend(cfg: dict, model: nn.Module
                              ) -> Tuple[nn.Module, Optional[str]]:
    """The config's ``frontend.pretrained`` (reference
    frontend_helper.py:12-14,52-53), loaded into ``model`` in place.

    Returns (model, the configured path or None). ``''`` or ``none``
    loads nothing; a ``.npz`` file stands for its directory; a directory
    holding ``frontend_params.npz`` is a converted frontend, any other a
    checkpoint directory. A configured path that does not exist raises
    ``FileNotFoundError``: there is no silent fallback to the mel init.
    """
    pretrained = str(cfg.get("frontend", {}).get("pretrained", "") or "")
    if not pretrained or pretrained.lower() == "none":
        return model, None
    path = pretrained
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"frontend.pretrained = {path!r} does not exist")
    if os.path.isfile(path) and path.endswith(".npz"):
        path = os.path.dirname(path)
    if os.path.exists(os.path.join(path, "frontend_params.npz")):
        return load_converted_frontend(path, model), pretrained
    return load_pretrained_frontend(path, model), pretrained


_HEADS = ("_fc", "fc", "classifier", "linear")


def load_pretrained_backbone(path: str, model: nn.Module,
                             keep_head: bool = True) -> nn.Module:
    """Copy a port checkpoint's backbone parameters into a ``Classifier``,
    in place, keeping the fresh output head (``_fc`` / ``fc`` /
    ``classifier`` / ``linear``) unless ``keep_head`` is False — the
    reference's fc-swap (model_helper.py:78-94).

    As the JAX loader, it copies parameters only: the BatchNorm running
    statistics and the frontend stay as they are, and a top-level block
    the model lacks is passed over. A shape that differs raises."""
    weights = _read_model_state(path)
    params = dict(model.model.named_parameters())
    values = {}
    for key, value in weights.items():
        if not key.startswith("model."):
            continue
        key = key[len("model."):]
        if keep_head and key.split(".")[0] in _HEADS:
            continue
        if key in params:
            values[key] = value
    _copy_into(model.model, values, path)
    return model
