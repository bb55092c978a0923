"""Serving: pad-to-bucket inference, live or from ``torch.export`` artifacts.

The port of ``leaf_tpu/serving.py``. A request of B clips is cut into
chunks of at most the largest bucket, each chunk is zero-padded up to the
smallest bucket that holds it, and the padded rows are sliced off the
logits. The model behind the buckets is either

- the live ``Classifier`` (``ServingModel(cfg, state_dict=...)``), or
- weight-embedded ``torch.export`` programs, one per bucket
  (``save_exported`` writes ``model_b{N}.pt2`` and ``serving.json``;
  ``ServingModel.load`` reads them with no model code). On a CUDA device
  the programs call the fused frontend kernel through its
  ``torch.ops.leaf_tpu_torch`` op, so this module imports
  ``leaf_tpu_torch.ops`` before it loads one. An artifact runs only on the
  device type it was exported for.

Streaming: ``save_exported_streaming`` exports the ``StreamingLeafCell``
of the roles ``first``, ``steady`` and ``flush_0`` for a fixed
(chunk_size, n_streams); ``StreamingServingModel.load`` drives them with
``LeafStreamer``'s bookkeeping (full chunks only; ``flush()`` takes no
remainder).

    save_exported(dir, cfg, state_dict=model.state_dict(), device="cuda")
    model = ServingModel.load(dir)       # or ServingModel(cfg, state_dict=)
    logits = model(waveforms)        # (B, clip_samples) → (B, num_classes)
"""

from __future__ import annotations

import json
import os
from collections.abc import Mapping
from typing import Optional, Sequence

import numpy as np
import torch

import leaf_tpu_torch.ops  # noqa: F401  (registers the kernels' ops)
from leaf_tpu_torch import resolve_device, tracing
from leaf_tpu_torch.frontend.streaming import LeafStreamer
from leaf_tpu_torch.models.classifier import Classifier
from leaf_tpu_torch.models.jax_import import load_jax_variables

__all__ = ["ServingModel", "DEFAULT_BATCH_SIZES", "save_exported",
           "save_exported_streaming", "StreamingServingModel"]

# The JAX package's buckets (no b=1 bucket: a single clip is padded to 8).
DEFAULT_BATCH_SIZES = (8, 64)
_MANIFEST = "serving.json"
_STREAM_MANIFEST = "serving_stream.json"
# a live replica processes ≥ 1 full chunk before it flushes, and an
# artifact has fixed shapes: only these roles are exported
_STREAM_ROLES = ("first", "steady", "flush_0")


def _read_manifest(path: str, name: str, device) -> tuple:
    """(manifest, device) for an artifact directory; raises when the
    device's type is not the one the artifact was exported for."""
    with open(os.path.join(path, name)) as f:
        manifest = json.load(f)
    device = resolve_device(device)
    if device.type != manifest["device"]:
        raise ValueError(
            f"{path} was exported for {manifest['device']!r} and cannot run "
            f"on {device.type!r}: export it again on that device")
    return manifest, device


def _load_program(path: str, name: str):
    return torch.export.load(os.path.join(path, name)).module()


class ServingModel:
    """Pad-to-bucket dispatch over the live classifier (in eval mode) or
    over loaded artifacts (``ServingModel.load``).

    Weights come from exactly one of ``state_dict`` (the port's own) or
    ``jax_variables`` (a JAX ``{"params", "batch_stats"}`` tree). Runs on
    ``device`` — CUDA unless one is named.
    """

    def __init__(self, cfg: dict, *, state_dict: Optional[Mapping] = None,
                 jax_variables: Optional[Mapping] = None, device=None,
                 batch_sizes: Sequence[int] = DEFAULT_BATCH_SIZES,
                 clip_samples: Optional[int] = None):
        if (state_dict is None) == (jax_variables is None):
            raise ValueError("pass exactly one of state_dict= or "
                             "jax_variables=")
        self.device = resolve_device(device)
        model = Classifier(cfg, device=self.device)
        if state_dict is not None:
            model.load_state_dict(state_dict)
        else:
            load_jax_variables(model, jax_variables)
        self.model = model.eval()
        self.batch_sizes = sorted(set(int(b) for b in batch_sizes))
        self._forward = {b: self.model for b in self.batch_sizes}
        self.clip_samples = int(clip_samples
                                or cfg["audio_config"]["sample_rate"])

    @classmethod
    def load(cls, path: str, device=None) -> "ServingModel":
        """The artifacts ``save_exported`` wrote into ``path``, on
        ``device`` (CUDA unless one is named; it must be of the device
        type they were exported for)."""
        manifest, device = _read_manifest(path, _MANIFEST, device)
        self = cls.__new__(cls)
        self.manifest = manifest
        self.device = device
        self.model = None
        self._forward = {int(b): _load_program(path, name)
                         for b, name in manifest["files"].items()}
        self.batch_sizes = sorted(self._forward)
        self.clip_samples = int(manifest["clip_samples"])
        return self

    def _bucket(self, n: int) -> int:
        for b in self.batch_sizes:
            if b >= n:
                return b
        return self.batch_sizes[-1]

    def __call__(self, waveforms) -> np.ndarray:
        """(B, clip_samples) float32 → (B, num_classes) float32 logits
        (a bf16 model's logits widened: numpy has no bf16).

        The host's work is split into the spans ``leaf_tpu_torch.serve.*``
        (``tracing``): ``prepare`` (the request's conversion and check,
        then each chunk's slice and padding), ``h2d`` (the chunk's copy to
        the device; host-synchronous from pageable memory), ``forward``
        (the dispatch of the bucket's forward) and ``fetch`` (the logits
        to the host, and the request's concatenation)."""
        with tracing.span("leaf_tpu_torch.serve.prepare"):
            x = torch.as_tensor(np.asarray(waveforms, dtype=np.float32))
            if x.ndim != 2 or x.shape[1] != self.clip_samples:
                raise ValueError(f"expected (B, {self.clip_samples}) "
                                 f"waveforms, got {tuple(x.shape)}")
        outs = []
        largest = self.batch_sizes[-1]
        with torch.inference_mode():
            for start in range(0, x.shape[0], largest):
                with tracing.span("leaf_tpu_torch.serve.prepare"):
                    chunk = x[start:start + largest]
                    take = chunk.shape[0]
                    b = self._bucket(take)
                    if take < b:
                        chunk = torch.nn.functional.pad(
                            chunk, (0, 0, 0, b - take))
                with tracing.span("leaf_tpu_torch.serve.h2d"):
                    chunk = chunk.to(self.device, non_blocking=True)
                with tracing.span("leaf_tpu_torch.serve.forward"):
                    logits = self._forward[b](chunk)
                with tracing.span("leaf_tpu_torch.serve.fetch"):
                    outs.append(logits[:take].float().cpu().numpy())
        with tracing.span("leaf_tpu_torch.serve.fetch"):
            return np.concatenate(outs, axis=0)


def save_exported(out_dir: str, cfg: dict, *,
                  state_dict: Optional[Mapping] = None,
                  jax_variables: Optional[Mapping] = None,
                  batch_sizes: Sequence[int] = DEFAULT_BATCH_SIZES,
                  clip_samples: Optional[int] = None, device=None) -> dict:
    """Export the eval-mode classifier once per batch bucket, weights
    embedded: ``model_b{N}.pt2`` (``torch.export.save``) and
    ``serving.json`` (the JAX manifest's keys, plus the ``device`` type
    the programs were exported for). Weights as ``ServingModel``'s;
    ``clip_samples`` defaults to 1 s at the cfg's sample rate. Returns the
    manifest."""
    live = ServingModel(cfg, state_dict=state_dict,
                        jax_variables=jax_variables, device=device,
                        batch_sizes=batch_sizes, clip_samples=clip_samples)
    # no parameter asks for a gradient: the fused frontend exports as its
    # primal forward op
    model = live.model.requires_grad_(False)
    os.makedirs(out_dir, exist_ok=True)
    files, num_classes = {}, None
    for b in live.batch_sizes:
        program = torch.export.export(
            model, (torch.zeros((b, live.clip_samples), device=live.device),))
        out_node = next(n for n in program.graph.nodes if n.op == "output")
        num_classes = int(out_node.args[0][0].meta["val"].shape[-1])
        name = f"model_b{b}.pt2"
        torch.export.save(program, os.path.join(out_dir, name))
        files[str(b)] = name
    manifest = {
        "batch_sizes": live.batch_sizes,
        "clip_samples": live.clip_samples,
        "sample_rate": int(cfg["audio_config"]["sample_rate"]),
        "num_classes": num_classes,
        "files": files,
        "model": {"arch": cfg["model"]["arch"],
                  "model_depth": cfg["model"].get("model_depth")},
        "device": live.device.type,
    }
    with open(os.path.join(out_dir, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def save_exported_streaming(out_dir: str, leaf, chunk_size: int,
                            n_streams: int) -> dict:
    """Export the streaming cell of ``leaf`` (a port ``Leaf``, on the
    device to export for) for a fixed (chunk_size, n_streams): the roles
    ``first``, ``steady`` and ``flush_0`` as ``stream_<role>.pt2``, and
    ``serving_stream.json`` (the JAX manifest's keys, plus ``device``).
    Load with ``StreamingServingModel.load``. Returns the manifest."""
    st = LeafStreamer(leaf, chunk_size, batch_size=n_streams)
    geo = st.geometry
    widths = {"first": geo["tail"] + chunk_size,
              "steady": geo["tail"] + chunk_size,
              "flush_0": geo["tail"] + geo["flush_pad"]}
    os.makedirs(out_dir, exist_ok=True)
    files = {}
    for role in _STREAM_ROLES:
        program = torch.export.export(st._cell(role), (
            torch.zeros((n_streams, widths[role]), device=st.device),
            torch.zeros((n_streams, st.n_filters), device=st.device)))
        name = f"stream_{role}.pt2"
        torch.export.save(program, os.path.join(out_dir, name))
        files[role] = name
    manifest = {
        "chunk_size": chunk_size,
        "n_streams": n_streams,
        "hop": st.hop,
        "n_filters": st.n_filters,
        "geometry": geo,
        "files": files,
        "device": st.device.type,
    }
    with open(os.path.join(out_dir, _STREAM_MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


class StreamingServingModel(LeafStreamer):
    """A loaded streaming artifact: ``LeafStreamer``'s ``process`` /
    ``flush`` / ``reset`` over the exported cells (weights embedded).
    ``flush()`` takes no remainder: feed full chunks."""

    def __init__(self, manifest: dict, programs: dict, device: torch.device):
        self.manifest = manifest
        self.leaf = None
        self.device = device
        self._programs = programs  # role → loaded program
        self._setup(int(manifest["hop"]), int(manifest["n_filters"]),
                    dict(manifest["geometry"]), int(manifest["chunk_size"]),
                    int(manifest["n_streams"]))

    @classmethod
    def load(cls, path: str, device=None) -> "StreamingServingModel":
        manifest, device = _read_manifest(path, _STREAM_MANIFEST, device)
        return cls(manifest, {role: _load_program(path, name)
                              for role, name in manifest["files"].items()},
                   device)

    def _cell(self, role: str):
        if role not in self._programs:
            raise ValueError(
                f"streaming artifact has no '{role}' variant — feed full "
                f"chunks of {self.chunk_size} and flush() with no "
                f"remainder (available: {sorted(self._programs)})")
        return self._programs[role]
