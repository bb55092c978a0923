"""The one generator of the benchmark's inputs: seeded clips, labels and
weights. Every number comes from ``--seed``; the same seed gives the same
inputs, and every seed gives the same sizes.

Clips are tones: per clip a fundamental drawn over [100, 4000] Hz with
its second harmonic, a random phase, an amplitude over [0.1, 0.5] and
Gaussian noise of 0.01, so that no two clips are equal; they are drawn on
the run's device in a few large calls. Labels are one class per clip
(multiclass) or ``labels_per_clip`` = [lo, hi] distinct classes
(multilabel).
"""

from __future__ import annotations

import csv
import json
import os
import struct
from typing import List, Tuple

import numpy as np
import torch

from leafbench.reference.common import fill_weights


class Seeds:
    """Independent streams derived from one ``--seed`` (any whole number)."""

    def __init__(self, seed: int):
        self.seq = np.random.SeedSequence(int(seed) % 2 ** 128)

    def numpy(self, name: str) -> np.random.Generator:
        return np.random.default_rng(self._child(name))

    def torch_seed(self, name: str) -> int:
        return int(self._child(name).generate_state(1, np.uint64)[0]
                   % 2 ** 63)

    def _child(self, name: str) -> np.random.SeedSequence:
        key = [int(b) for b in name.encode()]
        return np.random.SeedSequence(self.seq.entropy, spawn_key=key)


def tone_clips(seed: int, n: int, samples: int, sr: int, device,
               block: int = 512) -> np.ndarray:
    """(n, samples) float32 clips in (−1, 1), drawn on ``device`` from
    ``seed`` (a CUDA generator's numbers differ from the CPU's)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = np.empty((n, samples), dtype=np.float32)
    t = torch.arange(samples, device=device, dtype=torch.float32) / sr
    for i in range(0, n, block):
        m = min(block, n - i)
        u = torch.rand((m, 3), generator=gen, device=device)
        f0 = 100.0 + 3900.0 * u[:, :1]
        amp = 0.1 + 0.4 * u[:, 1:2]
        phase = 2 * torch.pi * f0 * t[None, :] + 2 * torch.pi * u[:, 2:]
        x = amp * (0.8 * torch.sin(phase) + 0.2 * torch.sin(2 * phase))
        x += 0.01 * torch.randn((m, samples), generator=gen, device=device)
        out[i:i + m] = x.clamp(-0.999, 0.999).cpu().numpy()
    return out


def to_pcm16(x: np.ndarray) -> np.ndarray:
    """float clips → int16 PCM (× 32768, rounded, clipped)."""
    return np.clip(np.rint(x * 32768.0), -32768, 32767).astype(np.int16)


def labels(rng: np.random.Generator, n: int, classes: int, multilabel: bool,
           per_clip: Tuple[int, int] = (1, 1)) -> List[List[int]]:
    """The class ids of each clip."""
    if not multilabel:
        return [[int(c)] for c in rng.integers(0, classes, n)]
    counts = rng.integers(per_clip[0], per_clip[1] + 1, n)
    return [sorted(int(c) for c in rng.choice(classes, k, replace=False))
            for k in counts]


def label_targets(ids: List[List[int]], classes: int,
                  multilabel: bool) -> torch.Tensor:
    """Class ids → int64 (N,) or multi-hot float32 (N, classes)."""
    if not multilabel:
        return torch.tensor([i[0] for i in ids], dtype=torch.int64)
    y = torch.zeros(len(ids), classes)
    for row, cls in enumerate(ids):
        y[row, cls] = 1.0
    return y


def write_dataset(root: str, pcm: np.ndarray, ids: List[List[int]],
                  classes: int, sr: int) -> Tuple[str, str]:
    """16-bit mono WAVs, a manifest (files, labels) and a label map under
    ``root``; returns (manifest, label map)."""
    os.makedirs(root, exist_ok=True)
    nbytes = 2 * pcm.shape[1]
    # RIFF/WAVE, PCM (format 1), mono, 16 bits
    header = struct.pack("<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + nbytes, b"WAVE",
                         b"fmt ", 16, 1, 1, sr, 2 * sr, 2, 16, b"data",
                         nbytes)
    rows = []
    for i, clip in enumerate(pcm):
        path = os.path.join(root, f"clip{i:05d}.wav")
        with open(path, "wb") as f:
            f.write(header + clip.astype("<i2").tobytes())
        rows.append((path, ",".join(f"c{c}" for c in ids[i])))
    manifest = os.path.join(root, "train.csv")
    with open(manifest, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(("files", "labels"))
        w.writerows(rows)
    label_map = os.path.join(root, "labels.json")
    with open(label_map, "w") as f:
        json.dump({f"c{c}": c for c in range(classes)}, f)
    return manifest, label_map


def make_weights(model: torch.nn.Module, seed: int, std_of) -> dict:
    """The cell's weights: the frontend's LEAF initialisation as the
    reference sets it, the backbone drawn from ``seed`` on the model's
    device (``reference.common.fill_weights``); a copy of the state_dict."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    fill_weights(model.model, gen, std_of)
    return {k: v.detach().clone() for k, v in model.state_dict().items()}
