"""Map-style waveform dataset over a CSV manifest.

``leaf_tpu.data.dataset.RawWaveformDataset`` (after reference
utilities/data/raw_dataset.py:23-113), in numpy and the stdlib:

- CSV manifest with ``files``/``labels`` (+ ``durations`` for cropped
  reads), read with ``csv`` where the JAX package uses pandas; JSON label
  map;
- label parsing: multilabel → k-hot float vector from delimited label
  strings, multiclass → int id;
- optional waveform normalization, per-item transform, mixer hook;
- ``in_memory`` caching of decoded waveforms and the int16 wire dtype.

``PackedDataset`` (msgpack shards) is a later slice of the port.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Callable, List, Optional, Union

import numpy as np

from leaf_tpu_torch.data.audio import load_audio

__all__ = ["RawWaveformDataset", "parse_labels", "normalize_waveform",
           "read_manifest"]


def normalize_waveform(x: np.ndarray) -> np.ndarray:
    """Zero-mean unit-variance (RawAudioParser.normalize_waveform,
    reference: raw_waveform_parser.py:14-18)."""
    mean = x.mean()
    std = x.std()
    return ((x - mean) / (std + 1e-8)).astype(np.float32)


def parse_labels(lbls: Union[str, int], labels_map: dict, mode: str,
                 delimiter: str = ",") -> Union[int, np.ndarray]:
    if mode == "multilabel":
        out = np.zeros(len(labels_map), dtype=np.float32)
        for lbl in str(lbls).split(delimiter):
            out[labels_map[lbl]] = 1.0
        return out
    if mode == "multiclass":
        return labels_map[lbls]
    raise ValueError(f"unknown label mode {mode}")


def _number(text: str) -> Union[int, float]:
    """A manifest's duration cell: int where it is integral, as pandas
    types a column of integers."""
    try:
        return int(text)
    except ValueError:
        return float(text)


def read_manifest(path: str) -> dict:
    """A CSV manifest as {column: list of cell strings} (header row
    first, comma-separated, standard quoting)."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        cols = {name: [] for name in header}
        for row in reader:
            if not row:
                continue
            if len(row) != len(header):
                raise ValueError(f"{path}: row {row!r} has {len(row)} cells, "
                                 f"the header {len(header)}")
            for name, cell in zip(header, row):
                cols[name].append(cell)
    return cols


class RawWaveformDataset:
    """One item = one audio file → (waveform (T,), label)."""

    def __init__(self, manifest_path: str, labels_map: str,
                 audio_config: dict, augment: bool = False,
                 mode: str = "multilabel", delimiter: str = ",",
                 mixer: Optional[Callable] = None,
                 transform: Optional[Callable] = None,
                 is_val: bool = False, cropped_read: bool = False,
                 in_memory: bool = False, wire_dtype: str = "float32"):
        assert audio_config is not None
        self.mode = mode
        self.transform = transform
        self.mixer = mixer
        self.cropped_read = cropped_read
        self.is_val = is_val
        assert os.path.isfile(labels_map), labels_map
        assert os.path.splitext(labels_map)[-1] == ".json"
        with open(labels_map) as fd:
            self.labels_map = json.load(fd)
        self.sr = int(audio_config.get("sample_rate", 22050))
        self.normalize = bool(audio_config.get("normalize", False))
        self.min_duration = float(audio_config.get("min_duration", 2.5))
        self.background_noise_path = audio_config.get("bg_files", None)
        if cropped_read:
            self.num_frames = int(
                float(audio_config["random_clip_size"]) * self.sr)
        else:
            self.num_frames = -1
        self.labels_delim = audio_config.get("delimiter", delimiter)
        # wire_dtype='int16' keeps waveforms as raw PCM on the host (4×
        # smaller cache + host→device copies; the train and eval steps
        # decode with waveform_from_wire, bit-identical for 16-bit
        # sources). Only valid when host-side processing is
        # scale-equivariant: crop/pad transforms are, per-clip N(0,1)
        # normalization is not.
        assert wire_dtype in ("float32", "int16"), wire_dtype
        if wire_dtype == "int16" and self.normalize:
            raise ValueError(
                "wire_dtype='int16' is incompatible with "
                "audio_config.normalize=True (per-clip normalization needs "
                "float waveforms on the host)")
        self.wire_dtype = wire_dtype
        cols = read_manifest(manifest_path)
        self.files: List[str] = cols["files"]
        self.labels = cols["labels"]
        self.durations = ([_number(d) for d in cols["durations"]]
                          if cropped_read else None)
        self.length = len(self.files)
        # cache decoded waveforms after the first read; incompatible with
        # cropped reads (those decode a random slice per access)
        self.in_memory = bool(in_memory) and not cropped_read
        self._cache: dict = {}

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, index: int):
        if self.in_memory and index in self._cache:
            audio = self._cache[index]
        else:
            dur = (self.durations[index]
                   if self.cropped_read and not self.is_val else None)
            audio = load_audio(self.files[index], self.sr, self.min_duration,
                               read_cropped=self.cropped_read
                               and not self.is_val,
                               frames_to_read=self.num_frames, audio_size=dur,
                               dtype=self.wire_dtype)
            if self.normalize:
                audio = normalize_waveform(audio)
            # cache after normalization (deterministic), so cache hits see
            # the first epoch's waveform; transforms/mixer stay per access
            if self.in_memory:
                self._cache[index] = audio
        label = parse_labels(self.labels[index], self.labels_map, self.mode,
                             self.labels_delim)
        if self.transform is not None:
            audio = self.transform(audio)
        if self.mixer is not None:
            audio, final_label = self.mixer(self, audio, label)
            if self.mode != "multiclass":
                label = final_label
        return audio, label
