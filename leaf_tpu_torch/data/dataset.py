"""Map-style waveform datasets: CSV manifests and packed msgpack shards.

``leaf_tpu.data.dataset``'s ``RawWaveformDataset`` and ``PackedDataset``
(after reference utilities/data/raw_dataset.py:23-113 and
packed_dataset.py:37-176), in numpy and the stdlib:

- CSV manifest with ``files``/``labels`` (+ ``durations`` for cropped
  reads), read with ``csv`` where the JAX package uses pandas; JSON label
  map;
- label parsing: multilabel → k-hot float vector from delimited label
  strings, multiclass → int id;
- optional waveform normalization, per-item transform, mixer hook;
- ``in_memory`` caching of decoded waveforms and the int16 wire dtype;
- packed shards: each manifest row is one msgpack document of records
  ``{audio: file bytes, label, duration}``, decoded by the port's own
  codec (``msgpack_lite``); one ``__getitem__`` returns the whole shard,
  shuffled in training. ``gs://`` shards are read through
  ``google-cloud-storage`` (imported only when a bucket is named), with
  a lazy client per dataset copy.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Callable, List, Optional, Union

import numpy as np

from leaf_tpu_torch.data import msgpack_lite
from leaf_tpu_torch.data.audio import load_audio, load_audio_bytes

__all__ = ["RawWaveformDataset", "PackedDataset", "deflate_packed_batch",
           "parse_labels", "normalize_waveform", "read_manifest"]


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


class _AudioConfigMixin:
    def _parse_audio_config(self, audio_config: dict, cropped_read: bool,
                            delimiter: str) -> None:
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

    def _load_labels_map(self, labels_map: str) -> None:
        assert os.path.isfile(labels_map), labels_map
        assert os.path.splitext(labels_map)[-1] == ".json"
        with open(labels_map) as fd:
            self.labels_map = json.load(fd)


class RawWaveformDataset(_AudioConfigMixin):
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
        self._load_labels_map(labels_map)
        self._parse_audio_config(audio_config, cropped_read, delimiter)
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


class PackedDataset(_AudioConfigMixin):
    """One item = one shard file → (list of waveforms, list of labels).

    Validation items keep the shard's record order; training items come
    in the order of ``np.random.permutation`` (the global numpy RNG). A
    record whose audio does not decode is left out of its shard. Use
    ``deflate_packed_batch`` (or ``make_packed_collate``) to flatten
    shards into one batch. Packed shards ship float32 waveforms.
    """

    def __init__(self, manifest_path: str, labels_map: str,
                 audio_config: dict, augment: bool = False,
                 mode: str = "multilabel", delimiter: str = ",",
                 mixer: Optional[Callable] = None,
                 transform: Optional[Callable] = None,
                 is_val: bool = False, cropped_read: bool = False,
                 gcs_bucket_path: Optional[str] = None):
        self.mode = mode
        self.transform = transform
        self.mixer = mixer
        self.cropped_read = cropped_read
        self.is_val = is_val
        self.gcs_bucket_path = gcs_bucket_path
        self._client = None  # the GCS client, made on the first read
        self._load_labels_map(labels_map)
        self._parse_audio_config(audio_config, cropped_read, delimiter)
        self.files: List[str] = read_manifest(manifest_path)["files"]
        self.length = len(self.files)

    def __len__(self) -> int:
        return self.length

    def _init_gcs(self):
        from google.cloud import storage  # only when a bucket is named
        self._client = storage.Client()
        self._bucket = self._client.get_bucket(self.gcs_bucket_path)

    def _read_block(self, filepath: str) -> list:
        if self.gcs_bucket_path:
            if self._client is None:
                self._init_gcs()
            with self._bucket.blob(filepath).open("rb") as fp:
                return msgpack_lite.unpackb(fp.read())
        with open(filepath, "rb") as f:
            return msgpack_lite.unpackb(f.read())

    def _item_from_record(self, record: dict):
        cropped = self.cropped_read and not self.is_val
        audio = load_audio_bytes(
            record["audio"], self.sr, self.min_duration,
            read_cropped=cropped, frames_to_read=self.num_frames,
            audio_size=record.get("duration") if cropped else None)
        if audio is None:
            return None, None
        if self.normalize:
            audio = normalize_waveform(audio)
        label = parse_labels(record["label"], self.labels_map, self.mode,
                             self.labels_delim)
        if self.transform is not None:
            audio = self.transform(audio)
        return audio, label

    def __getitem__(self, item: int):
        block = self._read_block(self.files[item])
        idxs = (np.arange(len(block)) if self.is_val
                else np.random.permutation(len(block)))
        waves, labels = [], []
        for idx in idxs:
            audio, label = self._item_from_record(block[idx])
            if audio is None:
                continue
            if self.mixer is not None:
                audio, final_label = self.mixer(self, audio, label)
                if self.mode != "multiclass":
                    label = final_label
            waves.append(audio)
            labels.append(label)
        return waves, labels


def deflate_packed_batch(batches):
    """Flatten a list of shard outputs into (waves, labels) lists
    (reference: packed_dataset.py:163-176)."""
    waves, labels = [], []
    for shard_waves, shard_labels in batches:
        waves.extend(shard_waves)
        labels.extend(shard_labels)
    return waves, labels
