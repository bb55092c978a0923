"""Data pipeline of the port: audio IO, the CSV-manifest and packed-shard
datasets, numpy waveform transforms, the threaded loader and device feed
(host side), and the on-device augments of the train step."""

from leaf_tpu_torch.data.audio import load_audio, load_audio_bytes, write_wav
from leaf_tpu_torch.data.dataset import (
    PackedDataset,
    RawWaveformDataset,
    deflate_packed_batch,
    normalize_waveform,
    parse_labels,
)
from leaf_tpu_torch.data.device_augment import (  # noqa: F401
    leaf_device_augment,
    peak_normalize,
)
from leaf_tpu_torch.data.loader import (
    DataLoader,
    ShardedSampler,
    collate_contrastive,
    collate_fixed,
    make_packed_collate,
    pinned_placer,
    prefetch_to_device,
    setup_dataloaders,
)
from leaf_tpu_torch.data.transforms import (
    get_raw_transforms_v2,
    leaf_host_crop_transforms,
    leaf_supervised_transforms,
    simple_supervised_transforms,
)

__all__ = [
    "load_audio",
    "load_audio_bytes",
    "write_wav",
    "RawWaveformDataset",
    "PackedDataset",
    "deflate_packed_batch",
    "normalize_waveform",
    "parse_labels",
    "leaf_device_augment",
    "peak_normalize",
    "DataLoader",
    "ShardedSampler",
    "collate_fixed",
    "collate_contrastive",
    "make_packed_collate",
    "pinned_placer",
    "prefetch_to_device",
    "setup_dataloaders",
    "get_raw_transforms_v2",
    "leaf_host_crop_transforms",
    "leaf_supervised_transforms",
    "simple_supervised_transforms",
]
