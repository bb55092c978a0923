"""The port's host data pipeline (leaf_tpu_torch.data) against the JAX
package's (leaf_tpu.data), bit for bit.

Both are numpy; the port keeps its own copy and reads manifests with the
stdlib ``csv`` where the JAX package uses pandas. Under the same seeds of
the stdlib ``random`` and ``np.random`` every item, index list, batch and
transformed waveform must be identical (``np.testing.assert_array_equal``
and equal dtypes). WAVs are written with the port's ``write_wav`` from
seeded numpy signals; nothing is downloaded.
"""

import csv
import json
import random
import threading
import time

import numpy as np
import pytest
import torch

from leaf_tpu.data import audio as jaudio
from leaf_tpu.data import dataset as jdataset
from leaf_tpu.data import loader as jloader
from leaf_tpu.data import transforms as jtf
from leaf_tpu_torch.data import audio, dataset, loader
from leaf_tpu_torch.data import transforms as tf

SR = 16000
AC = {"sample_rate": SR, "normalize": False, "min_duration": 0.5,
      "random_clip_size": 0.3}


def _write_manifest(path, rows, header=("files", "labels")):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """12 WAVs of 0.2–1.2 s, a multiclass and a multilabel manifest (with
    durations), a label map and a background-noise directory."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.RandomState(0)
    rows_mc, rows_ml = [], []
    for i in range(12):
        n = int((0.2 + 0.1 * i) * SR)
        x = 0.4 * np.sin(2 * np.pi * (200 + 50 * i) * np.arange(n) / SR)
        x += 0.05 * rng.randn(n)
        p = str(root / f"clip{i}.wav")
        audio.write_wav(p, x.astype(np.float32), SR)
        rows_mc.append((p, f"c{i % 3}", n))
        rows_ml.append((p, "|".join(f"c{c}" for c in sorted(
            rng.choice(3, rng.randint(1, 4), replace=False))), n))
    header = ("files", "labels", "durations")
    _write_manifest(root / "mc.csv", rows_mc, header)
    _write_manifest(root / "ml.csv", rows_ml, header)
    (root / "lbl.json").write_text(json.dumps({f"c{i}": i
                                               for i in range(3)}))
    noise = root / "noise"
    noise.mkdir()
    for i in range(3):
        audio.write_wav(str(noise / f"n{i}.wav"),
                        (0.1 * rng.randn(SR // 2 + 100 * i)).astype(
                            np.float32), SR)
    return root


def _seed(s):
    random.seed(s)
    np.random.seed(s)


def _assert_same(a, b):
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                        a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def test_write_wav_and_load_audio_match_jax(corpus, tmp_path):
    x = (0.3 * np.random.RandomState(1).randn(SR // 3)).astype(np.float32)
    audio.write_wav(str(tmp_path / "a.wav"), x, SR)
    jaudio.write_wav(str(tmp_path / "b.wav"), x, SR)
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()
    for kw in ({}, {"dtype": "int16"}, {"min_duration": 2.0},
               {"read_cropped": True, "frames_to_read": 1000,
                "audio_size": SR // 3}):
        _seed(3)
        got = audio.load_audio(str(tmp_path / "a.wav"), SR, **kw)
        _seed(3)
        _assert_same(got, jaudio.load_audio(str(tmp_path / "a.wav"), SR, **kw))
    buf = (tmp_path / "a.wav").read_bytes()
    for kw in ({}, {"read_cropped": True, "frames_to_read": 999,
                    "audio_size": SR // 3}):
        _seed(4)
        got = audio.load_audio_bytes(buf, SR, **kw)
        _seed(4)
        _assert_same(got, jaudio.load_audio_bytes(buf, SR, **kw))
    assert audio.load_audio_bytes(b"not a wav", SR) is None


DATASETS = {
    "multiclass": dict(manifest="mc.csv", mode="multiclass"),
    "multilabel": dict(manifest="ml.csv", mode="multilabel", delimiter="|"),
    "in_memory": dict(manifest="mc.csv", mode="multiclass", in_memory=True),
    "cropped_read": dict(manifest="mc.csv", mode="multiclass",
                         cropped_read=True),
    "int16": dict(manifest="mc.csv", mode="multiclass", wire_dtype="int16"),
    "normalize": dict(manifest="ml.csv", mode="multilabel", delimiter="|",
                      normalize=True),
    "transform": dict(manifest="mc.csv", mode="multiclass",
                      transform="leaf_supervised_transforms"),
    "val": dict(manifest="mc.csv", mode="multiclass", is_val=True,
                cropped_read=True),
}


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_dataset_items_match_jax(corpus, name):
    kw = dict(DATASETS[name])
    manifest = str(corpus / kw.pop("manifest"))
    ac = {**AC, "normalize": kw.pop("normalize", False)}

    def make(pkg, tpkg):
        t = kw.get("transform")
        extra = dict(kw)
        if t:
            extra["transform"] = getattr(tpkg, t)(True, int(0.5 * SR), SR)
        return pkg.RawWaveformDataset(manifest, str(corpus / "lbl.json"),
                                      ac, **extra)

    port, jax_ds = make(dataset, tf), make(jdataset, jtf)
    assert len(port) == len(jax_ds) == 12
    for epoch in range(2):        # the second pass reads in_memory's cache
        for i in range(len(port)):
            _seed(100 * epoch + i)
            got = port[i]
            _seed(100 * epoch + i)
            _assert_same(got, jax_ds[i])


def test_int16_wire_refuses_normalize(corpus):
    with pytest.raises(ValueError, match="incompatible"):
        dataset.RawWaveformDataset(str(corpus / "mc.csv"),
                                   str(corpus / "lbl.json"),
                                   {**AC, "normalize": True},
                                   wire_dtype="int16")


@pytest.mark.parametrize("labels,mode", [
    ("c0", "multiclass"), ("c1", "multiclass"), ("c0", "multilabel"),
    ("c2|c0", "multilabel"), ("c1|c2|c0", "multilabel")])
def test_parse_labels_matches_jax(labels, mode):
    lmap = {"c0": 0, "c1": 1, "c2": 2}
    _assert_same(dataset.parse_labels(labels, lmap, mode, "|"),
                 jdataset.parse_labels(labels, lmap, mode, "|"))


@pytest.mark.parametrize("replicas", [1, 2, 3])
@pytest.mark.parametrize("shuffle,drop_last", [(True, False), (False, False),
                                               (True, True)])
def test_sampler_matches_jax(replicas, shuffle, drop_last):
    for rank in range(replicas):
        a = loader.ShardedSampler(23, replicas, rank, shuffle=shuffle,
                                  seed=5, drop_last=drop_last)
        b = jloader.ShardedSampler(23, replicas, rank, shuffle=shuffle,
                                   seed=5, drop_last=drop_last)
        assert len(a) == len(b)
        for epoch in range(3):
            a.set_epoch(epoch)
            b.set_epoch(epoch)
            assert list(a) == list(b)


def test_collate_fixed_matches_jax():
    rng = np.random.RandomState(2)
    for dtype in (np.float32, np.int16):
        batch = [((rng.randn(n) * 1000).astype(dtype), i)
                 for i, n in enumerate((5, 9, 7))]
        for target in (None, 6, 12):
            _assert_same(loader.collate_fixed(batch, target),
                         jloader.collate_fixed(batch, target))
    ml = [(np.ones(4, np.float32), np.array([0, 1.0])) for _ in range(3)]
    _assert_same(loader.collate_fixed(ml, 4, multiclass=False),
                 jloader.collate_fixed(ml, 4, multiclass=False))


@pytest.mark.parametrize("wire", ["float32", "int16"])
def test_loader_batches_match_jax(corpus, wire):
    def batches(dpkg, lpkg, tpkg):
        tr = (tpkg.leaf_host_crop_transforms(True, int(0.4 * SR))
              if wire == "int16"
              else tpkg.leaf_supervised_transforms(True, int(0.4 * SR), SR))
        ds = dpkg.RawWaveformDataset(str(corpus / "mc.csv"),
                                     str(corpus / "lbl.json"), AC,
                                     mode="multiclass", transform=tr,
                                     wire_dtype=wire)
        val = dpkg.RawWaveformDataset(
            str(corpus / "mc.csv"), str(corpus / "lbl.json"), AC,
            mode="multiclass", is_val=True, wire_dtype=wire,
            transform=tpkg.leaf_host_crop_transforms(False, int(0.4 * SR)))
        tr_loader, val_loader = lpkg.setup_dataloaders(
            ds, val, 5, target_len=int(0.4 * SR), num_workers=1, seed=3)
        assert (len(tr_loader), len(val_loader)) == (2, 3)
        out = []
        for epoch in range(2):
            tr_loader.set_epoch(epoch)
            out += list(tr_loader) + list(val_loader)
        return out

    _seed(11)
    got = batches(dataset, loader, tf)
    _seed(11)
    want = batches(jdataset, jloader, jtf)
    assert len(got) == len(want) == 10
    _assert_same(got, want)


def _bg_dir(corpus):
    return str(corpus / "noise")


TRANSFORMS = {
    "RandomCrop": lambda m, c: m.RandomCrop(900),
    "CenterCrop": lambda m, c: m.CenterCrop(900),
    "PadToSize_constant": lambda m, c: m.PadToSize(30000, "constant"),
    "PadToSize_wrap": lambda m, c: m.PadToSize(30000, "wrap"),
    "TimeMasking": lambda m, c: m.TimeMasking(0.3, 3),
    "ClipValue": lambda m, c: m.ClipValue(0.2),
    "RandomGain": lambda m, c: m.RandomGain(prob=0.7),
    "PeakNormalization": lambda m, c: m.PeakNormalization(),
    "AddGaussianNoise": lambda m, c: m.AddGaussianNoise(),
    "UseWithProb": lambda m, c: m.UseWithProb(m.RandomGain(prob=1.0), 0.5),
    "OneOf": lambda m, c: m.OneOf([m.PadToSize(30000, "wrap"),
                                   m.PadToSize(30000, "constant")],
                                  p=[0.3, 0.7]),
    "OneOf_uniform": lambda m, c: m.OneOf([m.RandomCrop(10),
                                           m.CenterCrop(20)]),
    "AddRandomNoise": lambda m, c: m.AddRandomNoise(
        m.BackgroundNoiseGenerator(_bg_dir(c), num_samples=16000)),
    "BackgroundNoise_in_memory": lambda m, c: m.AddRandomNoise(
        m.BackgroundNoiseGenerator(_bg_dir(c), in_memory=True,
                                   num_samples=16000)),
    "raw_v2_train": lambda m, c: m.get_raw_transforms_v2(
        True, 12000, background_noise_path=_bg_dir(c)),
    "raw_v2_val": lambda m, c: m.get_raw_transforms_v2(
        False, 12000, center_crop_val=True),
    "simple_train": lambda m, c: m.simple_supervised_transforms(True, 12000),
    "simple_val": lambda m, c: m.simple_supervised_transforms(False, 12000),
    "leaf_train": lambda m, c: m.leaf_supervised_transforms(True, 12000),
    "leaf_val": lambda m, c: m.leaf_supervised_transforms(False, 12000),
    "host_crop_train": lambda m, c: m.leaf_host_crop_transforms(True, 12000),
    "host_crop_val": lambda m, c: m.leaf_host_crop_transforms(False, 12000),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(corpus, name):
    rng = np.random.RandomState(7)
    signals = [(rng.randn(16000) * 2.0).astype(np.float32)
               for _ in range(6)]
    port, ref = (TRANSFORMS[name](m, corpus) for m in (tf, jtf))
    for i, x in enumerate(signals):
        _seed(i)
        got = port(x.copy())
        _seed(i)
        _assert_same(got, ref(x.copy()))


def test_spec_augment_matches_jax():
    spec = np.random.RandomState(8).rand(40, 100).astype(np.float32)
    for s in range(4):
        _seed(s)
        got = tf.SpecAugment()(spec)
        _seed(s)
        _assert_same(got, jtf.SpecAugment()(spec))


def test_prefetch_to_device_on_the_cpu_keeps_order_and_frees_feeder():
    batches = [(np.full((2, 3), i, np.float32), np.arange(2, dtype=np.int32))
               for i in range(7)]
    place = loader.pinned_placer("cpu")
    got = list(loader.prefetch_to_device(iter(batches), place, size=2))
    assert len(got) == 7
    for (x, y), (bx, by) in zip(got, batches):
        assert torch.equal(x, torch.from_numpy(bx))
        assert y.dtype == torch.int64 and torch.equal(y, torch.from_numpy(
            by.astype(np.int64)))
    before = threading.active_count()
    feed = loader.prefetch_to_device(iter(batches * 10), place, size=1)
    next(feed)
    feed.close()                      # abandon early
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before
