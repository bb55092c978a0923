"""Packed msgpack shards in the port, held against the JAX package and
the ``msgpack`` package on the CPU.

- ``leaf_tpu_torch.data.msgpack_lite`` against ``msgpack``: both
  directions, byte for byte and value for value (a hypothesis property
  over trees of the subset, and every width boundary); ext types, the
  reserved byte, msgpack_numpy array maps, truncated input, trailing
  bytes, invalid UTF-8 and non-str keys raise;
- ``PackedDataset``, ``deflate_packed_batch``, ``setup_dataloaders(
  packed=True)`` and ``collate_contrastive`` against ``leaf_tpu.data``'s,
  on shards the ``msgpack`` package wrote: exact. Training items are
  drawn from Python's and numpy's global RNGs in the same order in both
  packages, so with both seeded alike they are equal too; the threaded
  train loader's batches are held as multisets, their sizes in order;
- ``python -m leaf_tpu_torch.pack_dataset`` against
  ``scripts/pack_dataset.py``: the same shard bytes and manifest;
- ``python -m leaf_tpu_torch.train --use_packed_dataset`` on the CPU,
  with a short shard, also under ``--steps_per_call 2``.
"""

import csv
import importlib.util
import json
import os
import random
import sys
import types

import msgpack
import numpy as np
import pandas as pd
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from leaf_tpu.data import PackedDataset as JaxPacked
from leaf_tpu.data import deflate_packed_batch as jax_deflate
from leaf_tpu.data import loader as jax_loader
from leaf_tpu.data import transforms as JT
from leaf_tpu_torch import train
from leaf_tpu_torch.data import PackedDataset, deflate_packed_batch
from leaf_tpu_torch.data import loader as port_loader
from leaf_tpu_torch.data import msgpack_lite
from leaf_tpu_torch.data import transforms as PT
from leaf_tpu_torch.data.audio import write_wav
from leaf_tpu_torch.data.dataset import read_manifest
from leaf_tpu_torch.pack_dataset import pack
from tests.test_torch_port_cuda import make_tiny_exp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000
CLIP = SR // 4


# ----------------------------------------------------------------- codec
def _trees():
    scalars = (st.none() | st.booleans()
               | st.integers(-2 ** 63, 2 ** 64 - 1)
               | st.floats(allow_nan=False) | st.text() | st.binary())
    return st.recursive(
        scalars,
        lambda kids: (st.lists(kids, max_size=20)
                      | st.dictionaries(st.text() | st.binary(), kids,
                                        max_size=20)),
        max_leaves=60)


@settings(max_examples=150, deadline=None)
@given(_trees())
def test_codec_matches_msgpack_both_ways(tree):
    data = msgpack.packb(tree)
    assert msgpack_lite.packb(tree) == data
    assert msgpack_lite.unpackb(data) == msgpack.unpackb(data, raw=False)
    assert msgpack.unpackb(msgpack_lite.packb(tree), raw=False) == tree


_INTS = [-2 ** 63, -2 ** 31 - 1, -2 ** 31, -32769, -32768, -129, -128, -33,
         -32, -1, 0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
         2 ** 64 - 1]
_LENGTHS = [0, 15, 16, 31, 32, 255, 256, 65535, 65536]


@pytest.mark.parametrize("value", _INTS)
def test_codec_int_widths(value):
    data = msgpack.packb(value)
    assert msgpack_lite.packb(value) == data
    assert msgpack_lite.unpackb(data) == value


@pytest.mark.parametrize("kind", ["str", "bin", "array", "map"])
@pytest.mark.parametrize("n", _LENGTHS)
def test_codec_length_widths(kind, n):
    value = {"str": "é" * (n // 2) + "a" * (n % 2), "bin": b"\x01" * n,
             "array": list(range(n)),
             "map": {f"k{i}": i for i in range(n)}}[kind]
    data = msgpack.packb(value)
    assert msgpack_lite.packb(value) == data
    got = msgpack_lite.unpackb(data)
    assert got == msgpack.unpackb(data, raw=False) == value
    assert type(got) is type(value)


def test_codec_floats():
    for x in (0.0, -1.5, 1e300, float("inf")):
        assert msgpack_lite.packb(x) == msgpack.packb(x)
        single = msgpack.packb(x, use_single_float=True)   # float32, 0xca
        assert single[0] == 0xca
        assert msgpack_lite.unpackb(single) == msgpack.unpackb(single)
    nan = msgpack_lite.unpackb(msgpack.packb(float("nan")))
    assert np.isnan(nan)
    assert msgpack_lite.packb(np.float64(2.5)) == msgpack.packb(2.5)
    assert msgpack_lite.packb((1, b"x")) == msgpack.packb((1, b"x"))


@pytest.mark.parametrize("data, match", [
    (msgpack.packb(msgpack.ExtType(5, b"ab")), "0xd5"),
    (msgpack.packb(msgpack.ExtType(5, b"abc")), "0xc7"),
    (msgpack.packb(msgpack.Timestamp(1, 2)), "0xd7"),
    (b"\xc1", "0xc1"),
    (msgpack.packb([1, 2]) + b"\x00", "trailing"),
    (msgpack.packb({1: 2}), "map key"),
    (msgpack.packb({b"nd": True, b"type": "<f4", b"kind": b"",
                    b"shape": [2], b"data": b"\x00" * 8}), "msgpack_numpy"),
])
def test_codec_refuses_outside_its_subset(data, match):
    with pytest.raises(ValueError, match=match):
        msgpack_lite.unpackb(data)


def test_codec_refuses_truncated_and_bad_utf8():
    data = msgpack.packb([{"audio": b"\x00" * 300, "label": "x" * 40,
                           "duration": 70000}])
    for n in range(len(data)):
        with pytest.raises(ValueError):
            msgpack_lite.unpackb(data[:n])
    with pytest.raises(UnicodeDecodeError):
        msgpack_lite.unpackb(b"\xa2\xff\xfe")
    with pytest.raises(UnicodeDecodeError):   # msgpack refuses it too
        msgpack.unpackb(b"\xa2\xff\xfe", raw=False)


def test_codec_pack_refusals_match_msgpack():
    for value, exc in ((2 ** 64, OverflowError), (-2 ** 63 - 1, OverflowError),
                       (object(), TypeError), ({1, 2}, TypeError)):
        with pytest.raises(exc):
            msgpack.packb(value)
        with pytest.raises(exc):
            msgpack_lite.packb(value)


# --------------------------------------------------------------- dataset
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """12 tone WAVs of 0.2–0.5 s in 3 classes, a label map, and shards
    of 5, 5 and 2 records written by the msgpack package; the records'
    durations are the clips' own, except two (shorter and longer)."""
    root = tmp_path_factory.mktemp("packed")
    rng = np.random.RandomState(0)
    files, labels = [], []
    for i in range(12):
        n = int((0.2 + 0.1 * (i % 4)) * SR)
        x = 0.3 * np.sin(2 * np.pi * (300 + 100 * (i % 3)) * np.arange(n)
                         / SR) + 0.02 * rng.randn(n)
        p = str(root / f"c{i}.wav")
        write_wav(p, x.astype(np.float32), SR)
        files.append(p)
        labels.append(f"class{i % 3}")
    pd.DataFrame({"files": files, "labels": labels}).to_csv(
        root / "raw.csv", index=False)
    (root / "lbl.json").write_text(json.dumps({f"class{c}": c
                                               for c in range(3)}))
    shards = []
    for s, (a, b) in enumerate(((0, 5), (5, 10), (10, 12))):
        records = []
        for i in range(a, b):
            dur = int((0.2 + 0.1 * (i % 4)) * SR)
            dur = {3: dur - 2000, 7: dur + 3000}.get(i, dur)
            label = labels[i] if i % 2 else f"{labels[i]},class{(i + 1) % 3}"
            with open(files[i], "rb") as f:
                records.append({"audio": f.read(), "label": label,
                                "duration": dur})
        p = root / f"shard{s}.msgpack"
        p.write_bytes(msgpack.packb(records))
        shards.append(str(p))
    pd.DataFrame({"files": shards}).to_csv(root / "packed.csv", index=False)
    return root


def _pair(corpus, **kw):
    """The JAX and the port PackedDataset on the corpus' shards."""
    tf = kw.pop("transform", None)
    mode = kw.pop("mode", "multilabel")
    ac = {"sample_rate": SR, "min_duration": 0.25, "random_clip_size": 0.25,
          **kw.pop("audio_config", {})}
    args = (str(corpus / "packed.csv"), str(corpus / "lbl.json"), ac)
    jax_ds = JaxPacked(*args, mode=mode,
                       transform=tf and tf(JT), **kw)
    port_ds = PackedDataset(*args, mode=mode, transform=tf and tf(PT), **kw)
    return jax_ds, port_ds


def _seeded(ds, i, seed):
    random.seed(seed)
    np.random.seed(seed)
    return ds[i]


def _assert_items_equal(a, b):
    (wa, la), (wb, lb) = a, b
    assert len(wa) == len(wb) == len(la) == len(lb)
    for x, y in zip(wa, wb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)


def _mixer(ds, audio, label):
    return audio[::-1] * 0.5, np.asarray(label) * 0.9


@pytest.mark.parametrize("case", [
    {"is_val": True},
    {"is_val": True, "mode": "multiclass_first"},
    {"is_val": True, "audio_config": {"normalize": True}},
    {"is_val": True,
     "transform": lambda m: m.leaf_host_crop_transforms(False, CLIP)},
    {"is_val": True, "mixer": _mixer},
    {"is_val": False,
     "transform": lambda m: m.leaf_host_crop_transforms(True, CLIP)},
    {"is_val": False, "cropped_read": True},
    {"is_val": False, "cropped_read": True, "mixer": _mixer,
     "audio_config": {"normalize": True}},
])
def test_packed_items_equal_jax(corpus, case):
    case = dict(case)
    if case.get("mode") == "multiclass_first":
        # multiclass labels: one label per record
        case["mode"] = "multiclass"
        jax_ds, port_ds = _pair(corpus, **case)
        for ds in (jax_ds, port_ds):
            ds._read_block = _first_label(ds._read_block)
    else:
        jax_ds, port_ds = _pair(corpus, **case)
    assert len(jax_ds) == len(port_ds) == 3
    for i in range(3):
        _assert_items_equal(_seeded(jax_ds, i, 10 + i),
                            _seeded(port_ds, i, 10 + i))
    items = [_seeded(port_ds, i, i) for i in range(3)]
    jitems = [_seeded(jax_ds, i, i) for i in range(3)]
    _assert_items_equal(deflate_packed_batch(items), jax_deflate(jitems))


def _first_label(read):
    def wrapped(path):
        block = read(path)
        for r in block:
            r["label"] = r["label"].split(",")[0]
        return block
    return wrapped


def test_cropped_read_uses_the_record_duration(corpus):
    # the crop start is drawn below the record's duration - frames: the
    # record 7 of shard 1 claims 3000 samples more than its clip holds,
    # so a late start reads less than a crop and is tile-padded
    _, port_ds = _pair(corpus, is_val=False, cropped_read=True)
    block = port_ds._read_block(port_ds.files[1])
    assert [r["duration"] for r in block][2] == int(0.5 * SR) + 3000
    waves, _ = _seeded(port_ds, 1, 3)
    assert all(w.shape == (CLIP,) for w in waves)


def test_str_typed_audio_fails_in_both(corpus, tmp_path):
    # an old use_bin_type=False writer stored bytes as str: both readers
    # refuse to decode it as UTF-8
    with open(read_manifest(str(corpus / "raw.csv"))["files"][0], "rb") as f:
        blob = f.read()
    p = tmp_path / "old.msgpack"
    p.write_bytes(msgpack.packb([{"audio": blob, "label": "class0",
                                  "duration": 10}], use_bin_type=False))
    pd.DataFrame({"files": [str(p)]}).to_csv(tmp_path / "old.csv",
                                             index=False)
    args = (str(tmp_path / "old.csv"), str(corpus / "lbl.json"),
            {"sample_rate": SR, "min_duration": 0.25})
    for cls in (JaxPacked, PackedDataset):
        with pytest.raises(UnicodeDecodeError):
            cls(*args, mode="multiclass", is_val=True)[0]


def _fake_gcs(monkeypatch, blob_root):
    seen = {"buckets": [], "blobs": []}

    class Blob:
        def __init__(self, name):
            seen["blobs"].append(name)
            self.path = os.path.join(blob_root, name)

        def open(self, mode):
            return open(self.path, mode)

    class Bucket:
        def blob(self, name):
            return Blob(name)

    class Client:
        def get_bucket(self, name):
            seen["buckets"].append(name)
            return Bucket()

    storage = types.ModuleType("google.cloud.storage")
    storage.Client = Client
    cloud = types.ModuleType("google.cloud")
    cloud.storage = storage
    google = types.ModuleType("google")
    google.cloud = cloud
    monkeypatch.setitem(sys.modules, "google", google)
    monkeypatch.setitem(sys.modules, "google.cloud", cloud)
    monkeypatch.setitem(sys.modules, "google.cloud.storage", storage)
    return seen


def test_gcs_branch_equals_jax(corpus, tmp_path, monkeypatch):
    names = [os.path.basename(p) for p in
             read_manifest(str(corpus / "packed.csv"))["files"]]
    pd.DataFrame({"files": names}).to_csv(tmp_path / "gcs.csv", index=False)
    args = (str(tmp_path / "gcs.csv"), str(corpus / "lbl.json"),
            {"sample_rate": SR, "min_duration": 0.25})
    got = {}
    for name, cls in (("jax", JaxPacked), ("port", PackedDataset)):
        seen = _fake_gcs(monkeypatch, str(corpus))
        ds = cls(*args, mode="multilabel", is_val=True,
                 gcs_bucket_path="my-audio-bucket")
        assert ds._client is None   # made on the first read
        got[name] = [ds[i] for i in range(3)] + [ds[0]]
        assert seen == {"buckets": ["my-audio-bucket"],
                        "blobs": names + names[:1]}
    for a, b in zip(got["jax"], got["port"]):
        _assert_items_equal(a, b)


def test_gcs_without_the_client_raises_import_error(corpus, monkeypatch):
    for name in ("google", "google.cloud", "google.cloud.storage"):
        monkeypatch.setitem(sys.modules, name, None)
    args = (str(corpus / "packed.csv"), str(corpus / "lbl.json"),
            {"sample_rate": SR, "min_duration": 0.25})
    for cls in (JaxPacked, PackedDataset):
        ds = cls(*args, mode="multilabel", is_val=True,
                 gcs_bucket_path="b")
        with pytest.raises(ImportError):
            ds[0]


# --------------------------------------------------------------- loaders
def _loaders(mod, corpus, batch_shards):
    jax_side = mod is jax_loader
    ds_cls = JaxPacked if jax_side else PackedDataset
    tfm = JT if jax_side else PT
    args = (str(corpus / "packed.csv"), str(corpus / "lbl.json"),
            {"sample_rate": SR, "min_duration": 0.25})
    tr = ds_cls(*args, mode="multilabel",
                transform=tfm.leaf_host_crop_transforms(True, CLIP))
    va = ds_cls(*args, mode="multilabel", is_val=True,
                transform=tfm.leaf_host_crop_transforms(False, CLIP))
    return mod.setup_dataloaders(tr, va, batch_shards, target_len=CLIP,
                                 multiclass=False, num_workers=1,
                                 packed=True, seed=5)


def _rows(x, y):
    """A batch as the sorted list of its (waveform, label) rows."""
    return sorted((tuple(a), tuple(np.atleast_1d(b)))
                  for a, b in zip(x.tolist(), y.tolist()))


@pytest.mark.parametrize("batch_shards", [1, 2, 3])
def test_packed_loaders_equal_jax(corpus, batch_shards):
    # batch_size counts shards; drop_last drops shards: with 1 shard per
    # batch the short shard (2 records) makes a batch of 2
    (jtr, jva), (ptr, pva) = (_loaders(jax_loader, corpus, batch_shards),
                              _loaders(port_loader, corpus, batch_shards))
    assert len(jtr) == len(ptr) == 3 // batch_shards
    jvb, pvb = list(jva), list(pva)
    assert len(jvb) == len(pvb) == -(-3 // batch_shards)
    for a, b in zip(jvb, pvb):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    for epoch in range(2):
        batches = []
        for loader in (jtr, ptr):
            loader.set_epoch(epoch)
            np.random.seed(epoch)
            random.seed(epoch)
            batches.append(list(loader))
        jb, pb = batches
        assert [x.shape for x, _ in jb] == [x.shape for x, _ in pb]
        if batch_shards == 1:
            assert sorted(x.shape[0] for x, _ in pb) == [2, 5, 5]
        for (jx, jy), (px, py) in zip(jb, pb):
            assert jx.dtype == px.dtype == np.float32
            assert _rows(jx, jy) == _rows(px, py)


def test_collate_contrastive_equals_jax():
    rng = np.random.RandomState(2)
    batch = [(rng.randn(n).astype(np.float32), rng.randn(m),
              i, rng.rand(4)) for i, (n, m) in enumerate(
                  ((100, 80), (60, 120), (90, 90)))]
    for t in (None, 70):
        a = jax_loader.collate_contrastive(batch, t)
        b = port_loader.collate_contrastive(batch, t)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)


# ----------------------------------------------------------- pack_dataset
def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_pack_dataset_equals_the_jax_script(corpus, tmp_path, monkeypatch,
                                            capsys):
    manifest = str(corpus / "raw.csv")
    port_out = pack(manifest, str(tmp_path / "port"), records_per_shard=5,
                    prefix="tr")
    monkeypatch.setattr(sys, "argv", [
        "pack_dataset.py", manifest, str(tmp_path / "jax"),
        "--records-per-shard", "5", "--prefix", "tr"])
    _load_script("pack_dataset").main()
    assert "packed 12/12 records into 3 shards" in capsys.readouterr().out
    jax_out = str(tmp_path / "jax" / "tr_packed.csv")
    port_shards = read_manifest(port_out)["files"]
    assert pd.read_csv(port_out)["files"].tolist() == port_shards
    jax_shards = pd.read_csv(jax_out)["files"].tolist()
    assert [os.path.basename(p) for p in port_shards] == [
        os.path.basename(p) for p in jax_shards] == [
        f"tr{i:05d}.msgpack" for i in range(3)]
    with open(port_out) as f, open(jax_out) as g:
        assert f.read().replace(str(tmp_path / "port"), "") == \
            g.read().replace(str(tmp_path / "jax"), "")
    files = iter(read_manifest(manifest)["files"])
    for p, q in zip(port_shards, jax_shards):
        with open(p, "rb") as f, open(q, "rb") as g:
            data = f.read()
            assert data == g.read()
        for r, path in zip(msgpack.unpackb(data, raw=False), files):
            with open(path, "rb") as f:
                assert r["audio"] == f.read()
    assert next(files, None) is None
    # the port's shards read by the JAX reader: the port reader's items
    args = (port_out, str(corpus / "lbl.json"),
            {"sample_rate": SR, "min_duration": 0.25})
    for i in range(3):
        _assert_items_equal(JaxPacked(*args, mode="multiclass",
                                      is_val=True)[i],
                            PackedDataset(*args, mode="multiclass",
                                          is_val=True)[i])


# -------------------------------------------------------------- train CLI
PACKED_CFG = {"batch_size: 4": "batch_size: 1",
              "train_manifest: train.csv": "train_manifest: packed/tr_packed.csv",
              "val_manifest: val.csv": "val_manifest: packed/va_packed.csv"}


def _packed_exp(root):
    """make_tiny_exp, its train manifest packed into shards of 5 (the
    last of 4) and its val manifest into shards of 4 (the last of 2), and
    a cfg of one shard per batch reading them."""
    make_tiny_exp(root)
    pack(str(root / "train.csv"), str(root / "packed"), 5, "tr")
    pack(str(root / "val.csv"), str(root / "packed"), 4, "va")
    text = (root / "cfg.cfg").read_text()
    for old, new in PACKED_CFG.items():
        assert old in text
        text = text.replace(old, new)
    (root / "packed.cfg").write_text(text)
    return root


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    # the test runner shares the cores among its workers: PyTorch's
    # default of one intra-op thread per core oversubscribes them
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("k", [1, 2])
def test_train_cli_packed(tmp_path, capsys, k):
    root = _packed_exp(tmp_path)
    assert train.main([
        "--cfg_file", str(root / "packed.cfg"), "--expdir",
        str(root / "exp"), "--epochs", "1", "--num_workers", "1",
        "--log_steps", "1", "--device", "cpu", "--use_packed_dataset",
        "--steps_per_call", str(k)]) == 0
    out = capsys.readouterr().out
    assert "train batches/epoch: 5 | val batches: 2 | wire: float32" in out
    line = [ln for ln in out.splitlines() if ln.startswith("epoch 0:")]
    assert len(line) == 1 and "kernels" in line[0]
    loss = float(line[0].split("tr_loss ")[1].split()[0])
    assert np.isfinite(loss)
    assert os.path.exists(root / "exp" / "epoch_000" / "state.pt")


def test_group_feed_never_stacks_two_shapes():
    b = [(np.zeros((n, 3)), np.zeros(n)) for n in (5, 5, 4, 5, 5, 5, 4)]
    tags = [(t, len(p) if t == "multi" else p[0].shape[0])
            for t, p in train._group_feed(b, 2)]
    assert tags == [("multi", 2), ("single", 4), ("multi", 2),
                    ("single", 5), ("single", 4)]
    for t, p in train._group_feed(b, 2):
        if t == "multi":
            assert len({x.shape for x, _ in p}) == 1


def test_train_cli_packed_refuses_int16_wire(tmp_path):
    root = _packed_exp(tmp_path)
    with pytest.raises(SystemExit, match="--use_packed_dataset"):
        train.main(["--cfg_file", str(root / "packed.cfg"), "--expdir",
                    str(root / "exp"), "--device", "cpu",
                    "--use_packed_dataset", "--wire_dtype", "int16"])


@pytest.mark.parametrize("flag", [("--n_devices", "2"), ("--multihost",)])
def test_data_parallel_flags_still_raise(tmp_path, flag):
    # without a launcher: the torchrun command line to use
    root = _packed_exp(tmp_path)
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        train.main(["--cfg_file", str(root / "packed.cfg"), "--expdir",
                    str(root / "exp"), "--device", "cpu",
                    "--use_packed_dataset", *flag])


def test_manifest_written_by_pack_reads_in_csv_and_pandas(tmp_path):
    root = _packed_exp(tmp_path)
    path = str(root / "packed" / "tr_packed.csv")
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["files"] and len(rows) == 6
    assert pd.read_csv(path)["files"].tolist() == [r[0] for r in rows[1:]]
    sizes = []
    for r in rows[1:]:
        with open(r[0], "rb") as f:
            sizes.append(len(msgpack.unpackb(f.read(), raw=False)))
    assert sizes == [5, 5, 5, 5, 4]
