"""Pack a CSV-manifest audio dataset into msgpack shards.

The port's counterpart of ``scripts/pack_dataset.py``, in the stdlib and
numpy: the manifest is read with ``csv``, each clip measured with the
port's ``load_audio`` and the shards written with ``msgpack_lite``. It
writes the record layout ``PackedDataset`` reads (the port's, the JAX
package's and the reference's): one msgpack document per shard, a list
of records ``{"audio": <the file's bytes>, "label": <manifest label>,
"duration": <samples>}``, plus a packed manifest CSV
(``<prefix>_packed.csv``, one ``files`` column listing the shards) —
the ``data.train_manifest`` / ``val_manifest`` of a cfg trained with
``python -m leaf_tpu_torch.train --use_packed_dataset``. A file that
does not decode is skipped (and named on stderr), never half-packed.

Usage:

    python -m leaf_tpu_torch.pack_dataset manifest.csv out_dir/ \\
        [--records-per-shard 256] [--prefix train] [--sample-rate 16000]
"""

from __future__ import annotations

import argparse
import csv
import os
import sys
from typing import List

from leaf_tpu_torch.data import msgpack_lite
from leaf_tpu_torch.data.audio import load_audio
from leaf_tpu_torch.data.dataset import read_manifest


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("manifest", help="CSV with 'files' and 'labels' columns")
    p.add_argument("out_dir")
    p.add_argument("--records-per-shard", type=int, default=256)
    p.add_argument("--prefix", type=str, default="shard")
    p.add_argument("--sample-rate", type=int, default=16000,
                   help="expected file sample rate (the decoder asserts "
                        "it; duration is stored in samples at this rate)")
    return p.parse_args(argv)


def pack(manifest: str, out_dir: str, records_per_shard: int = 256,
         prefix: str = "shard", sample_rate: int = 16000) -> str:
    """Write the shards and the packed manifest; returns its path."""
    cols = read_manifest(manifest)
    if "files" not in cols or "labels" not in cols:
        raise SystemExit("manifest needs 'files' and 'labels' columns")
    os.makedirs(out_dir, exist_ok=True)
    shards: List[str] = []
    records: list = []

    def flush():
        if not records:
            return
        path = os.path.join(out_dir, f"{prefix}{len(shards):05d}.msgpack")
        with open(path, "wb") as f:
            f.write(msgpack_lite.packb(records))
        shards.append(path)
        records.clear()

    skipped = 0
    for fpath, label in zip(cols["files"], cols["labels"]):
        try:
            with open(fpath, "rb") as f:
                blob = f.read()
            # the duration in samples through the readers' decode chain;
            # min_duration=None: short clips are not tile-padded
            wav = load_audio(fpath, sample_rate, min_duration=None)
        except Exception as e:  # an unreadable file is skipped, not packed
            print(f"skipping {fpath}: {e}", file=sys.stderr)
            skipped += 1
            continue
        records.append({"audio": blob, "label": str(label),
                        "duration": int(wav.shape[-1])})
        if len(records) >= records_per_shard:
            flush()
    flush()

    out_manifest = os.path.join(out_dir, f"{prefix}_packed.csv")
    with open(out_manifest, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")   # as pandas' to_csv
        w.writerow(("files",))
        w.writerows((s,) for s in shards)
    n = len(cols["files"])
    print(f"packed {n - skipped}/{n} records into {len(shards)} shards; "
          f"manifest: {out_manifest}")
    return out_manifest


def main(argv=None) -> int:
    args = parse_args(argv)
    pack(args.manifest, args.out_dir, args.records_per_shard, args.prefix,
         args.sample_rate)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
