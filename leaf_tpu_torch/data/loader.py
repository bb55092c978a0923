"""Batch loader: sharded sampling, fixed-shape collate, threaded prefetch.

``leaf_tpu.data.loader`` in the port (numpy and threads; no torch
``DataLoader``), with the same ordering and backpressure:

- ``ShardedSampler``: torch ``DistributedSampler`` semantics (epoch-seeded
  shuffle, padding to a multiple of the world size, stride by rank);
- ``collate_fixed`` pads every batch to ONE static length, so every train
  step sees the same shape;
- ``DataLoader``: worker threads decode batches, delivered in sampler
  order, at most ``prefetch`` completed batches ahead of the consumer;
- ``prefetch_to_device``: a feeder thread places batches on the device
  ahead of the consumer; ``pinned_placer`` is the place function the
  CLIs give it (pinned host memory, ``non_blocking`` copies);
- ``make_packed_collate`` flattens packed shards into one batch (under
  ``setup_dataloaders(packed=True)`` the batch size counts shards), and
  ``collate_contrastive`` stacks two-view items.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional, Tuple

import numpy as np

import torch

from leaf_tpu_torch.data.dataset import deflate_packed_batch

__all__ = ["ShardedSampler", "collate_fixed", "collate_contrastive",
           "DataLoader", "make_packed_collate", "setup_dataloaders",
           "prefetch_to_device", "pinned_placer"]


class ShardedSampler:
    """Epoch-seeded shuffled index shards (torch DistributedSampler
    semantics: pad indices to world_size multiple, stride by rank)."""

    def __init__(self, dataset_len: int, num_replicas: int = 1, rank: int = 0,
                 shuffle: bool = True, seed: int = 0,
                 drop_last: bool = False):
        self.dataset_len = dataset_len
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        if drop_last:
            self.num_samples = dataset_len // num_replicas
        else:
            self.num_samples = -(-dataset_len // num_replicas)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self) -> Iterator[int]:
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            indices = rng.permutation(self.dataset_len)
        else:
            indices = np.arange(self.dataset_len)
        total = self.num_samples * self.num_replicas
        if not self.drop_last and total > len(indices):
            indices = np.concatenate(
                [indices, indices[:total - len(indices)]])
        else:
            indices = indices[:total]
        return iter(indices[self.rank::self.num_replicas].tolist())

    def __len__(self) -> int:
        return self.num_samples


def collate_fixed(batch, target_len: Optional[int] = None,
                  multiclass: bool = True):
    """Stack (wave, label) pairs into (B, T) + labels, zero-padding (or
    cropping) every wave to ``target_len`` (default: batch max). int16
    waveforms (wire_dtype='int16') stay int16 — the step decodes them on
    the device; everything else is collated as float32."""
    wire = np.asarray(batch[0][0]).dtype
    dtype = np.int16 if wire == np.int16 else np.float32
    waves = [np.asarray(w, dtype=dtype).reshape(-1) for w, _ in batch]
    labels = [lbl for _, lbl in batch]
    t = target_len or max(len(w) for w in waves)
    out = np.zeros((len(waves), t), dtype=dtype)
    for i, w in enumerate(waves):
        n = min(len(w), t)
        out[i, :n] = w[:n]
    if multiclass:
        y = np.asarray(labels, dtype=np.int32)
    else:
        y = np.stack([np.asarray(l, dtype=np.float32) for l in labels])
    return out, y


def collate_contrastive(batch, target_len: Optional[int] = None):
    """Two-view contrastive collate: items are (x_i, x_j, target,
    supervised_target) — reference utilities/data/utils.py:56-85. Returns
    (xi (B,T), xj (B,T), targets (B,), supervised_targets (B, C))."""
    xi = [np.asarray(b[0], dtype=np.float32).reshape(-1) for b in batch]
    xj = [np.asarray(b[1], dtype=np.float32).reshape(-1) for b in batch]
    t = target_len or max(max(len(a) for a in xi), max(len(a) for a in xj))

    def stack(ws):
        out = np.zeros((len(ws), t), dtype=np.float32)
        for i, w in enumerate(ws):
            n = min(len(w), t)
            out[i, :n] = w[:n]
        return out

    targets = np.asarray([b[2] for b in batch], dtype=np.int32)
    sup = np.stack([np.asarray(b[3], dtype=np.float32) for b in batch])
    return stack(xi), stack(xj), targets, sup


class DataLoader:
    """Minimal map-style loader: sampler → worker threads → prefetch queue.

    Threads (not processes) because the work is numpy + the WAV decoder,
    which release the GIL for the bulk copies, and because forking a
    process that holds a CUDA context is unsafe.
    """

    def __init__(self, dataset, batch_size: int,
                 sampler: Optional[ShardedSampler] = None,
                 shuffle: bool = True,
                 collate_fn: Optional[Callable] = None,
                 target_len: Optional[int] = None,
                 multiclass: bool = True,
                 num_workers: int = 4,
                 drop_last: bool = False,
                 prefetch: int = 4,
                 seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler or ShardedSampler(
            len(dataset), shuffle=shuffle, seed=seed)
        self.collate_fn = collate_fn or (
            lambda b: collate_fixed(b, target_len, multiclass))
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch = prefetch
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch
        self.sampler.set_epoch(epoch)

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last \
            else -(-n // self.batch_size)

    def _batches_of_indices(self):
        idxs = list(self.sampler)
        for i in range(0, len(idxs), self.batch_size):
            chunk = idxs[i:i + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield chunk

    def __iter__(self):
        index_batches = list(self._batches_of_indices())
        n_batches = len(index_batches)
        work_q: "queue.Queue" = queue.Queue()
        # Sequence numbers keep batch order deterministic across workers.
        for seq, chunk in enumerate(index_batches):
            work_q.put((seq, chunk))
        results = {}
        results_lock = threading.Lock()
        next_seq = [0]
        done = threading.Event()

        errors = []
        ready = threading.Condition(results_lock)
        # Backpressure budget: workers pause while >= prefetch completed
        # batches sit undelivered, so the host never decodes more than
        # prefetch + num_workers batches ahead of the device (an unbounded
        # `results` would buffer the whole epoch when the loader outruns
        # the train step and OOM the host on large manifests).
        budget = max(1, self.prefetch)

        def worker():
            while not done.is_set():
                with ready:
                    while (len(results) >= budget and not done.is_set()
                           and not errors):
                        ready.wait(timeout=0.1)
                if done.is_set():
                    return
                try:
                    seq, chunk = work_q.get_nowait()
                except queue.Empty:
                    return
                try:
                    items = [self.dataset[i] for i in chunk]
                    batch = self.collate_fn(items)
                except Exception as exc:  # surface in the main thread
                    with ready:
                        errors.append(exc)
                        ready.notify_all()
                    done.set()
                    return
                with ready:
                    results[seq] = batch
                    ready.notify_all()

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        try:
            delivered = 0
            while delivered < n_batches:
                with ready:
                    while next_seq[0] not in results and not errors:
                        ready.wait(timeout=1.0)
                    if errors:
                        raise errors[0]
                    batch = results.pop(next_seq[0])
                    ready.notify_all()  # wake workers paused on the budget
                next_seq[0] += 1
                delivered += 1
                yield batch
        finally:
            done.set()
            with ready:
                ready.notify_all()


def prefetch_to_device(iterator, place_fn: Callable, size: int = 2):
    """Asynchronous host→device feed — the reference's ``MpDeviceLoader``
    equivalent (reference: train_xla.py:195-196).

    A feeder thread runs ``place_fn(batch)`` (the CLIs pass
    ``pinned_placer``) up to ``size`` batches ahead of the consumer, so the
    host-side copy into pinned memory overlaps device compute instead of
    serializing with it. The bounded queue caps in-flight device memory
    at ``size + 1`` batches. Abandoning the
    generator early (break / exception / GeneratorExit — e.g. the SIGTERM
    preemption path) stops the feeder and releases its queued device
    buffers instead of leaving a thread blocked in ``q.put`` forever.
    """
    q: "queue.Queue" = queue.Queue(maxsize=max(1, size))
    sentinel = object()
    errors = []
    stop = threading.Event()

    def put_until_stop(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def feeder():
        try:
            for item in iterator:
                if not put_until_stop(place_fn(item)):
                    return
        except Exception as exc:  # surfaced in the consumer
            errors.append(exc)
        finally:
            # The sentinel MUST be delivered while the consumer lives —
            # dropping it on a momentarily-full queue would hang the
            # consumer's q.get() at end of epoch.
            put_until_stop(sentinel)

    feeder_thread = threading.Thread(target=feeder, daemon=True)
    feeder_thread.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if errors:
                    raise errors[0]
                return
            yield item
    finally:
        stop.set()

        def drain():
            while True:  # drop queued batches so their buffers free
                try:
                    q.get_nowait()
                except queue.Empty:
                    break

        drain()
        # A feeder blocked inside q.put(timeout=0.2) can complete its put
        # AFTER the drain above — join (bounded by the put timeout) and
        # drain once more so the release of queued device buffers is
        # deterministic, not GC-dependent.
        feeder_thread.join(timeout=1.0)
        drain()


def pinned_placer(device) -> Callable:
    """``place_fn`` for ``prefetch_to_device``: a tuple of host arrays →
    the same tuple of tensors on ``device``.

    On a CUDA device each array is copied into pinned host memory and
    then to the card with ``non_blocking=True``, on the feeder thread's
    current stream (the default stream unless the caller set another), so
    the consumer's kernels on that stream see the copy done. The pinned
    buffer stays alive until its copy is done without any reference held
    here: PyTorch's pinned-memory allocator records the copy's stream and
    reuses the block only after it. int32 arrays (multiclass labels)
    become int64, the dtype ``cross_entropy`` takes. On the CPU the
    arrays are wrapped without a copy.
    """
    device = torch.device(device)

    def to_tensor(a):
        a = np.asarray(a)
        if a.dtype == np.int32:
            a = a.astype(np.int64)
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type != "cuda":
            return t.to(device)
        return t.pin_memory().to(device, non_blocking=True)

    def place(batch):
        return tuple(to_tensor(a) for a in batch)

    return place


def make_packed_collate(target_len: Optional[int], multiclass: bool):
    """Collate for PackedDataset items — each item is a whole shard
    (waves_list, labels_list); deflate shards into one flat batch
    (reference: packed_collate_fn_raw_*, packed_dataset.py:163-176)."""

    def collate(items):
        waves, labels = deflate_packed_batch(items)
        return collate_fixed(list(zip(waves, labels)), target_len,
                             multiclass)

    return collate


def setup_dataloaders(train_set, val_set, batch_size: int,
                      device_world_size: int = 1, local_rank: int = 0,
                      target_len: Optional[int] = None,
                      val_target_len: Optional[int] = None,
                      multiclass: bool = True,
                      num_workers: int = 4,
                      multi_device_val: bool = False,
                      need_val: bool = True,
                      packed: bool = False,
                      seed: int = 0) -> Tuple[DataLoader, Optional[DataLoader]]:
    """Reference training_utils.py:6-36 equivalent: shard train across
    processes; shard val only if multi_device_val. With ``packed=True``
    batch_size counts SHARDS per batch (reference packed semantics),
    ``drop_last`` drops shards, and shards deflate into the flat batch, so
    a short shard (or a record that does not decode) makes a smaller
    batch."""
    tr_collate = (make_packed_collate(target_len, multiclass)
                  if packed else None)
    val_collate = (make_packed_collate(val_target_len or target_len,
                                       multiclass) if packed else None)
    train_sampler = ShardedSampler(len(train_set), device_world_size,
                                   local_rank, shuffle=True, seed=seed)
    train_loader = DataLoader(train_set, batch_size, sampler=train_sampler,
                              target_len=target_len, multiclass=multiclass,
                              collate_fn=tr_collate,
                              num_workers=num_workers, drop_last=True)
    val_loader = None
    if need_val and val_set is not None:
        if multi_device_val:
            val_sampler = ShardedSampler(len(val_set), device_world_size,
                                         local_rank, shuffle=False)
        else:
            val_sampler = ShardedSampler(len(val_set), shuffle=False)
        val_loader = DataLoader(val_set, batch_size, sampler=val_sampler,
                                target_len=val_target_len or target_len,
                                multiclass=multiclass,
                                collate_fn=val_collate,
                                num_workers=num_workers)
    return train_loader, val_loader
