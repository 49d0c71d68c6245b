"""Host-side data loading: enlarged sampler and threaded prefetch loader
(mirrors ``refid_tpu/data/loader.py``).

  * ``EnlargedIndexSampler`` — epoch-seeded permutation over a ``ratio``-fold
    enlarged dataset, sliced by shard (one process here: one shard).
  * ``PrefetchLoader`` — a pool of threads loads samples ahead of the
    training loop and collates numpy batches; the task moves them to the
    card.  Threads, not processes: they share the CUDA context, so the
    voxelizer kernel runs from them (a worker process forked after CUDA is
    initialised cannot use the card).  For a dataset on a CUDA device each
    loader thread works on a stream of its own, so its kernel and copies do
    not queue behind the training step's work on the default stream.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np
import torch

from refid_tpu_torch.core.registry import DATASETS

__all__ = ["build_dataset", "build_loader", "EnlargedIndexSampler",
           "PrefetchLoader", "collate"]


def build_dataset(dataset_opt: dict, device="cuda"):
    from refid_tpu_torch.data.datasets import (  # noqa: F401 (registers)
        gopro_recurrent, gopro_sharp, highrev, single_image,
    )
    cls = DATASETS.get(dataset_opt["type"])
    return cls(dataset_opt, device=device)


class EnlargedIndexSampler:
    """Epoch-seeded shuffled indices over the dataset enlarged
    ``ratio``-fold; shard ``k`` of ``num_shards`` takes every
    ``num_shards``-th index, as the reference's sampler does."""

    def __init__(self, num_samples: int, ratio: int = 1, shuffle: bool = True,
                 num_shards: int = 1, shard_index: int = 0, seed: int = 0):
        self.num_samples = num_samples
        self.total = int(num_samples * max(ratio, 1))
        self.shuffle = shuffle
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.seed = seed

    def epoch_indices(self, epoch: int) -> np.ndarray:
        if self.shuffle:
            rng = np.random.RandomState(self.seed + epoch)
            idx = rng.permutation(self.total) % self.num_samples
        else:
            idx = np.arange(self.total) % self.num_samples
        per = self.total // self.num_shards
        return idx[:per * self.num_shards][self.shard_index::self.num_shards]


def collate(samples: list) -> dict:
    """Stack numeric fields into a batch dim; other fields -> lists."""
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals, axis=0)
        else:
            out[key] = vals
    return out


class PrefetchLoader:
    """Iterate batches, with samples loaded by a pool of threads.  Up to
    ``prefetch_batches`` batches are in flight beyond the one being
    consumed, so a batch of one sample still keeps several threads busy;
    batches come out in sampler order.  The threads use the device of the
    dataset (its ``device`` attribute, the CPU without one)."""

    def __init__(self, dataset, batch_size: int = 1,
                 sampler: Optional[EnlargedIndexSampler] = None,
                 num_workers: int = 2, prefetch_batches: int = 2,
                 drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler or EnlargedIndexSampler(len(dataset), 1,
                                                       shuffle=False)
        self.num_workers = max(1, num_workers)
        self.prefetch_batches = max(1, prefetch_batches)
        self.drop_last = drop_last
        self.device = torch.device(getattr(dataset, "device", "cpu"))
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        n = len(self.sampler.epoch_indices(0))
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size

    def _init_worker(self):
        if self.device.type == "cuda":
            torch.cuda.set_stream(torch.cuda.Stream(self.device))

    def __iter__(self) -> Iterator[dict]:
        indices = self.sampler.epoch_indices(self.epoch)
        batches = [indices[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(len(self))]

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()
        failure = []

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers,
                                        initializer=self._init_worker) as pool:
                    pending = collections.deque()
                    for batch_idx in batches:
                        if stop.is_set():
                            return
                        pending.append([pool.submit(self.dataset.__getitem__, int(i))
                                        for i in batch_idx])
                        if len(pending) > self.prefetch_batches:
                            q.put(collate([f.result() for f in pending.popleft()]))
                    while pending and not stop.is_set():
                        q.put(collate([f.result() for f in pending.popleft()]))
            except Exception as exc:   # surfaced in the consumer
                failure.append(exc)
            finally:
                q.put(None)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    if failure:
                        raise failure[0]
                    return
                yield item
        finally:
            stop.set()
            while thread.is_alive():     # unblock a producer waiting on a full queue
                try:
                    q.get_nowait()
                except queue.Empty:
                    thread.join(0.01)


def build_loader(dataset, dataset_opt: dict, is_train: bool,
                 seed: int = 0) -> PrefetchLoader:
    """Build from a reference-style dataset option dict: train uses
    ``batch_size_per_gpu`` (one card), an enlarged shuffled sampler and
    ``num_worker_per_gpu`` threads; val / test use batch 1 in order."""
    if is_train:
        if dataset_opt.get("prefetch_mode") == "process":
            raise NotImplementedError(
                "prefetch_mode: process (worker processes, refid_tpu/data/"
                "mp_loader.py) is not ported yet; the thread loader serves")
        sampler = EnlargedIndexSampler(
            len(dataset), dataset_opt.get("dataset_enlarge_ratio", 1),
            shuffle=dataset_opt.get("use_shuffle", True), seed=seed)
        return PrefetchLoader(
            dataset, dataset_opt.get("batch_size_per_gpu", 1), sampler,
            dataset_opt.get("num_worker_per_gpu", 2),
            prefetch_batches=dataset_opt.get("num_prefetch_queue", 2),
            drop_last=True)
    sampler = EnlargedIndexSampler(len(dataset), 1, shuffle=False)
    return PrefetchLoader(dataset, 1, sampler, num_workers=1,
                          prefetch_batches=1, drop_last=False)
