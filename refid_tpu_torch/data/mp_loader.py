"""Multi-process prefetch loader (mirrors ``refid_tpu/data/mp_loader.py``),
selected by ``prefetch_mode: process``.

The JAX loader's workers build whole samples.  Here a sample is split in
two (``data/datasets/base.py``): the datasets voxelize with the CUDA
kernel K2 on the card, and a worker process would need a CUDA context of
its own for that.  So:

  * spawned worker processes run the host part of each item,
    ``dataset.load(index, draws)``: its paths, the PNG decodes (uint8,
    already cut to the item's crop) and the event arrays; they never touch
    the card and never voxelize;
  * this process draws each item's random decisions in sampler order
    (``dataset.draw``) before it dispatches the item, and a pool of
    ``num_workers`` threads runs the device part, ``dataset.finish``: K2 on
    each thread's own CUDA stream (as ``PrefetchLoader``'s threads do),
    then the crop of the grids, the flips and the packing.

The dataset must have ``draw`` / ``load`` / ``finish`` (every dataset of
the package does).  The batches equal the thread loader's for the same
sampler and seed.  Dispatch is windowed (at most ``prefetch_batches + 1``
batches of items in flight) and the process pool lives across epochs, as
in the JAX loader; ``close`` (or interpreter exit) ends it.

Spawned workers import ``__main__`` again: the script that builds this
loader must guard its entry point (``python -m refid_tpu_torch.cli.*``
does).
"""

from __future__ import annotations

import atexit
import contextlib
import multiprocessing as mp
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from refid_tpu_torch.data.loader import EnlargedIndexSampler, PrefetchLoader

__all__ = ["ProcessPrefetchLoader"]

_WORKER_DATASET = None


def _init_worker(dataset):
    """Pool initializer: each spawned worker holds one copy of the dataset."""
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _load(index, draws):
    return _WORKER_DATASET.load(index, draws)


class ProcessPrefetchLoader(PrefetchLoader):
    """``PrefetchLoader``'s contract (``set_epoch``, ``__len__``,
    ``__iter__`` of collated numpy batches) with worker-process loading.
    The dataset must pickle (the port's datasets do: option dicts, path
    lists and a ``random.Random``)."""

    def __init__(self, dataset, batch_size: int = 1,
                 sampler: Optional[EnlargedIndexSampler] = None,
                 num_workers: int = 2, prefetch_batches: int = 2,
                 drop_last: bool = True):
        if not all(hasattr(dataset, k) for k in ("draw", "load", "finish")):
            raise TypeError(f"{type(dataset).__name__} has no draw / load / finish: "
                            "the process loader runs load in its workers")
        super().__init__(dataset, batch_size, sampler, num_workers, prefetch_batches,
                         drop_last)
        self._pool = None
        atexit.register(self.close)

    @contextlib.contextmanager
    def _executor(self):
        if self._pool is None:
            ctx = mp.get_context("spawn")
            self._pool = ctx.Pool(self.num_workers, initializer=_init_worker,
                                  initargs=(self.dataset,))
        with ThreadPoolExecutor(self.num_workers, initializer=self._init_worker) as threads:
            yield threads

    def _submit(self, threads, index: int):
        ds = self.dataset
        host = self._pool.apply_async(_load, (index, ds.draw(index)))
        return threads.submit(lambda: ds.finish(host.get()))

    def close(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None
