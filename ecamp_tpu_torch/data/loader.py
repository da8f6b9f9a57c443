"""Host-side data loader (counterpart of `ecamp_tpu/data/loader.py`, thread
mode): a thread pool fetches and augments samples while the device
computes, and yields stacked numpy batches in order.

With `shuffle` (training) each epoch is a seeded permutation
(`default_rng(seed + epoch)`), else the identity order (evaluation); with
`drop_last` the last partial batch is dropped, else it is yielded ragged.
Worker w of K builds batches w, w+K, ... from its own shallow copy of the
dataset, reseeded through the dataset's `reseed(epoch, w)`, so every batch
is a pure function of (seed, epoch, K, batch index): the same run to run,
and across a resume.

Each worker puts its batches, in order, on a queue of its own that holds
two, and the consumer takes batch i from the queue of worker i % K. A
worker that runs ahead blocks on its own full queue, so at most K * 2
batches wait in the queues and one more in each worker's hands, however
slow one worker is. One process only: the JAX package's multi-process
sharding and worker processes are not ported.
"""

from __future__ import annotations

import copy
import queue
import threading
from typing import Dict, Iterator

import numpy as np


def default_collate(samples) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


QUEUE_SIZE = 2  # batches a worker may have waiting for the consumer


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, num_workers: int = 8,
                 drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n, b = len(self.dataset), self.batch_size
        return n // b if self.drop_last else -(-n // b)

    def _worker_dataset(self, wid: int):
        """A shallow copy (the image lists and tokenizer stay shared) whose
        RNG streams, the dataset's and its transform's, are this (epoch,
        worker)'s."""
        d = copy.copy(self.dataset)
        if getattr(d, "transform", None) is not None:
            d.transform = copy.copy(d.transform)
        if hasattr(d, "reseed"):
            d.reseed(self.epoch, wid)
        return d

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            return np.random.default_rng(self.seed + self.epoch).permutation(n)
        return np.arange(n)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = self._indices()
        batches = [idx[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(len(self))]
        if not batches:
            return
        K = self.num_workers
        queues = [queue.Queue(maxsize=QUEUE_SIZE) for _ in range(K)]
        stop = threading.Event()

        def put(q, item) -> bool:
            # a bounded put that keeps checking `stop`, so an abandoned
            # iterator leaves no thread parked in q.put
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def work(wid: int) -> None:
            q = queues[wid]
            try:
                ds = self._worker_dataset(wid)
                for bi in range(wid, len(batches), K):
                    if not put(q, default_collate([ds[i]
                                                   for i in batches[bi]])):
                        return
            except BaseException as e:  # noqa: BLE001 - raised below
                put(q, e)

        threads = [threading.Thread(target=work, args=(w,), daemon=True)
                   for w in range(K)]
        for t in threads:
            t.start()
        try:
            for nxt in range(len(batches)):
                batch = queues[nxt % K].get()
                if isinstance(batch, BaseException):
                    raise RuntimeError("DataLoader worker failed") from batch
                yield batch
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=5)
