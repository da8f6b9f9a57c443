"""Host-side data loader (counterpart of `ecamp_tpu/data/loader.py`, thread
mode): a thread pool fetches and augments samples while the device
computes, and yields stacked numpy batches in order.

Each epoch is a seeded permutation (`default_rng(seed + epoch)`) cut to
whole batches, the last partial one dropped. Worker w of K builds batches
w, w+K, ... from its own shallow copy of the dataset, reseeded through the
dataset's `reseed(epoch, w)`, so every batch is a pure function of (seed,
epoch, K, batch index): the same run to run, and across a resume. One
process only: the JAX package's multi-process sharding, worker processes
and unshuffled or ragged-batch modes are not ported.
"""

from __future__ import annotations

import copy
import queue
import threading
from typing import Dict, Iterator

import numpy as np


def default_collate(samples) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class DataLoader:
    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 num_workers: int = 8):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

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

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = np.random.default_rng(self.seed + self.epoch).permutation(
            len(self.dataset))
        batches = [idx[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(len(self))]
        if not batches:
            return
        K = self.num_workers
        out_q: "queue.Queue" = queue.Queue(maxsize=2)
        stop = threading.Event()

        def put(item) -> bool:
            # a bounded put that keeps checking `stop`, so an abandoned
            # iterator leaves no thread parked in q.put
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def work(wid: int) -> None:
            try:
                ds = self._worker_dataset(wid)
                for bi in range(wid, len(batches), K):
                    if not put((bi, default_collate([ds[i]
                                                     for i in batches[bi]]))):
                        return
                put((-1, None))
            except BaseException as e:  # noqa: BLE001 - raised below
                put((-2, e))

        threads = [threading.Thread(target=work, args=(w,), daemon=True)
                   for w in range(K)]
        for t in threads:
            t.start()
        try:
            buffered: Dict[int, Dict[str, np.ndarray]] = {}
            nxt, done = 0, 0
            while nxt < len(batches):
                if nxt in buffered:
                    yield buffered.pop(nxt)
                    nxt += 1
                    continue
                if done == K:
                    raise RuntimeError(
                        f"DataLoader workers exited early: batch {nxt} of "
                        f"{len(batches)} never arrived")
                tag, payload = out_q.get()
                if tag == -1:
                    done += 1
                elif tag == -2:
                    raise RuntimeError("DataLoader worker failed") from payload
                else:
                    buffered[tag] = payload
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=5)
