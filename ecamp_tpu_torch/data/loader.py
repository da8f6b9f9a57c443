"""Host-side data loader (counterpart of `ecamp_tpu/data/loader.py`): K
workers fetch and augment samples while the device computes, and the
consumer yields stacked numpy batches in order.

With `shuffle` (training) each epoch is a seeded permutation
(`default_rng(seed + epoch)`), else the identity order (evaluation); with
`drop_last` the last partial batch is dropped, else it is yielded ragged.

The workers are threads (`num_workers`, the default) or, with
`mp_workers = K > 0`, processes started from `mp_context` ("spawn" by
default; "fork" is allowed, with fork's risk of a child that inherits a
lock held by one of the parent's threads). Both modes keep one contract:

* Worker w of K builds batches w, w+K, ... from its own copy of the
  dataset (a shallow copy in a thread, the unpickled dataset in a
  process), reseeded through the dataset's `reseed(epoch, w)`. So every
  batch is a pure function of (seed, epoch, K, batch index): the same run
  to run, across a resume, and in either mode at equal K.
* Each worker puts its batches, in order, on a queue of its own that
  holds QUEUE_SIZE, and the consumer takes batch i from the queue of
  worker i % K. A worker that runs ahead blocks on its own full queue, so
  at most K * QUEUE_SIZE batches wait in the queues and one more in each
  worker's hands, however slow one worker is.
* A worker's exception is raised in the consumer when its batch is due,
  after every earlier batch, as RuntimeError("DataLoader worker failed
  ..."); a process ships it as its formatted traceback. A worker process
  that dies without a word (killed, or failing to start) is raised too:
  the parent keeps no copy of a queue's write end, so the dead worker's
  queue reads as closed at once.
* An abandoned iterator stops its workers: threads are told to stop and
  joined, processes are terminated (killed if that does not end them) and
  joined.

A process worker imports this module and the dataset's, which need numpy
and PIL only: it never imports torch or touches CUDA. (Under spawn,
Python also runs the parent's main module's imports in the child, as it
does for any spawned process; `python -m` of a module that imports torch
makes each worker import torch.)

A process worker collates each batch straight into a file of its own on
the RAM-backed SHM_DIR and puts only the file's name and layout on its
queue; the consumer maps the file, removes its name and yields arrays on
the mapping, which lives as long as they do. A B = 32 batch of fp32 448²
images is 77 MB (of `output_u8` images 6.4 MB): through the queue's pipe,
pickled, it would cost the consumer two copies and the pipe's many small
transfers, where the mapping costs none. Where SHM_DIR is missing or too
full for a batch (Docker's default /dev/shm of 64 MB holds no fp32 B = 32
batch), the iterator raises a RuntimeError that names SHM_DIR, its free
bytes and the batch's. The files, the pickled dataset's too, are the
user's alone (mode 0600). The iterator's end removes the files of batches
made and not taken; a consumer killed outright leaves them, named
`ecamp-loader-<pid>-*`.

Under data parallelism each rank reads its own shard of the epoch's order
(`process_index` of `process_count`, DistributedSampler semantics, as the
JAX package's loader): the order is padded by wrapping round to a multiple
of the ranks, so every rank sees ceil(n / ranks) samples and the same
number of batches, and rank r takes every ranks-th sample from r on.
"""

from __future__ import annotations

import copy
import glob
import mmap
import os
import pickle
import queue
import secrets
import shutil
import threading
import traceback
from typing import Dict, Iterator

import numpy as np


def default_collate(samples) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


QUEUE_SIZE = 2  # batches a worker may have waiting for the consumer
POLL_S = 0.5    # how often a consumer waiting on a process checks it lives
SHM_DIR = "/dev/shm"  # where a worker process leaves its batches' arrays
ALIGN = 64      # bytes: each array's offset in a batch's file
# a batch's mapping, its pages mapped in one call, not faulted in one by
# one (dear where the host is virtualised)
MAP_FLAGS = mmap.MAP_SHARED | mmap.MAP_POPULATE


def _shm_error(what: str, size: int, err: OSError) -> RuntimeError:
    try:
        free = f"{shutil.disk_usage(SHM_DIR).free:,} bytes free"
    except OSError:
        free = "missing"
    return RuntimeError(
        f"DataLoader: no room for {what} of {size:,} bytes in SHM_DIR "
        f"{SHM_DIR} ({free}: {err}); worker processes hand batches over "
        f"through it: enlarge it (docker run --shm-size) or use threads "
        f"(mp_workers=0)")


def _to_shm(samples, path: str):
    """Collate `samples` into a new file `path` on SHM_DIR, each key's
    stacked array at its offset; returns the (key, shape, dtype, offset)
    specs. Raises where SHM_DIR is missing or has no room."""
    cols = {k: [np.asarray(s[k]) for s in samples] for k in samples[0]}
    specs, size = [], 0
    for k, arrays in cols.items():
        dtype = np.result_type(*arrays)
        shape = (len(arrays),) + arrays[0].shape
        specs.append((k, shape, dtype.str, size))
        size += -(-int(np.prod(shape)) * dtype.itemsize // ALIGN) * ALIGN
    size = max(size, 1)
    try:
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
    except OSError as e:
        raise _shm_error("a batch", size, e) from e
    try:
        try:  # reserve the pages now: a full tmpfs would raise SIGBUS later
            os.posix_fallocate(fd, 0, size)
        except OSError as e:
            os.unlink(path)
            raise _shm_error("a batch", size, e) from e
        with mmap.mmap(fd, size, flags=MAP_FLAGS) as m:
            for k, shape, dtype, offset in specs:
                np.stack(cols[k], out=np.ndarray(shape, dtype, buffer=m,
                                                 offset=offset))
    finally:
        os.close(fd)
    return specs


def _from_shm(path: str, specs) -> Dict[str, np.ndarray]:
    """The batch a worker left in `path`, as arrays on one shared mapping
    of it (no copy); the file's name is removed at once, and the mapping
    goes with the last of the arrays."""
    fd = os.open(path, os.O_RDWR)
    try:
        m = mmap.mmap(fd, os.fstat(fd).st_size, flags=MAP_FLAGS)
    finally:
        os.close(fd)
        os.unlink(path)
    return {k: np.ndarray(shape, dtype, buffer=m, offset=offset)
            for k, shape, dtype, offset in specs}


def _mp_worker(job: str, wid: int, K: int, epoch: int, out,
               shm_prefix: str) -> None:
    """A worker process's body. `job` is the path of the file that holds
    the pickled (dataset, batches); the worker builds batches wid, wid + K,
    ... and puts each on its queue `out` as its file `shm_prefix + <n>`
    and the file's specs (see `_to_shm`); a failure as its traceback, in
    the place of the batch it was building."""
    try:
        with open(job, "rb") as f:
            dataset, batches = pickle.load(f)
        if hasattr(dataset, "reseed"):
            dataset.reseed(epoch, wid)
        for n, idx in enumerate(batches[wid::K]):
            path = f"{shm_prefix}{n}"
            out.put((path, _to_shm([dataset[i] for i in idx], path)))
    except BaseException:  # noqa: BLE001 - raised by the consumer
        out.put(traceback.format_exc())


def _take(q, proc):
    """The next item of a worker process's queue; None once the process is
    gone with nothing more sent."""
    while True:
        try:
            return q.get(timeout=POLL_S)
        except queue.Empty:
            if proc.is_alive():
                continue
            try:  # what it sent just before it ended
                return q.get(timeout=POLL_S)
            except queue.Empty:
                return None
        except (EOFError, OSError):  # its write end closed, or mid-batch
            return None


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, num_workers: int = 8,
                 drop_last: bool = True, process_index: int = 0,
                 process_count: int = 1, mp_workers: int = 0,
                 mp_context: str = "spawn"):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = process_count
        self.mp_workers = max(0, mp_workers)
        self.mp_context = mp_context
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        n = -(-len(self.dataset) // self.process_count)  # the padded shard
        b = self.batch_size
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
            idx = np.random.default_rng(self.seed + self.epoch).permutation(n)
        else:
            idx = np.arange(n)
        if self.process_count > 1:
            total = -(-n // self.process_count) * self.process_count
            if total > n:  # wrap round so every rank has as many samples
                idx = np.concatenate([idx, idx[:total - n]])
            idx = idx[self.process_index::self.process_count]
        return idx

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        idx = self._indices()
        batches = [idx[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(len(self))]
        if not batches:
            return
        if self.mp_workers > 0:
            yield from self._iter_processes(batches)
        else:
            yield from self._iter_threads(batches)

    def _iter_threads(self, batches) -> Iterator[Dict[str, np.ndarray]]:
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

    def _iter_processes(self, batches) -> Iterator[Dict[str, np.ndarray]]:
        import multiprocessing as mp

        ctx = mp.get_context(self.mp_context)
        K = self.mp_workers
        # this iterator's files: SHM_DIR/ecamp-loader-<pid>-<tag>-job, the
        # pickled dataset and batches that each worker reads, and -<w>-<n>,
        # worker w's n-th batch
        prefix = os.path.join(SHM_DIR, f"ecamp-loader-{os.getpid()}-"
                              f"{secrets.token_hex(4)}-")
        job = f"{prefix}job"
        queues, procs = [], []
        try:
            # pickled once, not K times, and into a file: a start's
            # arguments past the pipe's 64 KiB would hold the parent until
            # that child had imported and read them
            data = pickle.dumps((self.dataset, batches))
            try:
                with os.fdopen(os.open(job, os.O_CREAT | os.O_EXCL
                                       | os.O_WRONLY, 0o600), "wb") as f:
                    f.write(data)
            except OSError as e:
                raise _shm_error("the pickled dataset", len(data), e) from e
            del data
            for w in range(K):
                q = ctx.Queue(maxsize=QUEUE_SIZE)
                p = ctx.Process(
                    target=_mp_worker, name=f"DataLoader-{w}", daemon=True,
                    args=(job, w, K, self.epoch, q, f"{prefix}{w}-"))
                p.start()
                queues.append(q)
                procs.append(p)
                # the child holds the only write end, so its death reads as
                # the pipe's end (as multiprocessing.Pool uses `_writer`)
                q._writer.close()
            for nxt in range(len(batches)):
                w = nxt % K
                item = _take(queues[w], procs[w])
                if item is None:
                    procs[w].join(timeout=POLL_S)
                    raise RuntimeError(
                        f"DataLoader worker process {w} ended (exit code "
                        f"{procs[w].exitcode}) before batch {nxt} of "
                        f"{len(batches)}")
                if isinstance(item, str):
                    raise RuntimeError(f"DataLoader worker failed on batch "
                                       f"{nxt}, in process {w}:\n{item}")
                yield _from_shm(*item)
        finally:
            for p in procs:
                p.terminate()
            for p in procs:
                p.join(timeout=5)
                if p.exitcode is None:  # a handler kept SIGTERM from it
                    p.kill()
                    p.join()
            for q in queues:
                q.cancel_join_thread()
                q.close()
            # the job, and the batches made and not taken
            for path in glob.glob(glob.escape(prefix) + "*"):
                os.unlink(path)
