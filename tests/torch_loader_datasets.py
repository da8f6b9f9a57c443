"""Datasets for the loader's worker-process tests
(`tests/test_torch_loader_processes.py`). A spawned worker unpickles its
dataset and so imports this module: it imports numpy and the standard
library only, so that a child pays no torch or JAX import."""

import os
import sys
import time

import numpy as np


class Numbers:
    """Sample i is {"x": [i, draw]}, the draw from a stream reseeded per
    (epoch, worker), as the datasets' `reseed` protocol does.

    `slow`: seconds worker `slow_worker` sleeps a sample (every worker's
    when `slow_worker` is None). `fail_at`: the index that raises
    ValueError("boom<i>"). `log`: a file that gets one line a sample
    fetched, from any process. `probe`: add whether the fetching process
    has imported torch or jax."""

    def __init__(self, n, slow=0.0, slow_worker=0, fail_at=None, log=None,
                 probe=False):
        self.n = n
        self.slow = slow
        self.slow_worker = slow_worker
        self.fail_at = fail_at
        self.log = log
        self.probe = probe
        self.wid = None
        self.rng = np.random.default_rng(0)

    def reseed(self, epoch, worker_id):
        self.wid = worker_id
        self.rng = np.random.default_rng(1000 * epoch + worker_id)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if self.slow and self.slow_worker in (None, self.wid):
            time.sleep(self.slow)
        if i == self.fail_at:
            raise ValueError(f"boom{i}")
        if self.log is not None:
            with open(self.log, "a") as f:
                f.write(f"{i}\n")
        out = {"x": np.array([i, self.rng.integers(1 << 30)], np.int64)}
        if self.probe:
            out["imported"] = np.array(["torch" in sys.modules,
                                        "jax" in sys.modules, os.getpid()],
                                       np.int64)
        return out
