"""Host-side training metrics (counterpart of `ecamp_tpu/core/metrics.py`;
reference MetricLogger / SmoothedValue, util/misc.py:24-167), each
process's own: a data-parallel step hands over its metrics already
averaged over the ranks, and rank 0 alone writes the run log."""

from __future__ import annotations

import json
import time
from collections import defaultdict, deque
from typing import Dict, Iterable

import numpy as np
import torch


class SmoothedValue:
    """Windowed and global average meter (reference util/misc.py:24-83)."""

    def __init__(self, window_size: int = 20,
                 fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value, n: int = 1) -> None:
        value = float(value)
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return max(self.deque) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(median=self.median, avg=self.avg,
                               global_avg=self.global_avg, max=self.max,
                               value=self.value)


def device_memory_mb() -> float:
    """Peak device memory allocated on the current CUDA card since the last
    `torch.cuda.reset_peak_memory_stats`, in MiB
    (`torch.cuda.max_memory_allocated`, what the reference prints at
    util/misc.py:156); 0.0 without a card."""
    if not torch.cuda.is_available():
        return 0.0
    return torch.cuda.max_memory_allocated() / (1024.0 * 1024.0)


class MetricLogger:
    """Iteration logger with iteration and data timing (reference
    util/misc.py:86-167)."""

    delimiter = "  "

    def __init__(self):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __str__(self) -> str:
        return self.delimiter.join(f"{name}: {meter}"
                                   for name, meter in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int,
                  header: str = ""):
        i = 0
        start = end = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        data_time = SmoothedValue(fmt="{avg:.4f}")
        try:
            total = len(iterable)  # type: ignore[arg-type]
        except TypeError:
            total = None
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0 or (total is not None and i == total - 1):
                msg = [header, f"[{i}" + (f"/{total}]" if total else "]"),
                       str(self), f"time: {iter_time}", f"data: {data_time}"]
                mem = device_memory_mb()
                if mem > 0:
                    msg.append(f"max mem: {mem:.0f}")
                print(self.delimiter.join(m for m in msg if m))
            i += 1
            end = time.time()
        total_time = time.time() - start
        print(f"{header} Total time: {total_time:.1f}s "
              f"({total_time / max(i, 1):.4f} s/it)")


class JsonlLogger:
    """Append-only JSON-lines run log (reference main_pretrain.py:297-304);
    a disabled one (every rank but 0 of a data-parallel run) writes
    nothing."""

    def __init__(self, path: str, enabled: bool = True):
        self.path = path
        self.enabled = enabled

    def write(self, record: dict) -> None:
        if not self.enabled:
            return
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(json.dumps(record) + "\n")
