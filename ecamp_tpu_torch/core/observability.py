"""TensorBoard scalars and profiler hooks (counterpart of
`ecamp_tpu/core/observability.py`; reference main_pretrain.py:212).

`SummaryWriter` writes through `torch.utils.tensorboard` where its
`tensorboard` package imports, and is silently a no-op elsewhere (the
run's `log.txt` holds the same numbers), as the JAX package's degrades
without tensorflow. `device_trace` records a `torch.profiler` trace of
its body into a directory, `annotate` names a region of that trace.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator


class SummaryWriter:
    """TensorBoard scalar writer; writes nothing, and makes no directory,
    where `torch.utils.tensorboard` does not import or `enabled` is
    false."""

    def __init__(self, log_dir: str, enabled: bool = True):
        self._writer = None
        self.log_dir = log_dir
        if not enabled:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter as _Writer

            self._writer = _Writer(log_dir)
        except Exception:
            self._writer = None

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._writer is not None:
            self._writer.add_scalar(tag, float(value), global_step=int(step))

    def flush(self) -> None:
        if self._writer is not None:
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None


@contextlib.contextmanager
def device_trace(log_dir: str, enabled: bool = True) -> Iterator[None]:
    """A `torch.profiler` trace of the body (host ops, and the card's
    kernels where CUDA is available) written into `log_dir` as a Chrome
    trace that TensorBoard's profiler plugin reads; a no-op when disabled
    or when the profiler does not start."""
    if not enabled:
        yield
        return
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    # only a failure to START the profiler is swallowed; an exception the
    # body raises must propagate (a catch-all around the yield would turn
    # it into RuntimeError("generator didn't stop after throw()"))
    prof = None
    try:
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(log_dir, exist_ok=True)
        prof = profile(activities=activities,
                       on_trace_ready=tensorboard_trace_handler(log_dir))
        prof.start()
    except Exception:
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.stop()
            except Exception:
                pass


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region in the profiler's timeline."""
    import torch

    with torch.profiler.record_function(name):
        yield
