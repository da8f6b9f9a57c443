"""Batched, bucketed inference engine on one device (counterpart of
`ecamp_tpu/serve/engine.py`).

The engine pads every request batch up to a fixed *bucket* size (smallest
bucket that covers it; oversize requests are chunked by the largest
bucket). PyTorch runs eagerly and compiles nothing per shape, but fixed
buckets keep the set of shapes that reach the kernels small and known, so
`warmup()` can build and autotune them all before traffic arrives. It
keeps per-call latency stats (p50/p99) for observability.

`MicroBatcher` adds dynamic batching on top: concurrent `submit()` calls
are coalesced into one device call (bounded by `max_batch` and
`max_wait_ms`).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Callable, Optional, Sequence

import numpy as np
import torch


class InferenceEngine:
    """Wraps `apply_fn(x: Tensor) -> Tensor` for serving.

    apply_fn takes a batch on `device` in `input_dtype` and returns a
    tensor with the batch as its leading dim (sliced back to the true
    request size before the host copy).
    """

    def __init__(self, apply_fn: Callable[[torch.Tensor], torch.Tensor],
                 buckets: Sequence[int] = (8, 32, 64),
                 postprocess: Optional[Callable] = None,
                 input_dtype: Optional[torch.dtype] = None,
                 device="cuda"):
        self.device = torch.device(device)
        self.buckets = sorted(set(int(b) for b in buckets))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive, got {buckets}")
        self._fn = apply_fn
        self.postprocess = postprocess
        # the host copy stays fp32; the cast to the compute dtype happens
        # on the device (bit-identical: the model's first op casts too)
        self.input_dtype = input_dtype
        self._lat_ms: list = []
        self._count = 0
        self._bucket_hits = {b: 0 for b in self.buckets}
        self._lock = threading.Lock()

    # -- shape management ------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def warmup(self, example: np.ndarray) -> None:
        """Run every bucket once up front (kernel builds, Triton autotune
        and library handles off the request path)."""
        for b in self.buckets:
            x = np.broadcast_to(example[:1], (b,) + example.shape[1:])
            self._run_padded(np.ascontiguousarray(x), b)

    def _run_padded(self, x: np.ndarray, m: int) -> np.ndarray:
        """Run one padded bucket; return the first m rows on the host."""
        xt = torch.as_tensor(x, device=self.device)
        if self.input_dtype is not None:
            xt = xt.to(self.input_dtype)
        with torch.inference_mode():
            out = self._fn(xt)
            # slice the padding off ON DEVICE before the host copy
            return out[:m].cpu().numpy()

    # -- public API ------------------------------------------------------

    def __call__(self, x: np.ndarray):
        """Run a request batch of any size; returns outputs of the same
        leading size, bucketing/chunking internally."""
        t0 = time.perf_counter()
        n = x.shape[0]
        outs = []
        big = self.buckets[-1]
        if n == 0:
            # run the smallest bucket on zeros and slice to 0 so empty
            # requests return correctly-typed empty outputs
            b = self.buckets[0]
            outs.append(self._run_padded(
                np.zeros((b,) + x.shape[1:], x.dtype), 0))
        i = 0
        while i < n:
            chunk = x[i:i + big]
            m = chunk.shape[0]
            b = self._bucket_for(m)
            with self._lock:
                self._bucket_hits[b] += 1
            if m < b:
                pad = np.broadcast_to(chunk[-1:], (b - m,) + chunk.shape[1:])
                chunk = np.concatenate([chunk, pad])
            outs.append(self._run_padded(chunk, m))
            i += m
        result = outs[0] if len(outs) == 1 else np.concatenate(outs)
        with self._lock:
            self._lat_ms.append((time.perf_counter() - t0) * 1e3)
            if len(self._lat_ms) > 1000:
                self._lat_ms = self._lat_ms[-1000:]
            self._count += n
        if self.postprocess is not None:
            result = self.postprocess(result)
        return result

    def stats(self) -> dict:
        with self._lock:
            lat = np.asarray(self._lat_ms) if self._lat_ms else np.zeros(1)
            return {
                "requests": self._count,
                "calls": len(self._lat_ms),
                "latency_ms_p50": float(np.percentile(lat, 50)),
                "latency_ms_p99": float(np.percentile(lat, 99)),
                "buckets": list(self.buckets),
                "bucket_hits": {str(b): n
                                for b, n in self._bucket_hits.items()},
            }


class MicroBatcher:
    """Dynamic batching: coalesce concurrent single requests into one
    device call. submit() returns a Future resolved with that sample's
    output row."""

    def __init__(self, engine: InferenceEngine, max_batch: int = 32,
                 max_wait_ms: float = 5.0):
        self.engine = engine
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self._queue: list = []
        self._cv = threading.Condition()
        self._closed = False
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def submit(self, x: np.ndarray) -> Future:
        """x: one sample (no batch dim)."""
        fut: Future = Future()
        with self._cv:
            if self._closed:
                raise RuntimeError("MicroBatcher closed")
            self._queue.append((x, fut))
            self._cv.notify()
        return fut

    def _loop(self):
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if self._closed and not self._queue:
                    return
                deadline = time.monotonic() + self.max_wait
                while (len(self._queue) < self.max_batch
                       and not self._closed):
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._cv.wait(timeout=left)
                batch = self._queue[:self.max_batch]
                self._queue = self._queue[self.max_batch:]
            # np.stack stays inside the try: one mis-shaped sample must
            # fail its own batch's futures, not kill the batching thread
            try:
                out = self.engine(np.stack([b[0] for b in batch]))
                for i, (_, fut) in enumerate(batch):
                    fut.set_result(out[i])
            except Exception as e:
                for _, fut in batch:
                    fut.set_exception(e)

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._worker.join(timeout=5)


def softmax_np(x: np.ndarray, axis: int = -1) -> np.ndarray:
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def sigmoid_np(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))
