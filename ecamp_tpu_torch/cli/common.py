"""Shared CLI plumbing (counterpart of `ecamp_tpu/cli/common.py:14-97,
157-251, 307-426`): common arguments, the run directory's provenance,
checkpoint cadence, early stopping, the fine-tune CLIs' ranks, sharded
evaluation and preemption.

The JAX package's `pad_eval_batch` has no counterpart: XLA compiles one
program per input shape, so JAX pads the ragged last eval batch to the
static shape, while PyTorch runs eagerly and takes that batch as it is.
Nor has `eval_state_and_sharder`: a rank's eval forward runs on its own
card with no collective (BatchNorm in eval mode calls none).

Under a launcher (torchrun; `core/distributed.py`) every fine-tune rank
trains on its shard of the epoch and evaluates its shard of the split
(`ShardedEval`); rank 0 alone writes the run directory, the logs and the
checkpoints (each write followed by a barrier) and prints.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import os
import shutil
import time
from typing import Optional

import numpy as np
import torch

from ..ckpt.checkpoint import (latest_step_file, load_checkpoint,
                               save_finetune_preemption)
from ..core import distributed
from ..core.metrics import MetricLogger
from ..core.preemption import PreemptionGuard
from ..data.loader import DataLoader
from ..train.state import load_opt_state_dict, opt_state_dict


def add_common_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    p.add_argument("--output_dir", default="./output")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--data_volume", default="100", choices=["1", "10", "100"])
    p.add_argument("--pretrained", default="",
                   help="reference .pth to initialize from")
    p.add_argument("--resume", default="")
    p.add_argument("--no_bf16", action="store_true")
    return p


def setup_output(output_dir: str, args: argparse.Namespace) -> None:
    """Create the run directory and record its provenance (reference
    main_pretrain.py:214-216,258): the arguments as args.json and
    config.yaml, and a copy of the port's source under code/. Rank 0
    writes; every rank waits for it."""
    if distributed.rank() == 0:
        _write_output(output_dir, args)
    distributed.barrier()


def _write_output(output_dir: str, args: argparse.Namespace) -> None:
    os.makedirs(output_dir, exist_ok=True)
    kv = {k: v if isinstance(v, (int, float, bool, type(None))) else str(v)
          for k, v in vars(args).items()}
    with open(os.path.join(output_dir, "args.json"), "w") as f:
        json.dump(kv, f, indent=2)
    with open(os.path.join(output_dir, "config.yaml"), "w") as f:
        for k in sorted(kv):
            v = kv[k]
            if isinstance(v, str):
                v = "'" + v.replace("'", "''") + "'"
            elif v is None:
                v = "null"
            f.write(f"{k}: {v}\n")
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dst = os.path.join(output_dir, "code", "ecamp_tpu_torch")
    if not os.path.exists(dst):
        shutil.copytree(pkg_root, dst, ignore=shutil.ignore_patterns(
            "__pycache__", "*.pyc", "*.so"))


@contextlib.contextmanager
def launched(device: torch.device):
    """The fine-tune CLIs' ranks: join the launcher's process group, if
    any, before the first device use (the rank's card for CUDA, gloo on
    the CPU), silence every rank's stdout but rank 0's, and leave the
    group at the end. Yields the device to run on: the rank's, or
    `device` outside a launch."""
    joined = (not distributed.is_distributed()
              and distributed.initialize_distributed(device.type))
    try:
        with contextlib.ExitStack() as quiet:
            if distributed.rank() != 0:  # rank 0 alone prints
                quiet.enter_context(contextlib.redirect_stdout(
                    quiet.enter_context(open(os.devnull, "w"))))
            yield (distributed.rank_device(device.type)
                   if distributed.is_distributed() else device)
    finally:
        if joined:
            distributed.shutdown_distributed()


def pretrain_ckpt_epochs(epochs: int, mid_every: int = 10,
                         late_every: int = 5):
    """Checkpoint cadence: epoch 0, every `mid_every` in [60, 100), every
    `late_every` from 100, and the last epoch (main_pretrain.py:274-292)."""
    out = {epochs - 1}
    for e in range(epochs):
        if (e == 0 or (60 <= e < 100 and e % mid_every == 0)
                or (e >= 100 and e % late_every == 0)):
            out.add(e)
    return out


class EarlyStopper:
    """Best-metric tracking + patience (Classification/train.py:427,502)."""

    def __init__(self, patience: int, mode: str = "max"):
        self.patience = patience
        self.mode = mode
        self.best: Optional[float] = None
        self.bad = 0

    def update(self, value: float) -> bool:
        """Returns True when `value` is a new best."""
        better = (self.best is None or
                  (value > self.best if self.mode == "max"
                   else value < self.best))
        if better:
            self.best = value
            self.bad = 0
            return True
        self.bad += 1
        return False

    @property
    def should_stop(self) -> bool:
        return self.bad >= self.patience


class Subset:
    """A dataset restricted to an index array (a rank's eval shard; the
    eval datasets and transforms draw no random numbers, so the loader's
    workers may share them)."""

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = np.asarray(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[int(self.indices[i])]


class ShardedEval:
    """An eval split over the ranks, and the per-sample results gathered
    back (JAX `ShardedEval`): rank p scores the interleaved shard whose
    position k holds sample (p + k * P) mod n, padded by wrapping so that
    every rank runs as many samples (n_local = ceil(n / P)); `gather`
    restores dataset order on every rank, so the metrics are computed from
    the same arrays everywhere. One process: the identity and a no-op."""

    def __init__(self, n: int):
        self.n = n
        self.pid = distributed.rank()
        self.P = distributed.world_size()
        self.n_local = -(-n // self.P) if self.P > 1 else n

    @property
    def distributed(self) -> bool:
        return self.P > 1

    def local_indices(self) -> np.ndarray:
        if not self.distributed:
            return np.arange(self.n)
        # sample i < n sits at (rank i % P, position i // P), which gather
        # reassembles; the mod wraps the padding onto real samples, also
        # where n < P
        k = np.arange(self.n_local)
        return (self.pid + k * self.P) % self.n

    def gather(self, arr) -> np.ndarray:
        """(n_local, ...) per-sample results -> (n, ...) in dataset order
        (a collective every rank calls)."""
        arr = np.asarray(arr)
        if not self.distributed:
            return arr[:self.n]
        if arr.shape[0] != self.n_local:
            raise ValueError(f"{arr.shape[0]} rows from a shard of "
                             f"{self.n_local}")
        g = distributed.all_gather_rows(arr)  # (P, n_local, ...)
        return np.swapaxes(g, 0, 1).reshape((-1,) + g.shape[2:])[:self.n]

    def gather_ragged(self, items, cols: int):
        """A list of (k_i, >= cols) arrays or None, one a local sample ->
        the global list in dataset order, each cut to `cols` columns as
        float32: the lengths are gathered first, so every rank pads to the
        same k, then the (n_local, k, cols) blocks."""
        if not self.distributed:
            return list(items)[:self.n]
        lengths = np.asarray([0 if it is None else len(it) for it in items],
                             np.int32)
        all_len = self.gather(lengths)
        # the wrap-padding rows repeat real samples, so the trimmed
        # maximum bounds them too
        k = max(int(all_len.max()) if len(all_len) else 0, 1)
        packed = np.zeros((self.n_local, k, cols), np.float32)
        for i, it in enumerate(items):
            if it is not None and len(it):
                packed[i, :len(it)] = np.asarray(it, np.float32)[:, :cols]
        g = self.gather(packed)
        return [g[i, :all_len[i]] if all_len[i] else None
                for i in range(self.n)]


def sharded_eval_loader(dataset, batch_size: int, num_workers: int):
    """(an unshuffled loader over this rank's eval shard, keeping the
    ragged last batch, its `ShardedEval`)."""
    se = ShardedEval(len(dataset))
    loader = DataLoader(Subset(dataset, se.local_indices()), batch_size,
                        shuffle=False, drop_last=False,
                        num_workers=num_workers)
    return loader, se


class FinetunePreemption:
    """Preemption-safe mid-run state for the fine-tune CLIs (JAX
    `FinetunePreemption`).

    SIGTERM, the injected fault ECAMP_PREEMPT_AT_STEP (counted in
    micro-steps) or host RSS over ECAMP_RSS_LIMIT_GB writes the model
    (its BatchNorm statistics included), the optimizer state, the
    counters and the early stopper's state to
    `<output_dir>/preempt/checkpoint-step-<micro>.pth`, and the CLI exits
    0; a rerun with the same --output_dir resumes at that micro-step,
    an open accumulation cycle included. Every epoch takes `loader_len`
    micro-batches in an order fixed by (seed, epoch), so the micro-step
    alone fixes the epoch and the place in it.

    The guard holds the SIGTERM handler from construction until `finish`
    or a save; a caller's `finally` uninstalls it on every other exit.
    Data-parallel ranks agree on the micro-step (`PreemptionGuard`); every
    rank calls the save (rank 0 writes, all wait) and every rank loads.
    """

    def __init__(self, task, output_dir: str, loader_len: int,
                 accum: int = 1):
        self.task = task
        self.guard = PreemptionGuard()
        self.dir = os.path.join(os.path.abspath(output_dir), "preempt")
        self.loader_len = max(1, int(loader_len))
        self.accum = max(1, int(accum))

    def resume(self, state, stopper: EarlyStopper, micro: int = 0,
               step: int = 0, epoch: int = 0):
        """-> (state, micro, step, epoch, skip_micro). Without a
        preemption file the caller's counters pass through unchanged (so
        detection's --resume fast-forward survives); with one, the model,
        the optimizer state and the stopper are restored in place and
        `state.step` is set to the micro-step, as the schedules read it."""
        path = latest_step_file(self.dir)
        if path is None:
            return state, micro, step, epoch, 0
        t = time.perf_counter()
        ckpt = load_checkpoint(path)
        self.task.model.load_state_dict(ckpt["model"])
        opt = load_opt_state_dict(state.opt_state, ckpt["opt_state"])
        meta = ckpt["meta"]
        micro, step = int(meta["micro"]), int(meta["step"])
        if meta["has_best"]:
            stopper.best = float(meta["best"])
            stopper.bad = int(meta["bad"])
        state.step.fill_(micro)
        state = dataclasses.replace(state, opt_state=opt)
        epoch, skip_micro = divmod(micro, self.loader_len)
        print(f"resuming from preemption checkpoint: micro {micro} "
              f"(optimizer step {step}, epoch {epoch})")
        print(f"  read {path} ({os.path.getsize(path)} bytes) in "
              f"{time.perf_counter() - t:.3f} s", flush=True)
        return state, micro, step, epoch, skip_micro

    def maybe_save(self, state, micro: int, step: int,
                   stopper: EarlyStopper) -> bool:
        """Poll once a micro-step; on a preemption request write the file
        and return True (the caller leaves the CLI). The saved optimizer
        step is micro // accum, the updates taken, not the caller's `step`
        (JAX's docstring: a loop variable not yet incremented for a cycle
        that just closed made a resumed run take one update too many)."""
        if not self.guard.should_save(micro):
            return False
        t = time.perf_counter()
        path = save_finetune_preemption(
            self.dir, micro, self.task.model, opt_state_dict(state.opt_state),
            {"micro": micro, "step": micro // self.accum,
             "best": float(stopper.best if stopper.best is not None
                           else 0.0),
             "bad": int(stopper.bad), "has_best": stopper.best is not None})
        self.guard.uninstall()
        print(f"preemption checkpoint saved @ micro {micro} (optimizer step "
              f"{step}); rerun with the same --output_dir to resume")
        print(f"  wrote {path} ({os.path.getsize(path)} bytes) in "
              f"{time.perf_counter() - t:.3f} s [{self.guard.reason}]",
              flush=True)
        return True

    def finish(self) -> None:
        """Training ended normally: drop the preemption state, so a rerun
        in this output_dir does not skip straight to the test."""
        self.guard.uninstall()
        if distributed.rank() == 0:
            shutil.rmtree(self.dir, ignore_errors=True)


def skip_micro_batches(batch_iter, skip: int):
    """Fast-forward a deterministic epoch iterator after a mid-epoch
    resume: the skipped batches are built and dropped, as in JAX."""
    if skip:
        return itertools.islice(batch_iter, skip, None)
    return batch_iter


class LaunchCounts:
    """The kernels' launches since the last `take` (the fine-tune CLIs'
    `kernel_launches` field). The counters live in the process, so after a
    resume the first reading counts from the resume."""

    def __init__(self, counters):
        self.counters = counters
        self.last = {k: c.value for k, c in counters.items()}

    def take(self):
        now = {k: c.value for k, c in self.counters.items()}
        out = {k: now[k] - self.last[k] for k in now}
        self.last = now
        return out


def train_finetune(args, task, state, loader, stopper: EarlyStopper,
                   step_fn, validate, micro: int = 0, step: int = 0,
                   epoch: int = 0):
    """The fine-tune CLIs' training loop (JAX `finetune_{cls,seg,det}.py`):
    `step_fn(state, batch) -> (state, metrics)` a micro-step, an update
    every `args.gradient_accumulation_steps`, and `validate(state, step,
    epoch, logger)` every epoch's worth of updates (`len(loader) //
    accum`) until `args.num_steps` updates or the stopper ends it, from
    the given counters, or from a preemption file under
    `args.output_dir`. A task that folds its RNG by a host step
    (`ClassificationTask.step`) has it set to the micro-step. Returns
    (state, preempted): True when a save ended the run mid-way."""
    accum = max(1, args.gradient_accumulation_steps)
    eval_every = max(1, len(loader) // accum)
    preempt = FinetunePreemption(task, args.output_dir, len(loader), accum)
    try:
        state, micro, step, epoch, skip = preempt.resume(
            state, stopper, micro=micro, step=step, epoch=epoch)
        if isinstance(getattr(task, "step", None), int):
            task.step = micro
        logger = MetricLogger()
        pending = None  # read a step's metrics once the next is issued
        while step < args.num_steps and not stopper.should_stop:
            loader.set_epoch(epoch)
            t0, n0 = time.perf_counter(), micro
            batches = iter(loader)
            try:
                for batch in skip_micro_batches(batches, skip):
                    state, m = step_fn(state, batch)
                    if pending is not None:
                        logger.update(**pending)
                    pending = m
                    micro += 1
                    if micro % accum == 0:
                        step += 1
                        if step % eval_every == 0:
                            logger.update(**pending)
                            pending = None
                            validate(state, step, epoch, logger)
                            if stopper.should_stop or step >= args.num_steps:
                                break
                    # after the validation: a save at an update that
                    # validates keeps that validation (JAX polls before it,
                    # and its resumed run skips it)
                    if preempt.maybe_save(state, micro, step, stopper):
                        if pending is not None:
                            logger.update(**pending)
                        return state, True
            finally:
                batches.close()  # leaving mid-epoch stops its threads
            skip = 0
            dt, dn = time.perf_counter() - t0, micro - n0
            if dn > 0:
                print(f"Epoch [{epoch}]  Total time: {dt:.1f}s "
                      f"({dt / dn:.4f} s/it)", flush=True)
            epoch += 1
        preempt.finish()
        return state, False
    finally:
        preempt.guard.uninstall()
