"""Preemption-safe training (counterpart of `ecamp_tpu/core/preemption.py`):
turn a preemption notice into a step-exact checkpoint and a clean exit.

- A SIGTERM handler records the request (it only sets a flag).
- The train loop polls `should_save(step)` after every micro-step, or
  `should_save(step, taken=K)` after a call of K micro-steps.
- On True the loop writes a checkpoint at that exact step and exits 0;
  `--resume` then continues from it bit for bit (the step-folded RNG and
  the loader's deterministic order; `cli/pretrain.py`).

Fault injection: `ECAMP_PREEMPT_AT_STEP=N` requests a preemption at step
N, so tests and drills run the save, exit and resume path on purpose.

Host-RSS watchdog: `ECAMP_RSS_LIMIT_GB=G` (or `rss_limit_mb`) reads host
RSS above the limit as a preemption notice, so a run whose host memory
grows checkpoints and exits cleanly instead of being killed by the
kernel's OOM killer.

Data parallelism: every rank must agree on the exit step, or the others
wait forever in the next collective. A single process acts on its own
flag at once; in a process group of more than one rank the guard answers
only at the call that reaches or crosses a multiple of `sync_every`
micro-steps (`SYNC_EVERY`, 50, by default; with one micro-step a call,
every `sync_every`-th step), with the maximum of the ranks' flags (an
all-reduce, a host synchronisation), so a notice that reaches one rank
stops all of them at the same step. Every rank has the same step and
takes the same micro-steps a call, so every rank asks together. (JAX's
guard asks `step % sync_every` while its step moves by K a call, so its
ranks agree only where a call ends on a multiple; the port's rule does
not inherit that.) JAX's TPU-runtime preemption notice has no
counterpart.
"""

from __future__ import annotations

import os
import signal
from typing import Optional

from . import distributed

SYNC_EVERY = 50  # micro-steps between the ranks' agreements (JAX's default)


class PreemptionGuard:
    """Polls for a preemption request; cheap enough to call every step.
    Call `uninstall` when done: it restores the previous SIGTERM
    handler."""

    def __init__(self, rss_limit_mb: Optional[float] = None,
                 sync_every: Optional[int] = None):
        self.sync_every = max(1, int(sync_every or SYNC_EVERY))
        self._flag = False
        self._previous = None
        self.reason: Optional[str] = None
        env = os.environ.get("ECAMP_PREEMPT_AT_STEP", "")
        self._preempt_at: Optional[int] = int(env) if env else None
        if rss_limit_mb is None:
            genv = os.environ.get("ECAMP_RSS_LIMIT_GB", "")
            rss_limit_mb = float(genv) * 1024.0 if genv else 0.0
        self.rss_limit_mb = float(rss_limit_mb or 0.0)
        try:
            self._previous = signal.signal(signal.SIGTERM, self._on_signal)
        except ValueError:  # not the main thread (e.g. a test runner's)
            pass

    def _on_signal(self, signum, frame):  # pragma: no cover - async entry
        self._flag = True

    def uninstall(self) -> None:
        """Restore the previous SIGTERM handler."""
        if self._previous is not None:
            signal.signal(signal.SIGTERM, self._previous)
            self._previous = None

    @staticmethod
    def host_rss_mb() -> float:
        """This process's resident set (VmRSS of /proc/self/status), 0
        where there is no procfs."""
        try:
            with open("/proc/self/status") as f:
                for ln in f:
                    if ln.startswith("VmRSS"):
                        return int(ln.split()[1]) / 1024.0
        except OSError:  # pragma: no cover - no procfs
            pass
        return 0.0

    def should_save(self, step: int, taken: int = 1) -> bool:
        """True when training must checkpoint and exit at `step`, reached
        by a call of `taken` micro-steps; `reason` then says why. Every
        rank of a process group calls it after every call and gets the
        same answer: the ranks agree where the call reached or crossed a
        multiple of `sync_every`."""
        local = self._local(step)
        if distributed.world_size() == 1:
            return local
        if (step - taken) // self.sync_every == step // self.sync_every:
            return False
        if distributed.any_rank(local):
            self.reason = self.reason or "another rank's request"
            return True
        return False

    def _local(self, step: int) -> bool:
        if self._preempt_at is not None and step >= self._preempt_at:
            self.reason = self.reason or f"injected @ {self._preempt_at}"
            return True
        if self._flag:
            self.reason = self.reason or "signal"
            return True
        if self.rss_limit_mb > 0:
            rss = self.host_rss_mb()
            if rss > self.rss_limit_mb:
                self.reason = (f"host RSS {rss:.0f} MB > limit "
                               f"{self.rss_limit_mb:.0f} MB")
                return True
        return False
