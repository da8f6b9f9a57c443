"""CUDA graphs of the pretraining step: K micro-steps a call on a card
(`PretrainTask.make_train_step_scan`, the CLI's `--steps_per_call K`).

JAX's `make_train_step_scan` pays the host's dispatch once every K steps
by scanning the step over a (K, B, ...) superbatch. The port's eager step
is bound by the host (about 4400 launches a step at B = 32); its
counterpart of the scan is a CUDA graph of the step, captured once and
replayed once a micro-step: one launch for all of the step's kernels.

What a replay needs, and how it gets it:

- Fixed addresses. A graph reads the addresses it captured, the TMA
  descriptors that attention, the fused CE and the SR kernel encode on the
  host included. The step reads one static batch (and noise) buffer,
  filled in place from the superbatch's slot before each replay. The
  parameters, gradients, AdamW moments and count, `MultiSteps`' running
  mean and the step advance in place (`TrainState.apply_gradients`,
  `FusedAdamW.apply`) in tensors allocated outside the graphs' pool.
- Randomness. Both generators of the task are registered with each graph
  (`CUDAGraph.register_generator_state`) and reseeded on the host before
  each replay from (seed, step), as the eager step reseeds them, so a
  replay draws the eager step's mask and dropout.
- The accumulation cycle. `MultiSteps` picks its divisor and whether AdamW
  runs from a host int, so a cycle of A micro-steps is A graphs, one a
  position, sharing one memory pool. Nothing that outlives a replay lives
  in that pool (each replay's metrics are copied out before the next
  replay), so the graphs may replay in any order: a resume mid-cycle
  starts at its position, and K need not be a multiple of A.
- Warm-up. A capture cannot build what a first call builds (cuBLAS
  handles, the AdamW kernel's leaf table, the kernel library), so each
  kind of micro-step (an update or not, the noise injected or drawn,
  dropout on or off) first runs eagerly once, as a real micro-step, and
  its graphs are captured after that. Warm-up and capture run on a side
  stream.
- Launch counts. A replay runs what its capture recorded, which the
  host's counters do not see: each replay adds those launches
  (`_build.GraphLaunches`).
- Activation checkpointing (the configs' `remat`). The capture holds the
  backward's recompute of each block, and the recompute must draw the
  forward's dropout bits. A capture cannot snapshot a generator, so each
  kind's eager warm-up records where every remat block's generators
  stood at its entry (`nn/layers.py::RematTape`), the capture hands each
  block's recompute replay generators registered with its graph, and each
  replay first sets them to the step's seed at those offsets.

- Data parallelism (a process group, `core/distributed.py`). The graphs
  hold the step's collectives: the masking noise drawn for the global
  batch from the registered generator, the gradient all-reduce, ZeRO-1's
  broadcasts (in the update position's graph only), the clip's norm over
  the ranks where a clip is set, and the metrics' all-reduce. A collective
  can be captured under NCCL only (`distributed.graph_capturable`); under
  gloo the call raises, naming the backend. The graphs' collectives go
  through a communicator of their own (`distributed.graph_group`, made
  collectively here and set as the share's `group`), so the eager ones
  between replays (the preemption agreement, a checkpoint's gathers,
  which take the whole group) never mix with captured ones on one
  communicator. Every rank warms up, captures and replays the same kinds
  at the same micro-steps: the schedule reads only the cycle position,
  whether noise is given and `deterministic`, which every rank shares.
  It must: a capture records its collectives without running them, so a
  rank that captured while a peer ran the same micro-step eagerly (or
  replayed) would leave that peer's collective waiting for a partner that
  never sends, and both would hang. Drop the scan before leaving the
  group: NCCL's teardown waits for the graphs that captured its
  collectives.
- FSDP (`distributed.Fsdp`, in one process or under a group). Each graph
  holds every unit's all-gather at its call (the remat recompute's second
  gather too) and its reduce-scatter in the backward, each on the
  graphs' communicator (in one process, copies). The gathered flat
  buffers, the small leaves' copies and the backward's flat gradient are
  temporaries of the step, so they come from the pool and are freed
  within the replay; the shards, the gradient shards, AdamW's moment
  pieces and `MultiSteps`' running mean are the state, allocated with it
  outside the pool. The non-update positions' graphs fold the gradient
  shards into the running mean; the update position's graph also runs
  AdamW on the pieces, whose leaf table the warm-up built. A checkpoint
  between calls gathers the units eagerly over the whole group
  (`Fsdp.whole`).

Nothing falls back to eager steps: a capture or a replay that fails
raises, and so does a call with the kernels routed to their plain
versions (`PretrainTask.set_plain`), whose fused CE sizes a tensor on the
host (`torch.nonzero`), or under a process group whose collectives cannot
be captured.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import torch

from ..core import distributed
from ..kernels import _build
from ..nn.layers import RematTape, remat_tape
from .optim import MultiStepsState
from .state import TrainState

# the metrics of a step, in the order of `train_step`'s and of a row of
# the stacked metrics
NAMES = ("loss", "lr", "mim_loss", "res_loss", "mlm_loss")


def _stack(metrics: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.stack([metrics[k].float() for k in NAMES])


def _position(state: TrainState) -> int:
    """The micro-step's position in the accumulation cycle (0 without
    accumulation)."""
    st = state.opt_state
    return st.mini_step if isinstance(st, MultiStepsState) else 0


def _address(state: TrainState) -> tuple:
    """The addresses that tell one train state from another: the step and
    AdamW's count."""
    st = state.opt_state
    if isinstance(st, MultiStepsState):
        st = st.inner_opt_state
    return state.step.data_ptr(), st.count.data_ptr()


class _Graph:
    """One captured micro-step: the graph, its metrics' row in the pool,
    the state it leaves (its tensors are the state's own, advanced in
    place), the launches it makes and the tape of its remat blocks'
    dropout."""

    def __init__(self, graph, out, state, launches, tape):
        self.graph, self.out, self.state = graph, out, state
        self.launches, self.tape = launches, tape


class GraphedSteps:
    """`scan(state, superbatch, noise=None, deterministic=False) ->
    (state, metrics)` on a card: K micro-steps a call through CUDA graphs
    of `PretrainTask.step_body`, equal to K `train_step` calls. The
    superbatch is (K, B, ...), `noise` (K, B, grid**2) or None; the
    metrics are (K,) a key, in a buffer of their own each call. The
    graphs read the tensors of `state` (advanced in place): a call on
    another train state raises."""

    def __init__(self, task, state: TrainState, k: int):
        if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            raise NotImplementedError(
                f"torch {torch.__version__} cannot register a generator with "
                f"a CUDA graph (CUDAGraph.register_generator_state): a "
                f"graphed step would draw another mask and dropout than the "
                f"eager step, so --steps_per_call > 1 is refused")
        if task.dp is not None:  # raises under gloo, naming it
            task.dp.group = distributed.graph_group()
        self.task, self.k = task, k
        self.address = _address(state)
        self.every = max(1, task.cfg.optimizer.accum_steps)
        self.stream = torch.cuda.Stream(task.device)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: Dict[tuple, _Graph] = {}
        # the kinds of micro-step that ran eagerly, each with the tape of
        # its remat blocks' dropout offsets
        self.warm: Dict[tuple, RematTape] = {}
        self.batch: Optional[Dict[str, torch.Tensor]] = None
        self.noise: Optional[torch.Tensor] = None
        self.capture_seconds = 0.0
        self.eager_steps = 0

    def __call__(self, state: TrainState, superbatch: Dict[str, torch.Tensor],
                 noise: Optional[torch.Tensor] = None,
                 deterministic: bool = False):
        task = self.task
        if task.plain:
            raise RuntimeError(
                "a CUDA graph of the step runs the kernels: set_plain(True) "
                "routes them to their plain versions, which cannot be "
                "captured (the fused CE's torch.nonzero)")
        if _address(state) != self.address:
            raise RuntimeError("graphed step: made for another train state; "
                               "call make_train_step_scan on this one")
        rows = torch.empty((self.k, len(NAMES)), dtype=torch.float32,
                           device=task.device)
        for i in range(self.k):
            batch = {key: v[i] for key, v in superbatch.items()}
            n = None if noise is None else noise[i]
            pos = _position(state)
            kind = (pos == self.every - 1, noise is not None, deterministic)
            key = (pos,) + kind[1:]
            graph = self.graphs.get(key)
            if graph is None and kind in self.warm:
                graph = self._capture(key, state, batch, n, self.warm[kind])
            if graph is None:
                tape = RematTape()
                state = self._eager(state, batch, n, deterministic, rows[i],
                                    tape)
                self.warm[kind] = tape
            else:
                state = self._replay(graph, state, batch, n, rows[i])
        return state, {name: rows[:, j] for j, name in enumerate(NAMES)}

    def _eager(self, state, batch, noise, deterministic, row, tape):
        """One eager micro-step on the side stream (a warm-up, and a real
        micro-step), its metrics into `row`, its remat blocks' dropout
        offsets into `tape`."""
        cur = torch.cuda.current_stream(self.task.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream), remat_tape(tape, "record"):
            state, m = self.task.train_step(state, batch, noise, deterministic)
            out = _stack(m)
        cur.wait_stream(self.stream)
        row.copy_(out)
        self.eager_steps += 1
        return state

    def _fill(self, batch: Dict[str, torch.Tensor],
              noise: Optional[torch.Tensor]) -> None:
        """Copy a micro-step's inputs into the static buffers the graphs
        read, on the current stream."""
        if self.batch is None:
            self.batch = {k: torch.empty_like(v) for k, v in batch.items()}
        if noise is not None and self.noise is None:
            self.noise = torch.empty_like(noise)
        if set(batch) != set(self.batch):
            raise ValueError(f"graphed step: batch keys {sorted(batch)}, the "
                             f"graphs read {sorted(self.batch)}")
        for k, dst in self.batch.items():
            src = batch[k]
            if src.shape != dst.shape or src.dtype != dst.dtype:
                raise ValueError(
                    f"graphed step: batch key {k!r} is {src.dtype} "
                    f"{tuple(src.shape)}, the graphs read {dst.dtype} "
                    f"{tuple(dst.shape)}")
            dst.copy_(src, non_blocking=True)
        if noise is not None:
            self.noise.copy_(noise, non_blocking=True)

    def _capture(self, key, state, batch, noise, tape) -> _Graph:
        """Capture the micro-step at cycle position key[0] (noise injected
        or not, deterministic or not) into a graph of the shared pool; its
        remat blocks replay the dropout offsets that `tape` recorded."""
        task = self.task
        t0 = time.perf_counter()
        self._fill(batch, noise)
        graph = torch.cuda.CUDAGraph()
        for gen in (task.masking_generator, task.dropout_generator):
            graph.register_generator_state(gen)
        tape.register(graph)
        with _build.GraphLaunches() as launches, remat_tape(tape, "replay"):
            # thread_local: CUDA calls of other threads (the loader's, NCCL's
            # watchdog polling its events) neither fail nor void the capture
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                  capture_error_mode="thread_local"):
                new_state, m = task.step_body(
                    state, self.batch, None if noise is None else self.noise,
                    key[2])
                out = _stack(m)
        captured = _Graph(graph, out, new_state, launches, tape)
        self.graphs[key] = captured
        self.capture_seconds += time.perf_counter() - t0
        return captured

    def _replay(self, graph: _Graph, state, batch, noise, row):
        """One micro-step by the graph: inputs in, generators reseeded for
        this step, the replay, its metrics copied into `row`."""
        task = self.task
        self._fill(batch, noise)
        task.fold_rng(task.step)
        graph.tape.seed()
        graph.graph.replay()
        graph.launches.replay()
        row.copy_(graph.out)
        task.step += 1
        return graph.state


class PinnedStager:
    """Superbatches to the card through pinned host memory: K host batches
    are stacked into one of two pinned buffers and copied to new device
    tensors without blocking, on the current stream. A buffer is refilled
    only once its last copy has finished (an event), so one superbatch can
    be placed while the one before it is still in flight."""

    SLOTS = 2

    def __init__(self, device: torch.device):
        self.device = device
        self.slots = [None] * self.SLOTS  # (host buffers, event)
        self.turn = 0

    def put(self, batches: Sequence[Dict]) -> Dict[str, torch.Tensor]:
        first = {k: torch.as_tensor(v) for k, v in batches[0].items()}
        layout = {k: ((len(batches),) + tuple(t.shape), t.dtype)
                  for k, t in first.items()}
        i, self.turn = self.turn, (self.turn + 1) % self.SLOTS
        slot = self.slots[i]
        if slot is not None:
            slot[1].synchronize()  # its last copy has left the buffer
        if slot is None or {k: (tuple(t.shape), t.dtype)
                            for k, t in slot[0].items()} != layout:
            slot = self.slots[i] = (
                {k: torch.empty(shape, dtype=dtype, pin_memory=True)
                 for k, (shape, dtype) in layout.items()},
                torch.cuda.Event())
        host, event = slot
        out = {}
        for k, buf in host.items():
            for j, b in enumerate(batches):
                buf[j].copy_(torch.as_tensor(b[k]))
            out[k] = torch.empty(buf.shape, dtype=buf.dtype,
                                 device=self.device)
            out[k].copy_(buf, non_blocking=True)
        event.record()
        return out
