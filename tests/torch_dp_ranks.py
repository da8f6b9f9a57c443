"""Ranks of a data-parallel run of the port on the CPU, for
`tests/test_torch_distributed.py`: `spawn` starts `world` processes that
join one gloo group through the launcher's variables (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT, as torchrun sets them) and each runs
one function of this module; their results come back by file. The module
imports torch and the port only, so a rank starts in a few seconds.
"""

from __future__ import annotations

import contextlib
import io
import multiprocessing
import os
import socket
import traceback

import numpy as np
import torch

RANK_TIMEOUT = 240  # seconds a spawned rank may take


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(fn: str, rank: int, world: int, port: int, kwargs: dict,
           out: str) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    try:
        result = globals()[fn](**kwargs)
        torch.save({"ok": result}, out)
    except BaseException:  # noqa: BLE001 - reported to the parent
        torch.save({"error": traceback.format_exc()}, out)
        raise


def spawn(fn: str, world: int, tmp, **kwargs) -> list:
    """Run `fn(**kwargs)` on `world` gloo ranks; returns each rank's
    result, in rank order, or raises with the first rank's traceback."""
    return collect(start(fn, world, tmp, **kwargs))


def start(fn: str, world: int, tmp, **kwargs):
    """Start `fn(**kwargs)` on `world` gloo ranks and return at once (the
    caller works meanwhile); `collect` waits for them."""
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    os.makedirs(tmp, exist_ok=True)
    outs = [os.path.join(str(tmp), f"{fn}-rank{r}.pt") for r in range(world)]
    procs = [ctx.Process(target=_entry,
                         args=(fn, r, world, port, kwargs, outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
    return fn, procs, outs


def stop(started) -> None:
    """Kill what is left of a `start` (a caller that never collected)."""
    for p in started[1]:
        if p.is_alive():
            p.kill()
            p.join()


def collect(started) -> list:
    """Each rank's result of a `start`, in rank order, or raise with the
    first rank's traceback."""
    fn, procs, outs = started
    for p in procs:
        p.join(RANK_TIMEOUT)
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    results = []
    for r, path in enumerate(outs):
        got = torch.load(path, weights_only=False) if os.path.exists(path) \
            else {"error": f"rank {r} wrote nothing (exit code "
                           f"{procs[r].exitcode})"}
        if "error" in got:
            raise RuntimeError(f"rank {r} of {fn}: {got['error']}")
        results.append(got["ok"])
    if alive:
        raise RuntimeError(f"{len(alive)} ranks of {fn} outlived "
                           f"{RANK_TIMEOUT} s")
    return results


def task_steps(cfg, weights: dict, batch: dict, noise: np.ndarray,
               steps: int) -> dict:
    """`steps` PretrainTask steps on this rank's rows of the global `batch`
    with the global `noise`, dropout off, from `weights`: the losses, the
    first step's averaged gradients, the parameters, the optimizer state
    dict (gathered), the parameter checksum and the rank's moment
    elements."""
    from ecamp_tpu_torch.core import distributed
    from ecamp_tpu_torch.train.pretrain import PretrainTask

    distributed.initialize_distributed("cpu")
    rank, world = distributed.rank(), distributed.world_size()
    task = PretrainTask(cfg, device="cpu")
    task.model.load_state_dict(
        {k: torch.from_numpy(v) for k, v in weights.items()}, strict=True)
    state = task.init_state()
    b = len(batch["ids"]) // world
    local = task.put_batch({k: v[rank * b:(rank + 1) * b]
                            for k, v in batch.items()})
    losses, grads = [], None
    for _ in range(steps):
        state, m = task.train_step(state, local,
                                   noise=torch.from_numpy(noise),
                                   deterministic=True)
        losses.append({k: float(v) for k, v in m.items()})
        if grads is None:
            grads = {k: p.grad.clone() for k, p in state.params.items()}
    params = {k: p.detach().clone() for k, p in state.params.items()}
    out = {"losses": losses, "grads": grads, "params": params,
           "optimizer": state.optimizer_state_dict(0.05),
           "checksum": float(sum(p.double().sum() for p in params.values())),
           "moment_elems": sum(t.numel()
                               for t in state.opt_state.mu.values())}
    distributed.shutdown_distributed()
    return out


def cli_main(argv: list, tiny: dict, env: dict, sync_every: int) -> str:
    """`cli.pretrain.main(argv)` at the tiny model `tiny` (PretrainConfig
    fields), with `env` set and the ranks agreeing on a preemption every
    `sync_every` micro-steps; returns what the rank printed."""
    from ecamp_tpu_torch.cli import pretrain as cli
    from ecamp_tpu_torch.core import preemption

    os.environ.update(env)
    preemption.SYNC_EVERY = sync_every
    orig = cli.cfg.PretrainConfig
    cli.cfg.PretrainConfig = lambda **kw: orig(**dict(kw, **tiny))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    return buf.getvalue()


def guard_steps(at_rank: int, at: int, sync_every: int, steps: int):
    """A `PreemptionGuard` polled at steps 1.. with a preemption injected
    at step `at` on rank `at_rank` only; returns (the step it stopped at,
    its reason)."""
    from ecamp_tpu_torch.core import distributed
    from ecamp_tpu_torch.core.preemption import PreemptionGuard

    distributed.initialize_distributed("cpu")
    if distributed.rank() == at_rank:
        os.environ["ECAMP_PREEMPT_AT_STEP"] = str(at)
    guard = PreemptionGuard(sync_every=sync_every)
    try:
        for step in range(1, steps + 1):
            if guard.should_save(step):
                return step, guard.reason
        return None, None
    finally:
        guard.uninstall()
        distributed.shutdown_distributed()


# -- data-parallel fine-tuning (tests/test_torch_dp_finetune.py) ------------


def _counting_all_reduce():
    """Count `torch.distributed.all_reduce` calls (the port's collectives
    go through the module attribute)."""
    import torch.distributed as dist

    real, calls = dist.all_reduce, []

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    dist.all_reduce = counted
    return calls, lambda: setattr(dist, "all_reduce", real)


def _rows(a, rank: int, world: int):
    b = len(a) // world
    return a[rank * b:(rank + 1) * b]


def _bn_part(rank, world, x, w_out, state):
    """This rank's rows of the global `x` through a train-mode `BatchNorm`
    loaded from `state`, the sum-loss of its output against `w_out`'s rows
    backpropagated; then an eval-mode forward of a different number of
    rows on each rank. Returns the output, the running statistics, the
    input and parameter gradients and the all-reduce calls of each
    mode."""
    from ecamp_tpu_torch.nn.layers import BatchNorm

    bn = BatchNorm(x.shape[1])
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    xt = torch.from_numpy(_rows(x, rank, world)).requires_grad_(True)
    calls, restore = _counting_all_reduce()
    try:
        y = bn(xt, train=True)
        (y * torch.from_numpy(_rows(w_out, rank, world))).sum().backward()
        train_calls = len(calls)
        with torch.no_grad():
            bn(torch.from_numpy(x[:rank + 1]), train=False)
        eval_calls = len(calls) - train_calls
    finally:
        restore()
    return {"y": y.detach(), "x_grad": xt.grad,
            "weight_grad": bn.weight.grad, "bias_grad": bn.bias.grad,
            "running_mean": bn.running_mean.clone(),
            "running_var": bn.running_var.clone(),
            "calls": (train_calls, eval_calls)}


def _dice_part(rank, world, logits, targets):
    """`mixed_loss` on this rank's rows of the global logits and targets:
    its value and the logits' gradient."""
    from ecamp_tpu_torch.ops.losses import mixed_loss

    lt = torch.from_numpy(_rows(logits, rank, world)).requires_grad_(True)
    loss = mixed_loss(lt, torch.from_numpy(_rows(targets, rank, world)))
    loss.backward()
    return {"loss": float(loss.detach()), "grad": lt.grad}


_TASKS = {"seg": ("segmentation", "SegmentationTask"),
          "det": ("detection", "DetectionTask"),
          "cls": ("classification", "ClassificationTask")}


def _task_part(rank, world, kind, cfg, weights, batches, frozen=None,
               float64=False):
    """The port's fine-tune task `kind` from `weights` on this rank's rows
    of each global batch (one train step each), in float64 with `float64`
    (the model's fp32 parts too); `frozen` (a regex) leaves more leaves
    out of the optimizer than the task's freeze mask. Returns
    each step's loss, the BatchNorm running statistics and the checksums
    of the parameters and of the BatchNorm buffers."""
    import importlib
    import re

    from ecamp_tpu_torch.train.optim import make_optimizer
    from ecamp_tpu_torch.train.state import TrainState

    mod, name = _TASKS[kind]
    cls = getattr(importlib.import_module(f"ecamp_tpu_torch.train.{mod}"),
                  name)
    task = cls(cfg, device="cpu")
    task.model.load_state_dict({k: torch.from_numpy(v)
                                for k, v in weights.items()}, strict=True)
    if float64:
        task.model.double()
        for m in task.model.modules():
            if getattr(m, "dtype", None) == torch.float32:
                m.dtype = torch.float64
    state = task.init_state()
    if frozen is not None:
        mask = task.freeze_mask() or {k: True for k, _ in
                                      task.model.named_parameters()}
        task.tx = make_optimizer(cfg.optimizer, freeze_mask={
            k: m and not re.search(frozen, k) for k, m in mask.items()})
        state = TrainState.create(task.model, task.tx)
    losses = []
    for batch in batches:
        state, m = task.train_step(
            state, *(torch.from_numpy(_rows(a, rank, world)) for a in batch))
        losses.append(float(m["loss"]))
    sd = task.model.state_dict()
    return {"losses": losses,
            "stats": {k: v.clone() for k, v in sd.items()
                      if "running_" in k},
            "param_sum": float(sum(p.double().sum()
                                   for p in task.model.parameters())),
            "buffer_sum": float(sum(v.double().sum() for k, v in sd.items()
                                    if "running_" in k))}


def _gather_part(rank, world, n, rows, ragged, cols):
    """`ShardedEval(n)` on this rank: the shard of the per-sample `rows`
    and of the `ragged` list that `local_indices` picks, gathered back."""
    from ecamp_tpu_torch.cli.common import ShardedEval

    se = ShardedEval(n)
    idx = se.local_indices()
    return {"indices": idx, "rows": se.gather(rows[idx]),
            "ragged": se.gather_ragged([ragged[i] for i in idx], cols)}


def finetune_parts(parts: dict) -> dict:
    """Run each of `parts` (name -> (function name of this module, its
    keyword arguments)) on this rank of one gloo group, in order; returns
    name -> result."""
    from ecamp_tpu_torch.core import distributed

    distributed.initialize_distributed("cpu")
    rank, world = distributed.rank(), distributed.world_size()
    try:
        return {name: globals()[fn](rank, world, **kw)
                for name, (fn, kw) in parts.items()}
    finally:
        distributed.shutdown_distributed()


def _tiny_vit(**kw):
    from ecamp_tpu_torch.core import config as pcfg

    return pcfg.ViTConfig(patch_size=16, embed_dim=32, depth=2, num_heads=2,
                          **kw)


def finetune_clis(runs: list) -> list:
    """Each of `runs` (dicts: `cli`, the module under ecamp_tpu_torch.cli;
    `argv`; `env`, set for the run and removed after it; `sync_every`) as
    `main(argv)` on this rank of one gloo group, at the tiny ViT `tiny`;
    returns, a run, what rank 0 printed, the log records every rank
    produced (written by rank 0 alone), what `main` returned, and the
    model's state, the optimizer state and the step where training ended,
    with the checksum of the state."""
    import importlib

    from ecamp_tpu_torch.cli import common, finetune_cls
    from ecamp_tpu_torch.core import distributed, metrics, preemption
    from ecamp_tpu_torch.train.state import opt_state_dict

    distributed.initialize_distributed("cpu")
    finetune_cls._VIT_FACTORY["tiny"] = _tiny_vit
    records = []
    real_write = metrics.JsonlLogger.write

    def write(self, record):
        records.append(record)
        real_write(self, record)

    metrics.JsonlLogger.write = write
    out = []
    try:
        for run in runs:
            cli = importlib.import_module(f"ecamp_tpu_torch.cli.{run['cli']}")
            got = {}

            def spy(args, task, state, *a, **kw):
                state, preempted = common.train_finetune(args, task, state,
                                                         *a, **kw)
                sd = {k: v.detach().clone()
                      for k, v in task.model.state_dict().items()}
                got.update(preempted=preempted, model=sd,
                           opt=opt_state_dict(state.opt_state),
                           step=int(state.step),
                           checksum=float(sum(v.double().sum()
                                              for v in sd.values())))
                return state, preempted

            cli.train_finetune = spy
            os.environ.update(run.get("env", {}))
            preemption.SYNC_EVERY = run.get("sync_every", 50)
            del records[:]
            buf = io.StringIO()
            try:
                with contextlib.redirect_stdout(buf):
                    result = cli.main(run["argv"])
            finally:
                cli.train_finetune = common.train_finetune
                for k in run.get("env", {}):
                    del os.environ[k]
            out.append(dict(got, printed=buf.getvalue(),
                            records=list(records), result=result))
    finally:
        metrics.JsonlLogger.write = real_write
        distributed.shutdown_distributed()
    return out
