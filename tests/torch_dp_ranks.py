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
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    os.makedirs(tmp, exist_ok=True)
    outs = [os.path.join(str(tmp), f"{fn}-rank{r}.pt") for r in range(world)]
    procs = [ctx.Process(target=_entry,
                         args=(fn, r, world, port, kwargs, outs[r]))
             for r in range(world)]
    for p in procs:
        p.start()
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
