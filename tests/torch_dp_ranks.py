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


def remat_steps(cfgs: dict, weights: dict, batch: dict, noise: np.ndarray,
                steps: int) -> dict:
    """For each of `cfgs` (name -> PretrainConfig), `steps` PretrainTask
    steps with dropout on, on this rank's rows of the global `batch` with
    the global `noise`, from `weights`: each run's losses, last gradients
    and parameters (`tests/test_torch_remat.py`)."""
    from ecamp_tpu_torch.core import distributed
    from ecamp_tpu_torch.train.pretrain import PretrainTask

    distributed.initialize_distributed("cpu")
    rank, world = distributed.rank(), distributed.world_size()
    out = {}
    for name, cfg in cfgs.items():
        task = PretrainTask(cfg, device="cpu")
        task.model.load_state_dict(
            {k: torch.from_numpy(v) for k, v in weights.items()},
            strict=True)
        state = task.init_state()
        b = len(batch["ids"]) // world
        local = task.put_batch({k: v[rank * b:(rank + 1) * b]
                                for k, v in batch.items()})
        losses = []
        for _ in range(steps):
            state, m = task.train_step(state, local,
                                       noise=torch.from_numpy(noise))
            losses.append({k: float(v) for k, v in m.items()})
        out[name] = {"losses": losses,
                     "grads": {k: p.grad.clone()
                               for k, p in state.params.items()},
                     "params": {k: p.detach().clone()
                                for k, p in state.params.items()}}
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


def guard_steps(at_rank: int, at: int, sync_every: int, steps: int,
                taken: int = 1):
    """A `PreemptionGuard` polled after calls of `taken` micro-steps (at
    steps taken, 2 taken, ... up to `steps`) with a preemption injected at
    step `at` on rank `at_rank` only; returns (the step it stopped at, its
    reason)."""
    from ecamp_tpu_torch.core import distributed
    from ecamp_tpu_torch.core.preemption import PreemptionGuard

    distributed.initialize_distributed("cpu")
    if distributed.rank() == at_rank:
        os.environ["ECAMP_PREEMPT_AT_STEP"] = str(at)
    guard = PreemptionGuard(sync_every=sync_every)
    try:
        for step in range(taken, steps + 1, taken):
            if guard.should_save(step, taken):
                return step, guard.reason
        return None, None
    finally:
        guard.uninstall()
        distributed.shutdown_distributed()


def cli_mains(runs: list, tiny: dict) -> list:
    """Each of `runs` (dicts: `argv`; `env`, set for the run and removed
    after it; `sync_every`) as `cli.pretrain.main(argv)` on this rank of
    one gloo group, at the tiny model `tiny` (PretrainConfig fields);
    returns what the rank printed, a run."""
    from ecamp_tpu_torch.cli import pretrain as cli
    from ecamp_tpu_torch.core import distributed, preemption

    distributed.initialize_distributed("cpu")
    orig = cli.cfg.PretrainConfig
    cli.cfg.PretrainConfig = lambda **kw: orig(**dict(kw, **tiny))
    printed = []
    try:
        for run in runs:
            os.environ.update(run.get("env", {}))
            preemption.SYNC_EVERY = run.get("sync_every", 50)
            buf = io.StringIO()
            try:
                with contextlib.redirect_stdout(buf):
                    cli.main(run["argv"])
            finally:
                for k in run.get("env", {}):
                    del os.environ[k]
            printed.append(buf.getvalue())
    finally:
        distributed.shutdown_distributed()
    return printed


def _snapshot(task, state) -> dict:
    """The rank's parameters (whole, gathered under FSDP: a collective),
    AdamW moments (its pieces under ZeRO-1 and FSDP), `MultiSteps`'
    running mean and the counters (state step, host step, AdamW's count,
    cycle position)."""
    from ecamp_tpu_torch.core import distributed
    from ecamp_tpu_torch.train.state import adamw_state

    st = state.opt_state
    adam = adamw_state(st)
    with distributed.whole_params(task.model, write_back=False) as model:
        params = {k: v.clone() for k, v in model.state_dict().items()}
    return {"params": params,
            "mu": {k: v.clone() for k, v in adam.mu.items()},
            "nu": {k: v.clone() for k, v in adam.nu.items()},
            "acc": {k: v.clone() for k, v in getattr(st, "acc_grads",
                                                     {}).items()},
            "counters": (int(state.step), task.step, int(adam.count),
                         getattr(st, "mini_step", None))}


def _scans(parity: dict, weights: dict, superbatch: dict,
           noise: np.ndarray, bitwise: dict, batches: list, k: int) -> dict:
    """On this rank of a process group: for each of `parity` (name ->
    PretrainConfig), one K-step call (`make_train_step_scan`) from
    `weights` on the rank's rows of the global (K, G, ...) `superbatch`
    with the global `noise`, dropout off: its (K,) metrics and counters;
    for each of `bitwise` (name -> (PretrainConfig, steps an epoch)), two
    K-step calls on the rank's rows of `batches` and 2 K single steps
    from the same seed (dropout on, the noise drawn): each run's metrics
    and `_snapshot`."""
    from ecamp_tpu_torch.core import distributed
    from ecamp_tpu_torch.train.pretrain import PretrainTask

    rank, world = distributed.rank(), distributed.world_size()
    out = {"parity": {}, "bitwise": {}}

    def rows(a, axis=0):
        b = a.shape[axis] // world
        return torch.from_numpy(a).narrow(axis, rank * b, b)

    for name, cfg in parity.items():
        task = PretrainTask(cfg, device="cpu")
        with distributed.whole_params(task.model) as model:
            model.load_state_dict(
                {n: torch.from_numpy(v) for n, v in weights.items()},
                strict=True)
        state = task.init_state()
        scan = task.make_train_step_scan(state, k)
        state, m = scan(state, {n: rows(v, 1) for n, v in superbatch.items()},
                        torch.from_numpy(noise), deterministic=True)
        out["parity"][name] = {
            "metrics": {n: v.tolist() for n, v in m.items()},
            "counters": _snapshot(task, state)["counters"]}
    for name, (cfg, per_epoch) in bitwise.items():
        local = [{n: rows(v) for n, v in b.items()} for b in batches]
        runs = []
        for scanned in (False, True):
            task = PretrainTask(cfg, device="cpu", steps_per_epoch=per_epoch)
            state = task.init_state()
            metrics = []
            if scanned:
                scan = task.make_train_step_scan(state, k)
                for c in range(len(local) // k):
                    group = local[c * k:(c + 1) * k]
                    state, m = scan(state, task.put_superbatch(group))
                    metrics += [{n: float(v[i]) for n, v in m.items()}
                                for i in range(k)]
            else:
                for b in local:
                    state, m = task.train_step(state, b)
                    metrics.append({n: float(v) for n, v in m.items()})
            runs.append({"metrics": metrics,
                         "state": _snapshot(task, state)})
        out["bitwise"][name] = runs
    return out


def scan_parts(parity: dict, weights: dict, superbatch: dict,
               noise: np.ndarray, bitwise: dict, batches: list, k: int,
               guard: dict) -> dict:
    """`tests/test_torch_dp_steps_per_call.py` on this rank of one gloo
    group: `_scans`, whether the group's collectives can be captured and
    `graph_group`'s refusal; then `guard_steps(**guard)`."""
    from ecamp_tpu_torch.core import distributed

    distributed.initialize_distributed("cpu")
    out = _scans(parity, weights, superbatch, noise, bitwise, batches, k)
    out["capturable"] = distributed.graph_capturable()
    try:
        distributed.graph_group()
    except RuntimeError as e:
        out["graph_group_refused"] = str(e)
    out["guard"] = guard_steps(**guard)  # it leaves the group
    return out


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


# -- FSDP (tests/test_torch_fsdp.py) ----------------------------------------


def _fsdp_run(cfg, weights: dict, batch: dict, noise, steps: int,
              deterministic: bool) -> dict:
    """`steps` PretrainTask steps on this rank's rows of the global `batch`
    from `weights` (`noise` the global noise, or None to draw it): the
    losses, the whole parameters and the gathered optimizer and cycle
    state dicts, and the elements the rank keeps of the parameters, their
    gradients and the moments."""
    from ecamp_tpu_torch.core import distributed
    from ecamp_tpu_torch.train.pretrain import PretrainTask
    from ecamp_tpu_torch.train.state import adamw_state

    rank, world = distributed.rank(), distributed.world_size()
    task = PretrainTask(cfg, device="cpu")
    with distributed.whole_params(task.model) as model:
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in weights.items()}, strict=True)
    state = task.init_state()
    b = len(batch["ids"]) // world
    local = task.put_batch({k: v[rank * b:(rank + 1) * b]
                            for k, v in batch.items()})
    losses = []
    for _ in range(steps):
        state, m = task.train_step(
            state, local, None if noise is None else torch.from_numpy(noise),
            deterministic)
        losses.append({k: float(v) for k, v in m.items()})
    with distributed.whole_params(task.model, write_back=False) as model:
        params = {k: v.clone() for k, v in model.state_dict().items()}
    adam = adamw_state(state.opt_state)
    shards = getattr(task.dp, "units", [])
    return {"losses": losses, "params": params,
            "optimizer": state.optimizer_state_dict(0.05),
            "cycle": state.cycle_state_dict(),
            "elements": {
                "params": sum(p.numel() for p in state.params.values()),
                "param_shards": sum(u.shard.numel() for u in shards),
                "grad_shards": sum(u.grad.numel() for u in shards),
                "moments": sum(t.numel() for t in adam.mu.values())}}


def _clip_norms(rank: int, world: int) -> dict:
    """The clip's global norm over this rank's pieces of seeded gradients
    (ZeRO-1's layout, every rank's norm over the ranks) beside the norm of
    the whole gradients; and a clipped update of a ZeRO-1 `MultiSteps`
    (the running mean in pieces) beside the unsharded one's, after 2
    micro-steps: this rank's elements of each leaf."""
    from ecamp_tpu_torch.core import distributed
    from ecamp_tpu_torch.kernels.fused_adamw import FusedAdamW, global_norm
    from ecamp_tpu_torch.train.optim import MultiSteps

    g = torch.Generator().manual_seed(5)
    shapes = {"w": (64, 48), "b": (3,), "pos": (1, 1, 40), "odd": (7, 13)}

    def draw():
        return {k: torch.randn(s, generator=g) for k, s in shapes.items()}

    params, grads = draw(), [draw(), draw()]
    layout = distributed.FlatLayout(shapes, world)
    z = distributed.Zero1(layout, rank)
    out = {"whole_norm": float(global_norm(list(grads[0].values()))),
           "sharded_norm": float(global_norm(
               [z.local(t, k) for k, t in grads[0].items()],
               over_ranks=True))}

    def make(zero1):
        return MultiSteps(FusedAdamW(
            lambda c: torch.full((), 1e-2), 0.9, 0.95, 1e-8, 0.05,
            grad_clip=0.5, zero1=zero1), 2)

    updated = {}
    for name, share in (("whole", None), ("zero1", z)):
        p = {k: t.clone() for k, t in params.items()}
        tx = make(share)
        st = tx.init(p)
        for gr in grads:
            st = tx.apply(p, gr, st)
        updated[name] = {k: z.local(t, k).clone() for k, t in p.items()}
    out["updated"] = updated
    return out


def _step_groups(cfg, batch: dict, noise: np.ndarray, steps: int,
                 work: str) -> dict:
    """The collectives of a `PretrainTask` of `cfg` (FSDP, or ZeRO-1) whose
    step group (`task.dp.group`) is a second gloo group, as a graphed step
    sets `graph_group()`: each call's function, group ("step", "default"
    or "other") and elements, by phase: "init" (`init_state` with a
    generator: `whole_params`), "steps" (`steps` train steps on the
    rank's rows of `batch` with the global `noise`, dropout off), "save"
    (`save_checkpoint` into `work`: the gathered parameters and moments)
    and "load" (`load_model_state`, `load_optimizer_state_dict`); and the
    number of FSDP units (0 without FSDP)."""
    import torch.distributed as dist

    from ecamp_tpu_torch.ckpt.checkpoint import (load_checkpoint,
                                                 load_model_state,
                                                 save_checkpoint)
    from ecamp_tpu_torch.core import distributed
    from ecamp_tpu_torch.train.pretrain import PretrainTask

    rank, world = distributed.rank(), distributed.world_size()
    second = dist.new_group(backend="gloo")
    task = PretrainTask(cfg, device="cpu")
    task.dp.group = second
    calls, phase = {}, ["init"]
    names = ("all_reduce", "broadcast", "all_gather_into_tensor",
             "reduce_scatter_tensor")
    real = {n: getattr(dist, n) for n in names}

    def recorder(name):
        def record(tensor, *args, **kwargs):
            group = kwargs.get("group")
            tag = ("step" if group is second else
                   "default" if group is None else "other")
            calls.setdefault(phase[0], []).append(
                (name, tag, int(tensor.numel())))
            return real[name](tensor, *args, **kwargs)
        return record

    for n in names:
        setattr(dist, n, recorder(n))
    try:
        state = task.init_state(torch.Generator().manual_seed(1))
        b = len(batch["ids"]) // world
        local = task.put_batch({k: v[rank * b:(rank + 1) * b]
                                for k, v in batch.items()})
        phase[0] = "steps"
        for _ in range(steps):
            state, _m = task.train_step(state, local, torch.from_numpy(noise),
                                        deterministic=True)
        phase[0] = "save"
        os.makedirs(work, exist_ok=True)
        path = save_checkpoint(work, 0, task.model, state,
                               cfg.optimizer.weight_decay)
        phase[0] = "load"
        ck = load_checkpoint(path)
        load_model_state(task.model, ck["model"])
        state.load_optimizer_state_dict(ck["optimizer"])
    finally:
        for n, fn in real.items():
            setattr(dist, n, fn)
    return {"calls": calls, "units": len(getattr(task.dp, "units", ()))}


def fsdp_parts(runs: dict, weights: dict, batch: dict, noise: np.ndarray,
               steps: int, clis: list, tiny: dict, scans: dict,
               routes: dict, work: str) -> dict:
    """`tests/test_torch_fsdp.py` on this rank of one gloo group: each of
    `runs` (name -> (PretrainConfig, injected noise or not, dropout off or
    not)) through `_fsdp_run`; the clip's norm over the ranks
    (`_clip_norms`); `_scans(**scans)`; each of `routes` (name ->
    PretrainConfig) through `_step_groups` (2 steps, its checkpoint in
    `work`); then each of `clis` as `cli_mains` runs them, at the tiny
    model `tiny`. Returns name -> result, "clip", "scans", "routes" and
    "printed"."""
    from ecamp_tpu_torch.core import distributed

    distributed.initialize_distributed("cpu")
    out = {name: _fsdp_run(cfg, weights, batch, noise if inject else None,
                           steps, det)
           for name, (cfg, inject, det) in runs.items()}
    out["clip"] = _clip_norms(distributed.rank(), distributed.world_size())
    out["scans"] = _scans(weights=weights, **scans)
    out["routes"] = {
        name: _step_groups(cfg, batch, noise, 2, os.path.join(work, name))
        for name, cfg in routes.items()}
    out["printed"] = cli_mains(clis, tiny)  # it leaves the group
    return out
