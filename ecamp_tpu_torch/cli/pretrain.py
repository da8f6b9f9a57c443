"""Pre-training entry point of the port (counterpart of
`ecamp_tpu/cli/pretrain.py`; reference run.sh + main_pretrain.py), on one
CUDA card:

python -m ecamp_tpu_torch.cli.pretrain \\
  --data_path /data/mimic --batch_size 256 --accum_iter 8 --epochs 120 \\
  --max_epoch 200 --warmup_epochs 40 --lr 1.5e-4 --weight_decay 0.05 \\
  --mask_ratio 0.75 --fused_mlm_ce --output_dir ./out

or data-parallel on N cards of a host, one process each:

torchrun --nproc_per_node=N -m ecamp_tpu_torch.cli.pretrain \\
  --data_path /data/mimic --batch_size 32 [--shard_optimizer | --fsdp] ...

Under a launcher (torchrun, or OpenMPI / SLURM with MASTER_ADDR and
MASTER_PORT; `core/distributed.py`) `--batch_size` is per rank, as in the
JAX package (the global batch is N times it): each rank reads its shard
of every epoch's order and steps on it, the gradients and the logged
losses are averaged over the ranks (NCCL on CUDA, gloo with `--device
cpu` or where a host runs more ranks than it has cards), and only rank 0
prints, writes `log.txt`, `tb/` and checkpoints. `--shard_optimizer`
keeps each rank's share of the AdamW moments only (ZeRO-1); `--fsdp`
(ZeRO-3) keeps each rank's share of the parameters, their gradients and
the moments: each unit of the model (a transformer block, BERT's
embeddings, fusion layer and MLM head, the rest) is all-gathered at its
call and its gradient reduce-scattered after its backward
(`core/distributed.py::Fsdp`); `--fsdp --shard_optimizer` is `--fsdp`.
A checkpoint has the same layout in every case and loads into any number
of ranks, with or without either flag.

(`python -m ecamp_tpu_torch.cli.run_preset pretrain_mimic` gives the
recipe's flags.) `--data_path` holds the two MIMIC-CXR CSVs, the images
they name and `mimic_wordpiece.json` (`data/datasets.py`). Every epoch
appends one JSON line to `<output_dir>/log.txt` (mean losses and lr, peak
device memory, kernel launches, micro-steps and AdamW updates so far),
adds its `train/{loss,mim_loss,res_loss,mlm_loss,lr}` scalars to the
TensorBoard log `<output_dir>/tb` where `tensorboard` imports
(`core/observability.py`; elsewhere nothing is written) and, at the
reference's cadence, writes `<output_dir>/checkpoint-<epoch>.pth`.

`--accum_iter k` averages the gradients of k micro-batches into one
AdamW update (`train/optim.py::MultiSteps`): an epoch, the step, the RNG
fold and the lr schedule count micro-steps, AdamW's count updates, and
each update applies the lr of its cycle's first micro-step. An epoch may
end mid-cycle; the checkpoint carries the open cycle
(`ckpt/checkpoint.py::CYCLE_KEY`).

`--steps_per_call K` runs K micro-steps a call
(`PretrainTask.make_train_step_scan`): on a card CUDA graphs of the step,
replayed once a micro-step over a (K, B, ...) superbatch placed through
pinned memory one call ahead; on the CPU the K steps in order. An epoch's
last group of fewer than K batches runs through the single step, a
preemption is asked for once a call, and the log is the single step's.
Under torchrun the graphs hold the data-parallel step with its NCCL
collectives (the gradient all-reduce, ZeRO-1's exchange, with `--fsdp`
each unit's all-gather and reduce-scatter, the metrics); `--device cpu`
ranks (gloo) run the K steps in order. On CUDA it needs NCCL, one card a
rank: where ranks share a card (gloo) it is refused.

`--resume checkpoint-<e>.pth` restores the parameters, the AdamW moments
and count and the cycle, and continues at epoch e + 1. On SIGTERM,
`ECAMP_PREEMPT_AT_STEP=N` or host RSS above `--rss_limit_gb`
(`core/preemption.py`) the run writes `checkpoint-step-<step>.pth` at the
exact micro-step and exits 0; `--resume` on it replays the interrupted
epoch's loader order, skips the batches already taken and continues bit
for bit. Data-parallel ranks agree on the step at the call that reaches
or crosses a multiple of 50 micro-steps (`core/preemption.py::
SYNC_EVERY`), and each skips its own batches.
`--device cuda` (the default) needs a card; `--device cpu` runs the
kernels' plain versions.
"""

from __future__ import annotations

import argparse
import itertools
import os

import torch

from ..ckpt.checkpoint import (CYCLE_KEY, load_checkpoint, load_model_state,
                               save_checkpoint, save_preemption_checkpoint)
from ..core import config as cfg
from ..core import distributed
from ..core.metrics import JsonlLogger, MetricLogger, device_memory_mb
from ..core.observability import SummaryWriter
from ..core.preemption import PreemptionGuard
from ..data.datasets import PretrainReportDataset
from ..data.loader import DataLoader
from ..kernels import (flash_attention, fused_adamw, fused_mlm_loss,
                       layer_norm, sr_head)
from ..train.pretrain import PretrainTask
from ..train.state import adamw_state
from .common import (add_common_args, launched, pretrain_ckpt_epochs,
                     setup_output)

# the launch counters an epoch's log line reports
_COUNTERS = {"layer_norm": layer_norm.launches,
             "attention": flash_attention.launches,
             "sr_conv_stack": sr_head.launches,
             "sr_conv_stack_tma": sr_head.launches_tma,
             "adamw": fused_adamw.launches,
             "fused_ce_fwd": fused_mlm_loss.launches_fwd,
             "fused_ce_merge": fused_mlm_loss.launches_merge,
             "fused_ce_dl": fused_mlm_loss.launches_dl,
             "fused_ce_dx": fused_mlm_loss.launches_dx,
             "fused_ce_dw": fused_mlm_loss.launches_dw}


def get_args(argv=None):
    p = argparse.ArgumentParser("ecamp_tpu_torch pretrain")
    add_common_args(p)
    p.add_argument("--data_path", required=True,
                   help="dir with the mimic CSVs + mimic_wordpiece.json")
    p.add_argument("--epochs", type=int, default=120)
    p.add_argument("--max_epoch", type=int, default=200)
    p.add_argument("--warmup_epochs", type=float, default=40)
    p.add_argument("--lr", type=float, default=1.5e-4)
    p.add_argument("--min_lr", type=float, default=0.0)
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--mask_ratio", type=float, default=0.75)
    p.add_argument("--accum_iter", type=int, default=1)
    p.add_argument("--input_size", type=int, default=448)
    p.add_argument("--max_caption_length", type=int, default=256)
    p.add_argument("--norm_pix_loss", action="store_true",
                   help="parsed for parity; unused on the loss path, as in "
                        "the reference (model_ecamp.py:100)")
    p.add_argument("--print_freq", type=int, default=20)
    p.add_argument("--resume_optimizer", action="store_true",
                   help="restore the optimizer and epoch from a --resume "
                        ".pth whose name does not start with 'ECAMP' or "
                        "'checkpoint'")
    p.add_argument("--exact_attn_dropout", action="store_true",
                   help="HF-exact attention dropout on the BERT "
                        "probabilities (plain attention) instead of the "
                        "same-rate dropout of its output (attention kernel)")
    p.add_argument("--steps_per_call", type=int, default=1)
    p.add_argument("--shard_optimizer", action="store_true",
                   help="ZeRO-1: each data-parallel rank keeps and updates "
                        "its share of the AdamW moments only")
    p.add_argument("--fsdp", action="store_true",
                   help="FSDP / ZeRO-3: each data-parallel rank keeps its "
                        "share of the parameters, gradients and AdamW "
                        "moments; a unit's parameters are all-gathered at "
                        "its call and its gradient reduce-scattered after "
                        "its backward (implies --shard_optimizer)")
    p.add_argument("--rss_limit_gb", type=float, default=0.0,
                   help="host-RSS watchdog: above this many GiB of RSS, "
                        "checkpoint at the exact step and exit 0 "
                        "(resumable); 0 disables (ECAMP_RSS_LIMIT_GB sets "
                        "it too)")
    p.add_argument("--u8_pipe", action="store_true",
                   help="ship images as the quantized u8 single-channel "
                        "gray and normalize on the device (1/12 the bytes "
                        "of fp32)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; needs a card) or cpu")
    p.add_argument("--fused_mlm_ce", action="store_true",
                   help="the MLM loss through the fused vocab-projection + "
                        "CE kernels: the (B, L, 30000) logits are never "
                        "stored")
    return p.parse_args(argv)


def refuse_what_is_not_ported(args) -> None:
    """Options of the JAX CLI that the port does not have raise; none is
    ignored silently (ROADMAP Queue 1, "Not to port")."""
    for path in (args.resume, args.pretrained):
        if path and not path.endswith(".pth"):
            raise NotImplementedError(
                f"{path!r}: orbax checkpoint directories are not ported "
                f"to ecamp_tpu_torch, only reference .pth files are read "
                f"(ROADMAP Queue 1, \"Not to port\")")


def main(argv=None):
    args = get_args(argv)
    refuse_what_is_not_ported(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA card (--device cpu "
                           "runs the kernels' plain versions)")
    with launched(device) as device:
        run(args, device)


def refuse_ungraphable(args, device: torch.device) -> None:
    """`--steps_per_call > 1` on a card runs CUDA graphs of the step, which
    capture a process group's collectives (FSDP's gathers and
    reduce-scatters too) under NCCL only: under gloo (the rank's card
    shared with another rank) it raises, naming the backend."""
    if args.steps_per_call <= 1 or device.type != "cuda":
        return
    if not distributed.graph_capturable():
        raise RuntimeError(
            f"--steps_per_call > 1 on CUDA captures the data-parallel "
            f"step's collectives in CUDA graphs, which needs NCCL, one card "
            f"a rank; this {torch.distributed.get_backend()} group (ranks "
            f"sharing a card) cannot be captured: run with --steps_per_call "
            f"1 or one rank a card")


def run(args, device: torch.device) -> None:
    """Build the task, resume and train on `device` (the rank's, in its
    process group once launched)."""
    refuse_ungraphable(args, device)
    setup_output(args.output_dir, args)

    dataset = PretrainReportDataset(
        args.data_path, img_size=args.input_size,
        max_caption_length=args.max_caption_length, seed=args.seed,
        output_u8=args.u8_pipe)
    loader = DataLoader(dataset, batch_size=args.batch_size, seed=args.seed,
                        num_workers=args.num_workers,
                        process_index=distributed.rank(),
                        process_count=distributed.world_size())
    steps_per_epoch = max(1, len(loader))
    pconf = cfg.PretrainConfig(
        bert=cfg.BertConfig(exact_attn_dropout=args.exact_attn_dropout),
        optimizer=cfg.OptimizerConfig(
            name="adamw", lr=args.lr, min_lr=args.min_lr,
            weight_decay=args.weight_decay, betas=(0.9, 0.95),
            schedule="warmup_cosine_epoch", warmup_epochs=args.warmup_epochs,
            accum_steps=args.accum_iter),
        data=cfg.DataConfig(img_size=args.input_size,
                            batch_size=args.batch_size),
        mesh=cfg.MeshConfig(shard_optimizer=args.shard_optimizer,
                            shard_params=args.fsdp),
        mask_ratio=args.mask_ratio, epochs=args.epochs,
        max_epoch=args.max_epoch, bf16=not args.no_bf16, seed=args.seed,
        max_caption_length=args.max_caption_length,
        fused_mlm_ce=args.fused_mlm_ce)
    task = PretrainTask(pconf, device=device, steps_per_epoch=steps_per_epoch)
    state = task.init_state()

    start_epoch = skip = 0
    for path in (args.pretrained, args.resume):
        if not path:
            continue
        ckpt = load_checkpoint(path)
        loaded, missing = load_model_state(task.model, ckpt.get("model", ckpt))
        print(f"{path}: loaded {len(loaded)} tensors, {len(missing)} left "
              f"at init")
        # the reference restores optimizer and epoch only from its own
        # checkpoints (util/misc.py:331-338), by file name
        base = os.path.basename(path)
        if (path == args.resume and "optimizer" in ckpt
                and (args.resume_optimizer
                     or base.startswith(("ECAMP", "checkpoint")))):
            state = state.load_optimizer_state_dict(ckpt["optimizer"])
            state = state.load_cycle_state_dict(ckpt.get(CYCLE_KEY),
                                                args.accum_iter)
            print(f"restored AdamW moments for "
                  f"{len(ckpt['optimizer']['state'])} params (torch step "
                  f"{int(adamw_state(state.opt_state).count)})")
            # a preemption checkpoint holds its micro-step, mid-epoch
            step = (int(ckpt["step"]) if "step" in ckpt
                    else (int(ckpt["epoch"]) + 1) * steps_per_epoch
                    if "epoch" in ckpt else None)
            if step is not None:
                start_epoch, skip = divmod(step, steps_per_epoch)
                state.step = torch.full_like(state.step, step)
                task.step = step  # the RNG fold
                print(f"resuming at epoch {start_epoch}"
                      + (f", batch {skip}" if skip else ""))

    guard = PreemptionGuard(
        rss_limit_mb=args.rss_limit_gb * 1024.0 if args.rss_limit_gb
        else None)
    try:
        train(args, task, state, loader, start_epoch, skip, guard)
    finally:
        guard.uninstall()


def superbatches(task: PretrainTask, batches, k: int):
    """Group K host batches into placed (K, B, ...) superbatches, one
    placed ahead of the one being trained; a last group of fewer than K is
    yielded as its list of host batches, for the single step (JAX
    `cli/pretrain.py::_superbatches`)."""
    ahead, group = None, []
    for b in batches:
        group.append(b)
        if len(group) == k:
            placed, group = task.put_superbatch(group), []
            if ahead is not None:
                yield ahead
            ahead = placed
    if ahead is not None:
        yield ahead
    if group:
        yield group


def log_metrics(logger: MetricLogger, metrics) -> None:
    """One logger update a micro-step: `metrics` holds a step's device
    scalars or a call's (K,) stacks."""
    rows = {k: torch.as_tensor(v).reshape(-1).tolist()
            for k, v in metrics.items()}
    for i in range(len(rows["loss"])):
        logger.update(**{k: v[i] for k, v in rows.items()})


def train(args, task: PretrainTask, state, loader: DataLoader,
          start_epoch: int, skip: int, guard: PreemptionGuard) -> None:
    """Epochs `start_epoch` to `args.epochs`, the first without its `skip`
    batches; stops at the micro-step (with `--steps_per_call K`, the call)
    where `guard` asks for a save. Rank 0 logs each completed epoch to
    `log.txt` and the TensorBoard writer; a preempted one logs nothing."""
    jsonl = JsonlLogger(os.path.join(args.output_dir, "log.txt"),
                        enabled=distributed.rank() == 0)
    tb = SummaryWriter(os.path.join(args.output_dir, "tb"),
                       enabled=distributed.rank() == 0)
    try:
        _train_epochs(args, task, state, loader, start_epoch, skip, guard,
                      jsonl, tb)
    finally:
        tb.close()


def _train_epochs(args, task: PretrainTask, state, loader: DataLoader,
                  start_epoch: int, skip: int, guard: PreemptionGuard,
                  jsonl: JsonlLogger, tb: SummaryWriter) -> None:
    ckpt_epochs = pretrain_ckpt_epochs(args.epochs)
    per_call = max(1, args.steps_per_call)
    scan = (task.make_train_step_scan(state, per_call) if per_call > 1
            else None)
    for epoch in range(start_epoch, args.epochs):
        loader.set_epoch(epoch)
        logger = MetricLogger()
        launches = {k: c.value for k, c in _COUNTERS.items()}
        pending = None  # read a step's metrics once the next is issued
        preempted = False
        batches = iter(loader)
        # the loader's order is a function of (seed, epoch): replay it and
        # drop what the interrupted run took
        source = (itertools.islice(batches, skip, None)
                  if epoch == start_epoch and skip else batches)
        if scan is not None:
            source = superbatches(task, source, per_call)
        steps = logger.log_every(source, args.print_freq,
                                 header=f"Epoch [{epoch}]")
        try:
            for item in steps:
                if scan is None or isinstance(item, list):
                    # a micro-step a batch: K = 1, or an epoch's short group
                    for batch in item if isinstance(item, list) else [item]:
                        state, metrics = task.train_step(
                            state, task.put_batch(batch))
                        if pending is not None:
                            log_metrics(logger, pending)
                        pending = metrics
                        preempted = guard.should_save(task.step)
                        if preempted:
                            break
                else:
                    # K micro-steps; a preemption is asked for once a call
                    state, metrics = scan(state, item)
                    if pending is not None:
                        log_metrics(logger, pending)
                    pending = metrics
                    preempted = guard.should_save(task.step, per_call)
                if preempted:
                    break
        finally:
            # leaving mid-epoch: stop the loader's worker threads now
            steps.close()
            if scan is not None:
                source.close()
            batches.close()
        if pending is not None:
            log_metrics(logger, pending)
        if preempted:
            path = save_preemption_checkpoint(
                args.output_dir, task.step, task.model, state,
                args.weight_decay)
            print(f"preemption checkpoint saved @ step {task.step} (epoch "
                  f"{epoch}); resume with --resume {path}"
                  + (f" [{guard.reason}]" if guard.reason else ""))
            return
        jsonl.write({"epoch": epoch,
                     **{k: m.global_avg for k, m in logger.meters.items()},
                     "max_mem_mb": device_memory_mb(),
                     "kernel_launches": {k: c.value - launches[k]
                                         for k, c in _COUNTERS.items()},
                     "micro_steps": task.step,
                     "updates": int(adamw_state(state.opt_state).count)})
        for k in ("loss", "mim_loss", "res_loss", "mlm_loss", "lr"):
            if k in logger.meters:
                tb.add_scalar(f"train/{k}", logger.meters[k].global_avg, epoch)
        tb.flush()
        if epoch in ckpt_epochs:
            path = save_checkpoint(args.output_dir, epoch, task.model, state,
                                   args.weight_decay)
            print(f"saved {path}")


if __name__ == "__main__":
    main()
