"""Detection fine-tune entry point of the port (counterpart of
`ecamp_tpu/cli/finetune_det.py`; reference Detection/run.sh + train.py),
on one CUDA card:

python -m ecamp_tpu_torch.cli.finetune_det \\
  --task RSNA --dataset_path /data/rsna --pretrained ECAMP.pth \\
  --batch_size 1024 --lr 5e-4 --weight_decay 0.05 --warmup_steps 30 \\
  --num_steps 20000 --start_eval 50 --output_dir ./out

RSNA images are `<dataset_path>/<image_path in the list>`, ObjectCXR
images and their `.npy` labels `<dataset_path>/resize/<image_name>`; the
split lists come from `--list_path`, else `<dataset_path>/<task>/`, else
the ones shipped in the repository (`data/assets.py`). AdamW with a step
warmup-cosine schedule and the three-scale YOLO loss train `det_head`, the
neck and the head of a frozen encoder; the neck's Bottleneck expansion is
8 for the 1% and 10% volumes, else 4 (train.py:136). `--model resnet50`
is the ResNetDetector baseline (train.py:99-131): a frozen ResNet-50
under the same head, from a torchvision-layout `--pretrained` `.pth` or
from its init. From epoch
`--start_eval` on it validates every epoch's worth of optimizer steps
(`len(train_loader) // accum`): decode + NMS + mAP@[.40:.05:.75] over the
unshuffled validation split (the ragged last batch as it is), stops early
after `--patience` validations without a better mAP, writes the best model
to `<output_dir>/best/checkpoint-best.pth` as `{"model": state_dict,
"step": updates}` in the reference namespace (what `cli/serve.py --task
detection --checkpoint` serves), then reloads it and prints `TEST
mAP@[.40:.05:.75]:`. `<output_dir>/log.txt` gets the JAX CLI's JSON lines
(`step`, `mAP`, `best` a validation, with the mean training loss and the
LayerNorm, attention and AdamW launches since the last one, the first
after a resume counting from the resume; `test_map`).

`--resume` is the reference trainer's best-checkpoint re-entry
(Detection/train.py:176-182), as the JAX CLI does it: the best `.pth` (or
the output directory holding it) gives the weights and BatchNorm
statistics, and the step counter is fast-forwarded to its step (the
epoch and the validations follow it). The optimizer starts afresh, its
update count at 0 with its zero moments, so the lr warms up again and the
bias correction fits the fresh moments. Preemption as in
`cli/finetune_cls.py`: a preemption file under `--output_dir` supersedes
`--resume` (it restores the optimizer too). `--device cuda` (the default)
needs a card; `--device cpu` runs the kernels' plain versions.

Refused: a training split too small for one micro-batch (the JAX CLI's
loop would wait forever for a step).

Data parallel (`torchrun --nproc_per_node=N -m
ecamp_tpu_torch.cli.finetune_det ...`) as `cli/finetune_cls.py`: the
batch is per rank, the BatchNorm statistics are the global batch's
(`train/detection.py`), each rank scores its shard of the validation and
test splits and the boxes are gathered (`ShardedEval.gather_ragged`);
`--resume`'s fast-forward and a preemption file act on every rank alike.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from ..ckpt.checkpoint import cpu_state_dict, save_on_rank0
from ..ckpt.convert import load_reference_state
from ..core import config as cfg
from ..core import distributed
from ..core.metrics import JsonlLogger
from ..data.assets import resolve_list_root
from ..data.datasets import ObjectCXRDetectionDataset, RSNADetectionDataset
from ..data.loader import DataLoader
from ..kernels import flash_attention, fused_adamw, layer_norm
from ..train.detection import DetectionTask
from .common import (EarlyStopper, LaunchCounts, ShardedEval,
                     add_common_args, launched, setup_output,
                     sharded_eval_loader, train_finetune)
from .finetune_cls import BEST, _VIT_FACTORY, refuse_what_is_not_ported

DATASETS = {"RSNA": RSNADetectionDataset,
            "ObjectCXR": ObjectCXRDetectionDataset}

# the launch counters each validation's log line reports
_COUNTERS = {"layer_norm": layer_norm.launches,
             "attention": flash_attention.launches,
             "adamw": fused_adamw.launches}


def get_args(argv=None):
    p = argparse.ArgumentParser("ecamp_tpu_torch finetune detection")
    add_common_args(p)
    p.add_argument("--task", default="RSNA", choices=sorted(DATASETS))
    p.add_argument("--dataset_path", required=True)
    p.add_argument("--list_path", default="",
                   help="dir with <task>/{train,val,test}_list*.csv "
                        "(defaults to dataset_path)")
    p.add_argument("--img_size", type=int, default=224)
    p.add_argument("--model", default="base",
                   choices=sorted(_VIT_FACTORY) + ["resnet50"],
                   help="ViT variant, or 'resnet50' for the ResNetDetector "
                        "baseline (Detection/train.py:99-131)")
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--weight_decay", type=float, default=1e-6)
    p.add_argument("--warmup_steps", type=int, default=50)
    p.add_argument("--num_steps", type=int, default=3000)
    p.add_argument("--patience", type=int, default=20)
    p.add_argument("--eval_batch_size", type=int, default=64)
    p.add_argument("--conf_threshold", type=float, default=0.5)
    p.add_argument("--nms_threshold", type=float, default=0.5)
    p.add_argument("--max_grad_norm", type=float, default=1.0,
                   help="global grad-norm clip, every step "
                        "(Detection/train.py:483,559); <=0 disables")
    p.add_argument("--gradient_accumulation_steps", type=int, default=1,
                   help="micro-batch = batch_size//accum; the optimizer "
                        "steps once per accum micro-batches")
    p.add_argument("--start_eval", type=int, default=1,
                   help="skip validation before this epoch (train.py "
                        "--start_eval)")
    p.add_argument("--stage", default="train", choices=["train", "test"])
    p.add_argument("--u8_pipe", action="store_true",
                   help="ship images as the quantized u8 single-channel "
                        "gray and normalize on the device")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; needs a card) or cpu")
    return p.parse_args(argv)


def _gt_xyxy(targets: np.ndarray, img_size: int):
    """(B, T, 5) normalised cxcywh -> list of (n, 4) xyxy pixel arrays
    (Detection/train.py:252-261)."""
    out = []
    for rows in targets:
        valid = rows[rows.sum(-1) > 0]
        if len(valid) == 0:
            out.append(np.zeros((0, 4), np.float32))
            continue
        cx, cy, w, h = (valid[:, 1] * img_size, valid[:, 2] * img_size,
                        valid[:, 3] * img_size, valid[:, 4] * img_size)
        out.append(np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                            axis=1))
    return out


def evaluate(task: DetectionTask, state, loader, img_size: int,
             se: Optional[ShardedEval] = None) -> float:
    """mAP@[.40:.05:.75] over one pass of an unshuffled loader; the ragged
    last batch runs as it is. With `se` the loader's shard's detections
    (their boxes and confidences) and ground truth are gathered from every
    rank first."""
    all_dets, all_gts = [], []
    for batch in loader:
        preds = task.eval_step(state, task.put(batch["image"]))
        all_dets.extend(task.detections(preds))
        all_gts.extend(_gt_xyxy(batch["target"], img_size))
    if se is not None:
        all_dets = se.gather_ragged(all_dets, cols=5)
        all_gts = [g if g is not None else np.zeros((0, 4), np.float32)
                   for g in se.gather_ragged(all_gts, cols=4)]
    return task.compute_map(all_dets, all_gts)


def save_best(path: str, model: torch.nn.Module, step: int) -> None:
    """`{"model": state_dict, "step": updates}` through a temporary file,
    so a reader never sees half of one; rank 0 writes, every rank
    waits."""
    save_on_rank0(path, lambda: {"model": cpu_state_dict(model),
                                 "step": int(step)})


def load_best(path: str, model: torch.nn.Module) -> int:
    """Strict-load a `.pth` that `save_best` wrote; returns its step."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    load_reference_state(model, ckpt["model"])
    return int(ckpt.get("step", 0))


def main(argv=None):
    args = get_args(argv)
    # --resume is this CLI's own best-checkpoint re-entry
    refuse_what_is_not_ported(argparse.Namespace(**{**vars(args),
                                                    "resume": ""}))
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA card (--device cpu "
                           "runs the kernels' plain versions)")
    with launched(device) as device:
        return run(args, device)


def run(args, device: torch.device):
    """Train, validate and test on `device` (the rank's)."""
    setup_output(args.output_dir, args)
    list_path = resolve_list_root(args.list_path, args.dataset_path,
                                  "Detection", f"{args.task}/test_list.csv")
    expansion = 8 if args.data_volume in ("1", "10") else 4  # train.py:136
    accum = max(1, args.gradient_accumulation_steps)
    # the ResNet baseline keeps the base ViT config for the fields the
    # config carries (the JAX CLI's choice)
    is_resnet = args.model == "resnet50"
    dcfg = cfg.DetectionConfig(
        backbone="resnet50" if is_resnet else "vit",
        vit=_VIT_FACTORY["base" if is_resnet else args.model](
            img_size=args.img_size),
        optimizer=cfg.OptimizerConfig(
            name="adamw", lr=args.lr, weight_decay=args.weight_decay,
            betas=(0.9, 0.999), schedule="warmup_cosine_step",
            warmup_steps=args.warmup_steps, total_steps=args.num_steps,
            grad_clip=(args.max_grad_norm if args.max_grad_norm > 0
                       else None),
            accum_steps=accum),
        task=args.task, img_size=args.img_size, expansion=expansion,
        conf_threshold=args.conf_threshold, nms_threshold=args.nms_threshold,
        patience=args.patience, bf16=not args.no_bf16, seed=args.seed)
    task = DetectionTask(dcfg, device=device)
    state = task.init_state(pretrained=args.pretrained)
    best_path = os.path.join(args.output_dir, BEST)
    jsonl = JsonlLogger(os.path.join(args.output_dir, "log.txt"),
                        enabled=distributed.rank() == 0)
    ds_cls = DATASETS[args.task]

    def make_ds(split):
        return ds_cls(list_path, args.dataset_path, split,
                      img_size=args.img_size, data_volume=args.data_volume,
                      output_u8=args.u8_pipe)

    def eval_loader(split):
        return sharded_eval_loader(make_ds(split), args.eval_batch_size,
                                   args.num_workers)

    if args.stage == "train":
        # micro-batch = batch // accum (reference train.py semantics)
        train_ds = make_ds("train")
        micro_bs = max(1, args.batch_size // accum)
        train_loader = DataLoader(train_ds, micro_bs, shuffle=True,
                                  seed=args.seed,
                                  num_workers=args.num_workers,
                                  process_index=distributed.rank(),
                                  process_count=distributed.world_size())
        if len(train_loader) == 0:
            world = distributed.world_size()
            shard = (f" ({-(-len(train_ds) // world)} a rank of {world})"
                     if world > 1 else "")
            raise ValueError(
                f"the {args.task} training split holds {len(train_ds)} "
                f"images{shard}, fewer than one micro-batch of {micro_bs}: "
                f"an epoch would have no step (the JAX CLI waits forever "
                f"here); lower --batch_size")
        val_loader, val_se = eval_loader("val")
        stopper = EarlyStopper(args.patience, mode="max")
        step = epoch = 0
        if args.resume:
            path = args.resume if args.resume.endswith(".pth") else \
                os.path.join(args.resume, BEST)
            step = load_best(path, task.model)
            # state.step counts micro-steps; the optimizer keeps its init
            state.step.fill_(step * accum)
            epoch = step // max(1, len(train_loader) // accum)
            print(f"resumed from step {step} ({path})")
        launches = LaunchCounts(_COUNTERS)

        def step_fn(state, batch):
            state, m = task.train_step(state, task.put(batch["image"]),
                                       task.put(batch["target"]))
            return state, {"loss": m["loss"]}

        def validate(state, step, epoch, logger):
            if epoch + 1 < args.start_eval:
                return
            ap = evaluate(task, state, val_loader, args.img_size, val_se)
            is_best = stopper.update(ap)
            jsonl.write({"step": step, "mAP": ap, "best": stopper.best,
                         "loss": logger.meters["loss"].global_avg,
                         "kernel_launches": launches.take()})
            print(f"step {step}: val mAP={ap:.4f} "
                  f"(best {stopper.best:.4f})", flush=True)
            if is_best:
                save_best(best_path, task.model, step)

        # a preemption file under --output_dir supersedes --resume
        state, preempted = train_finetune(
            args, task, state, train_loader, stopper, step_fn, validate,
            micro=step * accum, step=step, epoch=epoch)
        if preempted:
            return None

    if os.path.exists(best_path):
        load_best(best_path, task.model)
        print(f"loaded {best_path}")
    test_loader, test_se = eval_loader("test")
    ap = evaluate(task, state, test_loader, args.img_size, test_se)
    print(f"TEST mAP@[.40:.05:.75]: {ap:.4f}")
    jsonl.write({"test_map": ap})
    return ap


if __name__ == "__main__":
    main()
