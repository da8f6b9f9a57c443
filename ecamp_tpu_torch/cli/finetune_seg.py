"""Segmentation fine-tune entry point of the port (counterpart of
`ecamp_tpu/cli/finetune_seg.py`; reference Segmentation/run.sh + train.py
/ train_RIGA.py), on one CUDA card:

python -m ecamp_tpu_torch.cli.finetune_seg \\
  --task SIIM --dataset_path /data/siim --pretrained ECAMP.pth \\
  --batch_size 512 --lr 5e-4 --warmup_steps 50 --num_steps 3000 \\
  --output_dir ./out

SIIM images are `<dataset_path>/train/images/1024/dicom/<ImageId>.png`,
RSNA and RIGA images (and RIGA's masks) `<dataset_path>/<path in the
list>`; the split lists come from `--list_path`, else
`<dataset_path>/<task>/`, else the ones shipped in the repository
(`data/assets.py`). AdamW with a step warmup-cosine schedule and the mixed
loss train `seg_head` and the decoder(s) of a frozen encoder; with
`--model resnet50` (the smp.Unet baseline, Segmentation/train.py:139-180)
a ResNet-50 UNet trains end to end, its encoder from a torchvision-layout
`--pretrained` `.pth` or from its init (SIIM / RSNA only). It validates
every epoch's worth of optimizer steps (`len(train_loader) // accum`),
stops early after `--patience` validations without a better dice, writes
the best model to `<output_dir>/best/checkpoint-best.pth` as `{"model":
state_dict}` in the reference namespace (what `cli/serve.py --task
segmentation --checkpoint` serves), then reloads it and prints `TEST
dice:`. `<output_dir>/log.txt` gets the JAX CLI's JSON lines (`step`,
`dice`, `best` a validation, with the mean training loss and the
LayerNorm, attention and AdamW launches since the last one, the first
after a resume counting from the resume; `test_dice`). `--device cuda`
(the default) needs a card; `--device cpu` runs the kernels' plain
versions. Preemption and resume: as `cli/finetune_cls.py` (a rerun with
the same `--output_dir`; `--resume` is refused, as the JAX CLI reads it
nowhere).

A training split too small for one batch raises: the JAX CLI's loop would
wait forever for a step (SIIM's 1% and 10% lists balance to 50 and 444
images, under the recipes' 512 and 1024).

Data parallel (`torchrun --nproc_per_node=N -m
ecamp_tpu_torch.cli.finetune_seg ...`) as `cli/finetune_cls.py`: the
batch is per rank, the BatchNorm statistics and the soft dice are the
global batch's (`train/segmentation.py`), each rank scores its shard of
the validation and test splits and the per-sample dice is gathered.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from ..ckpt.convert import load_reference_pth, load_reference_state
from ..core import config as cfg
from ..core import distributed
from ..core.metrics import JsonlLogger
from ..data.assets import resolve_list_root
from ..data.datasets import (RIGASegmentationDataset, RSNASegmentationDataset,
                             SIIMSegmentationDataset)
from ..data.loader import DataLoader
from ..kernels import flash_attention, fused_adamw, layer_norm
from ..train.segmentation import SegmentationTask
from .common import (EarlyStopper, LaunchCounts, ShardedEval,
                     add_common_args, launched, setup_output,
                     sharded_eval_loader, train_finetune)
from .finetune_cls import (BEST, _VIT_FACTORY, refuse_what_is_not_ported,
                           save_best)

DATASETS = {"SIIM": SIIMSegmentationDataset, "RSNA": RSNASegmentationDataset,
            "RIGA": RIGASegmentationDataset}

# the launch counters each validation's log line reports
_COUNTERS = {"layer_norm": layer_norm.launches,
             "attention": flash_attention.launches,
             "adamw": fused_adamw.launches}


def get_args(argv=None):
    p = argparse.ArgumentParser("ecamp_tpu_torch finetune segmentation")
    add_common_args(p)
    p.add_argument("--task", default="SIIM", choices=sorted(DATASETS))
    p.add_argument("--dataset_path", required=True)
    p.add_argument("--list_path", default="",
                   help="dir with <task>/{train,val,test}_list*.csv "
                        "(defaults to dataset_path)")
    p.add_argument("--img_size", type=int, default=224)
    p.add_argument("--model", default="base",
                   choices=sorted(_VIT_FACTORY) + ["resnet50"],
                   help="ViT variant, or 'resnet50' for the ResNet-50 UNet "
                        "baseline (Segmentation/train.py:139-180)")
    p.add_argument("--decode_features", default="512,256,128,64",
                   help="conv-decoder channel widths (reference SegViT "
                        "decode_features, models_vit.py:70-106)")
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--warmup_steps", type=int, default=50)
    p.add_argument("--num_steps", type=int, default=3000)
    p.add_argument("--patience", type=int, default=40)
    p.add_argument("--eval_batch_size", type=int, default=64)
    p.add_argument("--max_grad_norm", type=float, default=1.0,
                   help="global grad-norm clip, every step "
                        "(Segmentation/train.py:388,465); <=0 disables")
    p.add_argument("--gradient_accumulation_steps", type=int, default=1,
                   help="micro-batch = batch_size//accum; the optimizer "
                        "steps once per accum micro-batches")
    p.add_argument("--no_freeze_encoder", action="store_true")
    p.add_argument("--name", default="ecamp",
                   choices=["ecamp", "gloria", "random"],
                   help="pretrained-checkpoint convention of the RIGA "
                        "baselines (train_RIGA.py:110-138); random skips "
                        "loading")
    p.add_argument("--stage", default="train", choices=["train", "test"])
    p.add_argument("--u8_pipe", action="store_true",
                   help="ship images as quantized u8 (1-ch gray for "
                        "SIIM/RSNA, 3-ch for RIGA) and normalize on the "
                        "device")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; needs a card) or cpu")
    return p.parse_args(argv)


def evaluate(task: SegmentationTask, state, loader,
             se: Optional[ShardedEval] = None) -> float:
    """Mean per-sample dice over one pass of an unshuffled loader (RIGA:
    the mean of disc and cup, train_RIGA.py:264-327); the ragged last
    batch runs as it is. With `se` the per-sample dice of the loader's
    shard is gathered from every rank first."""
    dices = []
    for batch in loader:
        probs = task.eval_step(state, task.put(batch["image"]))
        mask = batch["mask"]
        if task.dual:
            disc, cup = (p.cpu().numpy()[..., 0] for p in probs)
            dices.append((task.compute_dice(disc, mask[..., 0])
                          + task.compute_dice(cup, mask[..., 1])) / 2.0)
        else:
            dices.append(task.compute_dice(probs.cpu().numpy()[..., 0],
                                           mask[..., 0]))
    per_sample = np.concatenate(dices)
    if se is not None:
        per_sample = se.gather(per_sample)
    return float(per_sample.mean())


def main(argv=None):
    args = get_args(argv)
    refuse_what_is_not_ported(args)
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
                                  "Segmentation",
                                  f"{args.task}/test_list.csv")
    ds_cls = DATASETS[args.task]
    accum = max(1, args.gradient_accumulation_steps)
    # the ResNet baseline keeps the base ViT config for the fields the
    # config carries (the JAX CLI's choice)
    is_resnet = args.model == "resnet50"
    scfg = cfg.SegmentationConfig(
        backbone="resnet50" if is_resnet else "vit",
        vit=_VIT_FACTORY["base" if is_resnet else args.model](
            img_size=args.img_size),
        decode_features=tuple(int(x) for x
                              in args.decode_features.split(",")),
        optimizer=cfg.OptimizerConfig(
            name="adamw", lr=args.lr, weight_decay=args.weight_decay,
            betas=(0.9, 0.999), schedule="warmup_cosine_step",
            warmup_steps=args.warmup_steps, total_steps=args.num_steps,
            grad_clip=(args.max_grad_norm if args.max_grad_norm > 0
                       else None),
            accum_steps=accum),
        task=args.task, freeze_encoder=not args.no_freeze_encoder,
        patience=args.patience, bf16=not args.no_bf16, seed=args.seed,
        data=cfg.DataConfig(img_size=args.img_size, mean=0.4722, std=0.3028))
    task = SegmentationTask(scfg, device=device)
    state = task.init_state(pretrained=args.pretrained, flavor=args.name)
    best_path = os.path.join(args.output_dir, BEST)
    jsonl = JsonlLogger(os.path.join(args.output_dir, "log.txt"),
                        enabled=distributed.rank() == 0)

    def make_ds(split):
        return ds_cls(list_path, args.dataset_path, split,
                      img_size=args.img_size, data_volume=args.data_volume,
                      seed=args.seed, output_u8=args.u8_pipe)

    def eval_loader(split):
        return sharded_eval_loader(make_ds(split), args.eval_batch_size,
                                   args.num_workers)

    if args.stage == "train":
        # micro-batch = batch // accum (reference train.py:308)
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
        launches = LaunchCounts(_COUNTERS)

        def step_fn(state, batch):
            return task.train_step(state, task.put(batch["image"]),
                                   task.put(batch["mask"]))

        def validate(state, step, epoch, logger):
            dice = evaluate(task, state, val_loader, val_se)
            is_best = stopper.update(dice)
            jsonl.write({"step": step, "dice": dice, "best": stopper.best,
                         "loss": logger.meters["loss"].global_avg,
                         "kernel_launches": launches.take()})
            print(f"step {step}: val dice={dice:.4f} "
                  f"(best {stopper.best:.4f})", flush=True)
            if is_best:
                save_best(best_path, task.model)

        state, preempted = train_finetune(args, task, state, train_loader,
                                          stopper, step_fn, validate)
        if preempted:
            return None

    if os.path.exists(best_path):
        load_reference_state(task.model, load_reference_pth(best_path))
        print(f"loaded {best_path}")
    dice = evaluate(task, state, *eval_loader("test"))
    print(f"TEST dice: {dice:.4f}")
    jsonl.write({"test_dice": dice})
    return dice


if __name__ == "__main__":
    main()
