"""Classification fine-tune / linear-probe entry point of the port
(counterpart of `ecamp_tpu/cli/finetune_cls.py`; reference
Classification/run_{ft,lp}.sh + train.py), on one CUDA card:

python -m ecamp_tpu_torch.cli.finetune_cls \\
  --task ChestX-ray14 --dataset_path /data/chestxray14 \\
  --pretrained ECAMP.pth --batch_size 96 --lr 3e-2 --warmup_steps 50 \\
  --num_steps 3000 --output_dir ./out

or data parallel, one card a rank (`core/distributed.py`; `torchrun
--nproc_per_node=N -m ecamp_tpu_torch.cli.finetune_cls ...`): the batch is
per rank, so the global batch is N times it; each rank trains on its
shard of every epoch (the gradients averaged over the ranks) and scores
its shard of the validation and test splits, whose per-sample results are
gathered (`cli/common.py::ShardedEval`), so every rank computes the same
metrics; rank 0 alone writes `log.txt`, the best `.pth` and the run
directory, and prints.

Images are `<dataset_path>/<path in the list>`; the split lists come from
`--list_path`, else `<dataset_path>/<task>/`, else the ones shipped in the
repository (`data/assets.py`). It validates every epoch's worth of
optimizer steps (`len(train_loader) // accum`), stops early after
`--patience` validations without a better AUROC (accuracy for a
single-label task), writes the best model to
`<output_dir>/best/checkpoint-best.pth` as `{"model": state_dict}` in the
reference's timm namespace (what `cli/serve.py --checkpoint` serves), then
reloads it and tests: per-class AUROC and `TEST mean AUROC`, or `TEST
accuracy`. `<output_dir>/log.txt` gets one JSON line a validation and one
for the test; its `kernel_launches` are the LayerNorm and attention
launches since the last line, and after a resume the first counts from the
resume (the counters live in the process). `--device cuda` (the default)
needs a card; `--device cpu` runs the kernels' plain versions.

Preemption (`cli/common.py::FinetunePreemption`): SIGTERM,
`ECAMP_PREEMPT_AT_STEP=N` (micro-step N) or `ECAMP_RSS_LIMIT_GB` writes
`<output_dir>/preempt/checkpoint-step-N.pth` and exits 0 before the test;
a rerun with the same `--output_dir` (the variable unset) resumes at
micro-step N, bit for bit with the uninterrupted run on the CPU, and
deletes `preempt/` when training ends.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ..ckpt.checkpoint import cpu_state_dict, save_on_rank0
from ..ckpt.convert import load_reference_pth, load_reference_state
from ..core import config as cfg
from ..core import distributed
from ..core.metrics import JsonlLogger
from ..data.assets import resolve_list_root
from ..data.datasets import ClassificationListDataset
from ..data.loader import DataLoader
from ..data.transforms import EvalTransform, TrainTransform
from ..kernels import flash_attention, layer_norm
from ..train.classification import ClassificationTask
from .common import (EarlyStopper, LaunchCounts, ShardedEval,
                     add_common_args, launched, setup_output,
                     sharded_eval_loader, train_finetune)

_VIT_FACTORY = {"tiny": cfg.vit_tiny, "base": cfg.vit_base,
                "base_singlechannel": cfg.vit_base_singlechannel,
                "large": cfg.vit_large, "huge": cfg.vit_huge}

# task -> (num_classes, multilabel) (Classification/train.py:37-44,118-121)
TASKS = {
    "ChestX-ray14": (14, True), "CheXpert": (5, True), "RSNA": (1, True),
    "COVIDx": (3, False), "Aptos": (5, False), "SpineXR": (1, True),
    "ODIR5K": (8, True), "MURED": (20, True),
}

CLASS_NAMES = {
    "ChestX-ray14": ["Atelectasis", "Cardiomegaly", "Effusion", "Infiltration",
                     "Mass", "Nodule", "Pneumonia", "Pneumothorax",
                     "Consolidation", "Edema", "Emphysema", "Fibrosis",
                     "Pleural_Thickening", "Hernia"],
    "CheXpert": ["Atelectasis", "Cardiomegaly", "Consolidation", "Edema",
                 "Pleural Effusion"],
    "RSNA": ["Pneumonia"],
    "ODIR5K": ["Normal", "Diabetes", "Glaucoma", "Cataract",
               "Age related Macular Degeneration", "Hypertension",
               "Pathological Myopia", "Other diseases/abnormalities"],
    "MURED": ["DR", "NORMAL", "MH", "ODC", "TSLN", "ARMD", "DN", "MYA",
              "BRVO", "ODP", "CRVO", "CNV", "RS", "ODE", "LS", "CSR", "HTR",
              "ASR", "CRS", "OTHER"],
}

# the launch counters each validation's log line reports
_COUNTERS = {"layer_norm": layer_norm.launches,
             "attention": flash_attention.launches}

BEST = os.path.join("best", "checkpoint-best.pth")


def get_args(argv=None):
    p = argparse.ArgumentParser("ecamp_tpu_torch finetune classification")
    add_common_args(p)
    p.add_argument("--task", default="ChestX-ray14", choices=sorted(TASKS))
    p.add_argument("--dataset_path", required=True)
    p.add_argument("--list_path", default="",
                   help="dir with <task>/{train,val,test}_list*.txt "
                        "(defaults to dataset_path)")
    p.add_argument("--img_size", type=int, default=224)
    p.add_argument("--model", default="base", choices=sorted(_VIT_FACTORY))
    p.add_argument("--ratio", type=float, default=1.0,
                   help="eval center-crop ratio (Resize(img/ratio)); "
                        "reference default 1 (train.py:574)")
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--warmup_steps", type=int, default=500)
    p.add_argument("--num_steps", type=int, default=3000)
    p.add_argument("--decay_type", default="cosine",
                   choices=["cosine", "linear"])
    p.add_argument("--linear_probe", action="store_true")
    p.add_argument("--drop_path", type=float, default=0.1,
                   help="stochastic depth rate (reference hardcodes 0.1, "
                        "Classification/train.py:127)")
    p.add_argument("--patience", type=int, default=20)
    p.add_argument("--eval_batch_size", type=int, default=128)
    p.add_argument("--max_grad_norm", type=float, default=1.0,
                   help="global grad-norm clip, every step "
                        "(Classification/train.py:459,555); <=0 disables")
    p.add_argument("--gradient_accumulation_steps", type=int, default=1,
                   help="micro-batch = batch_size//accum; the optimizer "
                        "steps once per accum micro-batches")
    p.add_argument("--stage", default="train", choices=["train", "test"])
    p.add_argument("--u8_pipe", action="store_true",
                   help="ship images as the quantized u8 single-channel "
                        "gray and normalize on the device (1/12 the bytes "
                        "of fp32)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; needs a card) or cpu")
    return p.parse_args(argv)


def refuse_what_is_not_ported(args) -> None:
    """What the port leaves out raises, naming ROADMAP's "Not to port"
    list; nothing is ignored silently. `--resume`: the JAX CLI parses it
    and reads it nowhere; a classification or segmentation run resumes by
    a rerun with the same --output_dir (its preemption file)."""
    refused = [
        (bool(args.resume), "--resume (the JAX CLI reads it nowhere; rerun "
         "with the same --output_dir to resume from its preemption file)"),
        (bool(args.pretrained) and not args.pretrained.endswith(".pth"),
         f"{args.pretrained!r}: orbax checkpoint directories (only "
         f"reference .pth files are read)"),
    ]
    for bad, what in refused:
        if bad:
            raise NotImplementedError(f"{what} is not ported to "
                                      f"ecamp_tpu_torch (ROADMAP Queue 1, "
                                      f"\"Not to port\")")


def evaluate(task: ClassificationTask, state, loader,
             se: Optional[ShardedEval] = None) -> dict:
    """Metrics over one pass of an unshuffled loader (the ragged last batch
    as it is); with `se`, the loader's shard's logits and labels are
    gathered from every rank first."""
    logits_all, labels_all = [], []
    for batch in loader:
        logits = task.eval_step(state, task.put(batch["image"]))
        logits_all.append(logits.float().cpu().numpy())
        labels_all.append(batch["label"])
    logits = np.concatenate(logits_all)
    labels = np.concatenate(labels_all)
    if se is not None:
        logits, labels = se.gather(logits), se.gather(labels)
    if not task.cfg.is_multilabel:
        labels = labels.astype(np.int32).ravel() if labels.ndim == 1 else \
            labels.argmax(-1)
    return task.compute_metrics(logits, labels)


def save_best(path: str, model: torch.nn.Module) -> None:
    """`{"model": state_dict}` through a temporary file, so a reader never
    sees half of one; rank 0 writes, every rank waits."""
    save_on_rank0(path, lambda: {"model": cpu_state_dict(model)})


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
                                  "Classification",
                                  f"{args.task}/test_list.txt")
    num_classes, multilabel = TASKS[args.task]
    tt = TrainTransform(args.img_size, 0.4722, 0.3028, seed=args.seed,
                        output_u8=args.u8_pipe)
    et = EvalTransform(args.img_size, 0.4722, 0.3028, crop_ratio=args.ratio,
                       output_u8=args.u8_pipe)
    accum = max(1, args.gradient_accumulation_steps)
    ccfg = cfg.ClassificationConfig(
        vit=dataclasses.replace(_VIT_FACTORY[args.model](
            img_size=args.img_size), drop_path_rate=args.drop_path),
        optimizer=cfg.OptimizerConfig(
            name="sgd", lr=args.lr, weight_decay=args.weight_decay,
            momentum=0.9,
            schedule=("warmup_cosine_step" if args.decay_type == "cosine"
                      else "warmup_linear_step"),
            warmup_steps=args.warmup_steps, total_steps=args.num_steps,
            grad_clip=(args.max_grad_norm if args.max_grad_norm > 0
                       else None),
            accum_steps=accum),
        task=args.task, num_classes=num_classes, is_multilabel=multilabel,
        linear_probe=args.linear_probe, patience=args.patience,
        bf16=not args.no_bf16, seed=args.seed)
    task = ClassificationTask(ccfg, device=device)
    state = task.init_state(pretrained=args.pretrained)
    best_path = os.path.join(args.output_dir, BEST)
    jsonl = JsonlLogger(os.path.join(args.output_dir, "log.txt"),
                        enabled=distributed.rank() == 0)

    def eval_loader(split):
        ds = ClassificationListDataset(list_path, args.dataset_path,
                                       args.task, split, args.data_volume, et)
        return sharded_eval_loader(ds, args.eval_batch_size,
                                   args.num_workers)

    if args.stage == "train":
        train_ds = ClassificationListDataset(list_path, args.dataset_path,
                                             args.task, "train",
                                             args.data_volume, tt)
        # micro-batch = batch // accum (reference train.py:369)
        train_loader = DataLoader(train_ds, max(1, args.batch_size // accum),
                                  shuffle=True, seed=args.seed,
                                  num_workers=args.num_workers,
                                  process_index=distributed.rank(),
                                  process_count=distributed.world_size())
        val_loader, val_se = eval_loader("val")
        stopper = EarlyStopper(args.patience, mode="max")
        metric_key = "auc" if multilabel else "acc"
        launches = LaunchCounts(_COUNTERS)

        def step_fn(state, batch):
            labels = batch["label"]
            if not multilabel:
                labels = labels.argmax(-1).astype(np.int64)
            return task.train_step(state, task.put(batch["image"]),
                                   task.put(labels))

        def validate(state, step, epoch, logger):
            metrics = evaluate(task, state, val_loader, val_se)
            val = metrics[metric_key]
            is_best = stopper.update(val)
            # the launches since the last validation: its steps' and this
            # validation's
            jsonl.write({"step": step, metric_key: val, "best": stopper.best,
                         "loss": logger.meters["loss"].global_avg,
                         "kernel_launches": launches.take()})
            print(f"step {step}: val {metric_key}={val:.4f} "
                  f"(best {stopper.best:.4f})", flush=True)
            if is_best:
                save_best(best_path, task.model)

        state, preempted = train_finetune(args, task, state, train_loader,
                                          stopper, step_fn, validate)
        if preempted:
            return None

    # test phase: reload the best model, per-class report (train.py:267-361)
    if os.path.exists(best_path):
        load_reference_state(task.model, load_reference_pth(best_path))
        print(f"loaded {best_path}")
    metrics = evaluate(task, state, *eval_loader("test"))
    if multilabel:
        names = CLASS_NAMES.get(args.task,
                                [f"class_{i}" for i in range(num_classes)])
        for n, a in zip(names, metrics["per_class_auc"]):
            print(f"  {n}: AUROC {a:.4f}")
        print(f"TEST mean AUROC: {metrics['auc']:.4f}")
    else:
        print(f"TEST accuracy: {metrics['acc']:.4f}")
    jsonl.write({"test": metrics})
    return metrics


if __name__ == "__main__":
    main()
