"""Where one pretraining or fine-tune step spends the card's time.

    python -m ecamp_tpu_torch.train.profile_step [--batch 32] [--out FILE]
        [--fused_mlm_ce]
    python -m ecamp_tpu_torch.train.profile_step --finetune [--batch 96]
        [--linear_probe] [--out FILE]
    python -m ecamp_tpu_torch.train.profile_step --segmentation
        [--batch 512] [--dual | --resnet50] [--out FILE]
    python -m ecamp_tpu_torch.train.profile_step --detection
        [--batch 1024] [--expansion 8 | --resnet50] [--out FILE]

Builds the full-width `PretrainTask` (the ECAMP of `PretrainConfig()`,
bf16 compute, AdamW at a constant lr; with `--fused_mlm_ce`, the MLM loss
through the fused vocab-projection + CE kernels) with seeded weights and a
seeded `synthetic_batch`, or with `--finetune` the `ClassificationTask` of
the recipe cls_ft_ChestX-ray14_1 (ViT-B/16 at 224, 14 multilabel classes,
bf16, SGD momentum 0.9, lr 3e-2 past its warmup, clip 1.0, drop-path 0.1;
`--linear_probe` freezes all but the head), or with `--segmentation` the
`SegmentationTask` of the recipe seg_SIIM_100 (SegViT at 224, bf16,
encoder frozen, AdamW lr 5e-4 past its warmup, wd 0.05, clip 1.0;
`--dual`: SegViTDual, RIGA) on a seeded u8 batch, or with `--detection`
the `DetectionTask` of the recipe det_RSNA_100 (the ViT-B/16 detector at
224, neck expansion 4, or 8 with `--expansion 8` as det_RSNA_10 at
`--batch 256`; bf16, encoder frozen, AdamW lr 5e-4 past its warmup, wd
0.05, clip 1.0) on a seeded u8 batch with 1-3 boxes an image; with
`--resnet50` either one's ResNet-50 baseline (the UNet trained end to end,
or the detector with its ResNet-50 frozen), runs two
warm-up steps, times five steps on the host clock, then runs one step
under `torch.profiler`, and prints the
device time of that step by kernel group (the port's kernels, GEMMs,
convolutions, copies, other elementwise), the top kernels by name, and the
device's idle share of the median unprofiled step (the profiler itself
lengthens the host's side of a step). `--out` also writes the numbers as
JSON. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Dict

GROUPS = (  # (group, substrings of the kernel name), first match wins
    ("attention kernel", ("attention_fwd",)),
    ("layer_norm kernel", ("ln_fwd",)),
    ("sr_conv_stack kernel", ("sr_conv_stack",)),  # generic and TMA
    ("adamw kernel", ("adamw_multi_kernel",)),
    ("fused CE kernels", ("fused_ce_fwd", "fused_ce_bwd")),
    # before "gemm": a name of the int8 kernel holding "gemm" stays here
    ("int8 linear kernel", ("int8_linear",)),
    # cuDNN's convolutions (the SR backward) are implicit GEMMs: test first
    ("convolution", ("cudnn", "fprop", "dgrad", "wgrad", "conv")),
    ("gemm", ("gemm", "nvjet", "cutlass", "cublas", "splitk")),
    ("copy / memset", ("memcpy", "memset")),
)


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other elementwise / reductions"


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _pretrain_step(args, b, gen):
    """One full-width pretraining step on a seeded batch, as a function of
    no arguments returning its metrics."""
    from ..core.config import OptimizerConfig, PretrainConfig
    from .pretrain import PretrainTask, synthetic_batch

    cfg = PretrainConfig(optimizer=OptimizerConfig(schedule="constant",
                                                   lr=1.5e-4), seed=args.seed,
                         fused_mlm_ce=args.fused_mlm_ce)
    task = PretrainTask(cfg, device="cuda")
    batch = synthetic_batch(cfg, b, gen)
    box = [task.init_state()]

    def step():
        box[0], m = task.train_step(box[0], batch)
        return m

    mlm = "fused CE" if args.fused_mlm_ce else "materialised logits"
    return step, f"pretraining ({mlm})"


def _finetune_step(args, b, gen):
    """One fine-tune (or linear-probe) step of the recipe
    cls_ft_ChestX-ray14_1 on a seeded u8 batch; the warmup is set to 0 so
    that every step updates."""
    import torch

    from ..core import config as c
    from .classification import ClassificationTask

    cfg = c.ClassificationConfig(
        vit=c.ViTConfig(drop_path_rate=0.1), linear_probe=args.linear_probe,
        optimizer=c.OptimizerConfig(name="sgd", lr=3e-2, weight_decay=0.0,
                                    schedule="warmup_cosine_step",
                                    warmup_steps=0, total_steps=3000,
                                    grad_clip=1.0), seed=args.seed)
    task = ClassificationTask(cfg, device="cuda")
    images = torch.randint(0, 256, (b, 224, 224, 1), dtype=torch.uint8,
                           device="cuda", generator=gen)
    labels = (torch.rand(b, cfg.num_classes, device="cuda", generator=gen)
              < 0.3).float()
    box = [task.init_state()]

    def step():
        box[0], m = task.train_step(box[0], images, labels)
        return m

    return step, "linear-probe" if args.linear_probe else "fine-tune"


def _segmentation_step(args, b, gen):
    """One frozen-encoder segmentation step of the recipe seg_SIIM_100 (or
    RIGA's SegViTDual) on a seeded u8 batch with random masks; the warmup
    is set to 0 so that every step updates."""
    import torch

    from ..core import config as c
    from .segmentation import SegmentationTask

    cfg = c.SegmentationConfig(
        task="RIGA" if args.dual else "SIIM",
        backbone="resnet50" if args.resnet50 else "vit",
        optimizer=c.OptimizerConfig(name="adamw", lr=5e-4, weight_decay=0.05,
                                    betas=(0.9, 0.999),
                                    schedule="warmup_cosine_step",
                                    warmup_steps=0, total_steps=3000,
                                    grad_clip=1.0), seed=args.seed)
    task = SegmentationTask(cfg, device="cuda")
    images = torch.randint(0, 256, (b, 224, 224, 1), dtype=torch.uint8,
                           device="cuda", generator=gen)
    masks = (torch.rand(b, 224, 224, 2 if args.dual else 1, device="cuda",
                        generator=gen) < 0.1).float()
    box = [task.init_state()]

    def step():
        box[0], m = task.train_step(box[0], images, masks)
        return m

    return step, ("segmentation (RIGA, dual)" if args.dual else
                  "segmentation (ResNet-50 UNet)" if args.resnet50 else
                  "segmentation")


def _detection_step(args, b, gen):
    """One frozen-encoder detection step of the recipe det_RSNA_100 (or
    det_RSNA_10 with `--expansion 8`) on a seeded u8 batch with 1-3
    seeded boxes an image (padded to 10); the warmup is set to 0 so that
    every step updates."""
    from ..core import config as c
    from ..data.synthetic import detection_batch
    from .detection import DetectionTask

    cfg = c.DetectionConfig(
        expansion=args.expansion,
        backbone="resnet50" if args.resnet50 else "vit",
        optimizer=c.OptimizerConfig(name="adamw", lr=5e-4, weight_decay=0.05,
                                    betas=(0.9, 0.999),
                                    schedule="warmup_cosine_step",
                                    warmup_steps=0, total_steps=20000,
                                    grad_clip=1.0), seed=args.seed)
    task = DetectionTask(cfg, device="cuda")
    images, targets = detection_batch(b, cfg.max_objects, gen)
    box = [task.init_state()]

    def step():
        box[0], m = task.train_step(box[0], images, targets)
        return m

    return step, ("detection (ResNet-50)" if args.resnet50 else
                  f"detection (expansion {args.expansion})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=None,
                    help="32 (pretraining), 96 (--finetune), 512 "
                         "(--segmentation) or 1024 (--detection)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--fused_mlm_ce", action="store_true")
    ap.add_argument("--finetune", action="store_true")
    ap.add_argument("--linear_probe", action="store_true")
    ap.add_argument("--segmentation", action="store_true")
    ap.add_argument("--dual", action="store_true")
    ap.add_argument("--detection", action="store_true")
    ap.add_argument("--expansion", type=int, default=4,
                    help="--detection: the neck's Bottleneck expansion")
    ap.add_argument("--resnet50", action="store_true",
                    help="--segmentation / --detection: the ResNet-50 "
                         "baseline")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_step needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "--id=0"], capture_output=True, text=True, timeout=60).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    if args.detection:
        b = args.batch or 1024
        step, what = _detection_step(args, b, gen)
    elif args.segmentation:
        b = args.batch or 512
        step, what = _segmentation_step(args, b, gen)
    elif args.finetune:
        b = args.batch or 96
        step, what = _finetune_step(args, b, gen)
    else:
        b = args.batch or 32
        step, what = _pretrain_step(args, b, gen)
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    step_ms = sorted(times)[len(times) // 2]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        m = step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_group: Dict[str, float] = {}
    kernels = []
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) is None:
            continue
        us = _device_us(evt)
        if us <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kernels.append((us / 1e3, evt.count, evt.key))
        g = group_of(evt.key)
        by_group[g] = by_group.get(g, 0.0) + us / 1e3
    busy = sum(by_group.values())
    kernels.sort(reverse=True)
    print(f"one {what} step, B = {b}, on {card}: {step_ms:.3f} ms "
          f"median of 5 on the host clock ({wall_ms:.3f} ms profiled), "
          f"device busy {busy:.3f} ms, idle share {1 - busy / step_ms:.3f}; "
          f"loss {float(m['loss']):.5f}")
    for g, ms in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"  {g:32s} {ms:9.3f} ms  {ms / busy:6.1%}")
    print("top kernels (ms, launches, name):")
    for ms, n, name in kernels[:25]:
        print(f"  {ms:9.3f} {n:5d}  {name[:110]}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "batch": b, "step": what,
                       "step_ms": times,
                       "profiled_step_ms": wall_ms,
                       "device_busy_ms": busy, "groups_ms": by_group,
                       "kernels": [{"ms": ms, "launches": n, "name": name}
                                   for ms, n, name in kernels]}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
