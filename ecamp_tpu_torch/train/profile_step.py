"""Where one pretraining step spends the card's time.

    python -m ecamp_tpu_torch.train.profile_step [--batch 32] [--out FILE]
        [--fused_mlm_ce]

Builds the full-width `PretrainTask` (the ECAMP of `PretrainConfig()`,
bf16 compute, AdamW at a constant lr; with `--fused_mlm_ce`, the MLM loss
through the fused vocab-projection + CE kernels) with seeded weights and a
seeded `synthetic_batch`, runs two warm-up steps, times five steps on the
host clock, then runs one step under `torch.profiler`, and prints the
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
    ("sr_conv_stack kernel", ("sr_conv_stack_kernel",)),
    ("adamw kernel", ("adamw_multi_kernel",)),
    ("fused CE kernels", ("fused_ce_fwd", "fused_ce_bwd")),
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--fused_mlm_ce", action="store_true")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..core.config import OptimizerConfig, PretrainConfig
    from .pretrain import PretrainTask, synthetic_batch

    if not torch.cuda.is_available():
        print("profile_step needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "--id=0"], capture_output=True, text=True, timeout=60).stdout.strip()
    cfg = PretrainConfig(optimizer=OptimizerConfig(schedule="constant",
                                                   lr=1.5e-4), seed=args.seed,
                         fused_mlm_ce=args.fused_mlm_ce)
    task = PretrainTask(cfg, device="cuda")
    b = args.batch
    batch = synthetic_batch(cfg, b, torch.Generator(device="cuda")
                            .manual_seed(args.seed + 1))
    state = task.init_state()
    for _ in range(2):
        state, _ = task.train_step(state, batch)
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t = time.perf_counter()
        state, _ = task.train_step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    step_ms = sorted(times)[len(times) // 2]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        state, m = task.train_step(state, batch)
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
    mlm = "fused CE" if args.fused_mlm_ce else "materialised logits"
    print(f"one pretraining step ({mlm}), B = {b}, on {card}: {step_ms:.3f} ms "
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
            json.dump({"card": card, "batch": b, "mlm_loss": mlm,
                       "step_ms": times,
                       "profiled_step_ms": wall_ms,
                       "device_busy_ms": busy, "groups_ms": by_group,
                       "kernels": [{"ms": ms, "launches": n, "name": name}
                                   for ms, n, name in kernels]}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
