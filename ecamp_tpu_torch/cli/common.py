"""Shared CLI plumbing (counterpart of `ecamp_tpu/cli/common.py:14-97`):
common arguments, the run directory's provenance, checkpoint cadence and
early stopping.

The JAX package's `pad_eval_batch` has no counterpart: XLA compiles one
program per input shape, so JAX pads the ragged last eval batch to the
static shape, while PyTorch runs eagerly and takes that batch as it is.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
from typing import Optional


def add_common_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    p.add_argument("--output_dir", default="./output")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--data_volume", default="100", choices=["1", "10", "100"])
    p.add_argument("--pretrained", default="",
                   help="reference .pth to initialize from")
    p.add_argument("--resume", default="")
    p.add_argument("--no_bf16", action="store_true")
    return p


def setup_output(output_dir: str, args: argparse.Namespace) -> None:
    """Create the run directory and record its provenance (reference
    main_pretrain.py:214-216,258): the arguments as args.json and
    config.yaml, and a copy of the port's source under code/."""
    os.makedirs(output_dir, exist_ok=True)
    kv = {k: v if isinstance(v, (int, float, bool, type(None))) else str(v)
          for k, v in vars(args).items()}
    with open(os.path.join(output_dir, "args.json"), "w") as f:
        json.dump(kv, f, indent=2)
    with open(os.path.join(output_dir, "config.yaml"), "w") as f:
        for k in sorted(kv):
            v = kv[k]
            if isinstance(v, str):
                v = "'" + v.replace("'", "''") + "'"
            elif v is None:
                v = "null"
            f.write(f"{k}: {v}\n")
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dst = os.path.join(output_dir, "code", "ecamp_tpu_torch")
    if not os.path.exists(dst):
        shutil.copytree(pkg_root, dst, ignore=shutil.ignore_patterns(
            "__pycache__", "*.pyc", "*.so"))


def pretrain_ckpt_epochs(epochs: int, mid_every: int = 10,
                         late_every: int = 5):
    """Checkpoint cadence: epoch 0, every `mid_every` in [60, 100), every
    `late_every` from 100, and the last epoch (main_pretrain.py:274-292)."""
    out = {epochs - 1}
    for e in range(epochs):
        if (e == 0 or (60 <= e < 100 and e % mid_every == 0)
                or (e >= 100 and e % late_every == 0)):
            out.add(e)
    return out


class EarlyStopper:
    """Best-metric tracking + patience (Classification/train.py:427,502)."""

    def __init__(self, patience: int, mode: str = "max"):
        self.patience = patience
        self.mode = mode
        self.best: Optional[float] = None
        self.bad = 0

    def update(self, value: float) -> bool:
        """Returns True when `value` is a new best."""
        better = (self.best is None or
                  (value > self.best if self.mode == "max"
                   else value < self.best))
        if better:
            self.best = value
            self.bad = 0
            return True
        self.bad += 1
        return False

    @property
    def should_stop(self) -> bool:
        return self.bad >= self.patience
