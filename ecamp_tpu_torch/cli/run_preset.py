"""Run a named recipe preset (`core/presets.py` holds every reference
run.sh recipe) through the port's CLI for it:

    python -m ecamp_tpu_torch.cli.run_preset pretrain_mimic \\
        --data_path /data/mimic --output_dir ./out
    python -m ecamp_tpu_torch.cli.run_preset cls_ft_ChestX-ray14_1 \\
        --dataset_path /data/cxr14 --pretrained checkpoint-119.pth
    python -m ecamp_tpu_torch.cli.run_preset list

The preset's arguments come first and the ones given here after them, so
a flag given here overrides the preset's (`--batch_size 32`) and adds the
paths and the device (`--device cpu`).

A pretraining preset also runs data-parallel under a launcher, one rank a
card, the preset's batch per rank (`cli/pretrain.py`, which joins the
ranks before it touches a device):

    torchrun --nproc_per_node=8 -m ecamp_tpu_torch.cli.run_preset \
        pretrain_mimic --data_path /data/mimic [--shard_optimizer]
"""

from __future__ import annotations

import importlib
import sys

from ..core.presets import PRESETS, list_presets, preset_argv


def main(argv=None):
    """`argv` as the command line after the program's name (default
    `sys.argv[1:]`); returns what the entry point's `main` returns."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help", "list"):
        print("available presets:")
        for name in list_presets():
            print(f"  {name}  ->  {PRESETS[name]['entry']}")
        return None
    name = argv[0]
    if name not in PRESETS:
        raise SystemExit(f"unknown preset {name!r}; run with 'list'")
    mod = importlib.import_module(f"{__package__}.{PRESETS[name]['entry']}")
    return mod.main(preset_argv(name) + argv[1:])


if __name__ == "__main__":
    main()
