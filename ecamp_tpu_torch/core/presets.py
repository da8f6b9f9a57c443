"""Recipe registry (a copy of `ecamp_tpu/core/presets.py`, which the port
does not import): every run.sh recipe of the reference as a named preset
of arguments for one of the port's CLIs (`ecamp_tpu_torch.cli.*`). Sources:
  pretrain              ECAMP/Pre-training/run.sh
  cls_ft_*              Fine-tuning/Classification/run_ft.sh
  cls_lp_*              Fine-tuning/Classification/run_lp.sh (linear probe)
  seg_*                 Fine-tuning/Segmentation/run.sh
  det_*                 Fine-tuning/Detection/run.sh

Batch sizes are the reference's global ones (it divides them by the world
size in its loaders); the port trains in one process on one card, so a
preset's batch is one card's micro-batch, and `pretrain_mimic`'s 256 x 8
accumulation is its update of 2048 images.
"""

from __future__ import annotations

from typing import Dict, List

PRESETS: Dict[str, Dict] = {}


def _add(name: str, entry: str, **kw):
    PRESETS[name] = {"entry": entry, "args": kw}


# -- pretraining (run.sh:3-16): eff. batch 256*8accum*4gpu = 8192 ------------
_add("pretrain_mimic", "pretrain", batch_size=256, accum_iter=8, epochs=120,
     max_epoch=200, warmup_epochs=40, lr=1.5e-4, weight_decay=0.05,
     mask_ratio=0.75, input_size=448, num_workers=16)

# -- classification full fine-tune (run_ft.sh) -------------------------------
for task, volume, steps, lr, warm, bs in [
    ("ChestX-ray14", "1", 3000, 3e-2, 50, 96),
    ("ChestX-ray14", "10", 3000, 2.4e-2, 50, 768),
    ("ChestX-ray14", "100", 30000, 1e-2, 500, 768),
    ("CheXpert", "1", 30000, 3e-3, 50, 768),
    ("CheXpert", "10", 90000, 5e-3, 1500, 768),
    ("CheXpert", "100", 90000, 4e-3, 1500, 768),
    ("RSNA", "1", 2000, 3e-3, 50, 256),
    ("RSNA", "10", 9000, 3e-3, 50, 768),
    ("RSNA", "100", 90000, 3e-3, 150, 768),
    ("COVIDx", "1", 30000, 3e-2, 50, 256),
    ("COVIDx", "10", 30000, 1e-2, 50, 768),
    ("COVIDx", "100", 30000, 1e-2, 50, 768),
]:
    _add(f"cls_ft_{task}_{volume}", "finetune_cls", task=task,
         data_volume=volume, num_steps=steps, lr=lr, warmup_steps=warm,
         batch_size=bs, img_size=224)

# -- classification linear probe (run_lp.sh) ---------------------------------
for task, volume, steps, lr, warm, bs in [
    ("ChestX-ray14", "1", 3000, 3e-2, 50, 96),
    ("ChestX-ray14", "10", 30000, 2.4e-2, 50, 768),
    ("ChestX-ray14", "100", 30000, 1e-2, 500, 768),
    ("CheXpert", "1", 9000, 3e-3, 150, 768),
    ("CheXpert", "10", 9000, 3e-2, 1500, 1024),
    ("CheXpert", "100", 22500, 3e-2, 3750, 4096),
    ("RSNA", "1", 1000, 1e-2, 50, 96),
    ("RSNA", "10", 5000, 1e-2, 50, 768),
    ("RSNA", "100", 9000, 1e-2, 150, 4096),
    ("COVIDx", "1", 500, 3e-2, 30, 128),
    ("COVIDx", "10", 5000, 3e-2, 350, 128),
    ("COVIDx", "100", 9000, 3e-2, 1750, 256),
]:
    _add(f"cls_lp_{task}_{volume}", "finetune_cls", task=task,
         data_volume=volume, num_steps=steps, lr=lr, warmup_steps=warm,
         batch_size=bs, img_size=224, linear_probe=True)

# -- segmentation (Segmentation/run.sh) --------------------------------------
for task, volume, steps, lr, warm, bs in [
    ("SIIM", "1", 3000, 5e-4, 50, 512),
    ("SIIM", "10", 3000, 5e-4, 150, 1024),
    ("SIIM", "100", 3000, 5e-4, 50, 512),
    ("RSNA", "1", 3000, 3e-4, 50, 96),
    ("RSNA", "10", 1000, 5e-4, 50, 256),
    ("RSNA", "100", 1000, 3e-3, 100, 512),
    ("RIGA", "1", 500, 5e-4, 15, 5),
    ("RIGA", "10", 500, 5e-4, 15, 56),
    ("RIGA", "100", 1000, 5e-4, 20, 128),
]:
    _add(f"seg_{task}_{volume}", "finetune_seg", task=task,
         data_volume=volume, num_steps=steps, lr=lr, warmup_steps=warm,
         batch_size=bs, img_size=224, weight_decay=0.05)

# -- detection (Detection/run.sh) ---------------------------------------------
for volume, steps, lr, warm, bs, start_eval in [
    ("1", 3000, 5e-4, 5, 96, 60),
    ("10", 3000, 5e-4, 5, 256, 100),
    ("100", 20000, 5e-4, 30, 1024, 50),
]:
    _add(f"det_RSNA_{volume}", "finetune_det", data_volume=volume,
         num_steps=steps, lr=lr, warmup_steps=warm, batch_size=bs,
         img_size=224, weight_decay=0.05, start_eval=start_eval)


def preset_argv(name: str) -> List[str]:
    """Render a preset to an argv list for its CLI entry point."""
    p = PRESETS[name]
    argv = []
    for k, v in p["args"].items():
        if isinstance(v, bool):
            if v:
                argv.append(f"--{k}")
        else:
            argv.extend([f"--{k}", str(v)])
    return argv


def list_presets() -> List[str]:
    return sorted(PRESETS)
