"""Pretraining checkpoints in the reference layout (main_pretrain.py:274-292,
util/misc.py:295-338): `checkpoint-<epoch>.pth` holding {'model',
'optimizer', 'epoch'}.

`model` is the port's state dict, whose names are already the reference's
(`nn/mae.py`); `optimizer` is the reference torch.optim.AdamW state dict
(`TrainState.optimizer_state_dict`; under gradient accumulation the inner
AdamW, its step the update count). The JAX package reads both with
`ecamp_tpu/ckpt/torch_import.py::import_ecamp_pretrain` and
`import_ecamp_adamw_state`. Under accumulation one more key, `CYCLE_KEY`,
holds the open cycle (`TrainState.cycle_state_dict`), so a resume is
exact where an epoch ends mid-cycle; a reference file has none and
resumes with an empty cycle.

A preemption checkpoint (`save_preemption_checkpoint`,
`checkpoint-step-<step>.pth`) holds the same keys with the micro-step
`step` in place of `epoch`: the CLI resumes it mid-epoch.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Mapping, Tuple

import torch
from torch import nn


def checkpoint_path(output_dir: str, epoch: int) -> str:
    return os.path.join(output_dir, f"checkpoint-{epoch}.pth")


CYCLE_KEY = "accum_cycle"


def _save(path: str, model: nn.Module, state, weight_decay: float,
          **extra) -> str:
    """Write the model, the AdamW state and the open cycle, if any, with
    `extra` through a temporary file, so a reader never sees half of one;
    returns `path`."""
    payload = {"model": {k: v.detach().cpu()
                         for k, v in model.state_dict().items()},
               "optimizer": state.optimizer_state_dict(weight_decay),
               **extra}
    cycle = state.cycle_state_dict()
    if cycle is not None:
        payload[CYCLE_KEY] = cycle
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def save_checkpoint(output_dir: str, epoch: int, model: nn.Module, state,
                    weight_decay: float) -> str:
    """Write `checkpoint-<epoch>.pth`; returns its path."""
    return _save(checkpoint_path(output_dir, epoch), model, state,
                 weight_decay, epoch=epoch)


def save_preemption_checkpoint(output_dir: str, step: int, model: nn.Module,
                               state, weight_decay: float) -> str:
    """Write `checkpoint-step-<step>.pth` at micro-step `step`, which may
    fall mid-epoch and mid-cycle; returns its path."""
    return _save(os.path.join(output_dir, f"checkpoint-step-{step}.pth"),
                 model, state, weight_decay, step=step)


def load_checkpoint(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=True)


def load_model_state(model: nn.Module, state: Mapping[str, torch.Tensor]
                     ) -> Tuple[List[str], List[str]]:
    """Copy into `model` every entry of a reference state dict whose name
    and shape match one of its parameters (the reference's partial resume
    and MAE-init, util/misc.py:315-338); the visualizer's
    `cross_attn_layer` is read as `context_fusion_layer`. Entries the port
    holds otherwise (the sin-cos tables, HF's tied `cls.predictions.bias`)
    are left out. Returns (loaded names, model names left at init)."""
    state = {k[len("module."):] if k.startswith("module.") else k: v
             for k, v in state.items()}
    state = {k.replace("cross_attn_layer", "context_fusion_layer"): v
             for k, v in state.items()}
    loaded, missing = [], []
    with torch.no_grad():
        for name, p in model.state_dict().items():
            src = state.get(name)
            if src is not None and tuple(src.shape) == tuple(p.shape):
                p.copy_(src.to(p.dtype))
                loaded.append(name)
            else:
                missing.append(name)
    return loaded, missing
