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

Under data parallelism every rank calls the save (ZeRO-1's moments and
running mean are gathered from every rank first, so the file has the
layout above), rank 0 alone writes, and all ranks wait for the write
before going on. Every rank loads a file, whoever wrote it, and takes its
share (`TrainState.load_optimizer_state_dict`). Under FSDP the
parameters are gathered whole as well (`core/distributed.py::
whole_params`, on every rank), and a load copies into them whole and
then takes the rank's shards back.

The fine-tune CLIs' preemption file (`save_finetune_preemption`,
`<output_dir>/preempt/checkpoint-step-<micro>.pth`, the counterpart of the
JAX CLIs' orbax step directory under `<output_dir>/preempt`) holds
{"model": state dict, with the BatchNorm running statistics as buffers,
"opt_state": `train/state.py::opt_state_dict`, "meta": the counters and
the early stopper's state}; `latest_step_file` finds the newest.
"""

from __future__ import annotations

import os
import re
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn

from ..core import distributed


def checkpoint_path(output_dir: str, epoch: int) -> str:
    return os.path.join(output_dir, f"checkpoint-{epoch}.pth")


CYCLE_KEY = "accum_cycle"


def cpu_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state dict on the host, for a file."""
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def save_on_rank0(path: str, payload: Callable[[], Dict[str, Any]]) -> str:
    """`torch.save(payload())` to `path` through a temporary file, so a
    reader never sees half of one; returns `path`. Every rank calls it;
    rank 0 alone builds the payload and writes, and all wait for the
    write."""
    if distributed.rank() == 0:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        torch.save(payload(), tmp)
        os.replace(tmp, path)
    distributed.barrier()
    return path


def _save(path: str, model: nn.Module, state, weight_decay: float,
          **extra) -> str:
    """Write the model, the AdamW state and the open cycle, if any, with
    `extra` (`save_on_rank0`); returns `path`. The optimizer state, and
    under FSDP the parameters, are gathered on every rank first (a
    collective under ZeRO-1 and FSDP)."""
    optimizer = state.optimizer_state_dict(weight_decay)
    cycle = state.cycle_state_dict()

    def payload():
        out = {"model": cpu_state_dict(model), "optimizer": optimizer,
               **extra}
        if cycle is not None:
            out[CYCLE_KEY] = cycle
        return out

    with distributed.whole_params(model, write_back=False):
        return save_on_rank0(path, payload)


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


def save_finetune_preemption(directory: str, micro: int, model: nn.Module,
                             opt_state: Mapping[str, Any],
                             meta: Mapping[str, Any]) -> str:
    """Write `<directory>/checkpoint-step-<micro>.pth` with the model's
    state dict, `opt_state` (a state dict) and `meta` (`save_on_rank0`:
    the ranks' states are equal); returns its path."""
    return save_on_rank0(
        os.path.join(directory, f"checkpoint-step-{micro}.pth"),
        lambda: {"model": cpu_state_dict(model), "opt_state": opt_state,
                 "meta": dict(meta)})


def latest_step_file(directory: str) -> Optional[str]:
    """The `checkpoint-step-<n>.pth` of the highest n in `directory`, or
    None (JAX `latest_step`)."""
    if not os.path.isdir(directory):
        return None
    steps = [(int(m[1]), name) for name in os.listdir(directory)
             if (m := re.fullmatch(r"checkpoint-step-(\d+)\.pth", name))]
    return os.path.join(directory, max(steps)[1]) if steps else None


def load_checkpoint(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=True)


def load_model_state(model: nn.Module, state: Mapping[str, torch.Tensor]
                     ) -> Tuple[List[str], List[str]]:
    """Copy into `model` every entry of a reference state dict whose name
    and shape match one of its parameters (the reference's partial resume
    and MAE-init, util/misc.py:315-338); the visualizer's
    `cross_attn_layer` is read as `context_fusion_layer`. Entries the port
    holds otherwise (the sin-cos tables, HF's tied `cls.predictions.bias`)
    are left out. Under FSDP every rank calls it (the parameters are
    gathered whole, loaded, and each rank keeps its shards). Returns
    (loaded names, model names left at init)."""
    state = {k[len("module."):] if k.startswith("module.") else k: v
             for k, v in state.items()}
    state = {k.replace("cross_attn_layer", "context_fusion_layer"): v
             for k, v in state.items()}
    loaded, missing = [], []
    with distributed.whole_params(model), torch.no_grad():
        for name, p in model.state_dict().items():
            src = state.get(name)
            if src is not None and tuple(src.shape) == tuple(p.shape):
                p.copy_(src.to(p.dtype))
                loaded.append(name)
            else:
                missing.append(name)
    return loaded, missing
