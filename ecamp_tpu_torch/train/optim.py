"""Optimizers and LR schedules (counterpart of `ecamp_tpu/train/optim.py`).

AdamW is `kernels.fused_adamw.FusedAdamW`: the multi-tensor kernel for
CUDA parameters, always (the JAX opt-in gate is not carried over), in
optax.adamw's op order, with weight decay only on leaves of ndim > 1 (timm
add_weight_decay, main_pretrain.py:253-254). SGD with momentum (the
linear-probe fine-tune) is plain PyTorch, as optax.sgd has no kernel.

Each schedule maps a step (a tensor, or an int) to an fp32 tensor on the
step's device, so the optimizer reads its lr without a host
synchronisation.

Not ported yet, and refused: gradient accumulation, freeze masks and
layer-wise lr scales, which the classification fine-tune needs (ROADMAP
Queue 1 item 9).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional

import torch

from ..core.config import OptimizerConfig
from ..kernels.fused_adamw import FusedAdamW, clip_scale

Schedule = Callable[[torch.Tensor], torch.Tensor]


def _decay_mask(params: Mapping[str, torch.Tensor]) -> Dict[str, bool]:
    """timm add_weight_decay: no decay for 1-d params (biases, norm
    scales); True = apply weight decay."""
    return {k: p.ndim > 1 for k, p in params.items()}


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def epoch_cosine_schedule(base_lr: float, min_lr: float, warmup_epochs: float,
                          max_epoch: float, steps_per_epoch: int) -> Schedule:
    """Per-iteration warmup + half-cosine over fractional epochs
    (util/lr_sched.py:9-21)."""

    def fn(step):
        epoch = _f32(step) / max(steps_per_epoch, 1)
        warm = base_lr * epoch / max(warmup_epochs, 1e-8)
        progress = (epoch - warmup_epochs) / max(max_epoch - warmup_epochs,
                                                 1e-8)
        cos = min_lr + (base_lr - min_lr) * 0.5 * (
            1.0 + torch.cos(math.pi * progress))
        return torch.where(epoch < warmup_epochs, warm, cos)

    return fn


def warmup_cosine_step_schedule(base_lr: float, warmup_steps: int,
                                total_steps: int,
                                cycles: float = 0.5) -> Schedule:
    """WarmupCosineSchedule (utils/scheduler.py:24-41)."""

    def fn(step):
        step = _f32(step)
        warm = step / max(1.0, warmup_steps)
        progress = (step - warmup_steps) / max(1.0, total_steps - warmup_steps)
        cos = torch.clamp(
            0.5 * (1.0 + torch.cos(math.pi * cycles * 2.0 * progress)),
            min=0.0)
        return base_lr * torch.where(step < warmup_steps, warm, cos)

    return fn


def warmup_linear_step_schedule(base_lr: float, warmup_steps: int,
                                total_steps: int) -> Schedule:
    """WarmupLinearSchedule (utils/scheduler.py:8-21)."""

    def fn(step):
        step = _f32(step)
        warm = step / max(1.0, warmup_steps)
        lin = torch.clamp((total_steps - step)
                          / max(1.0, total_steps - warmup_steps), min=0.0)
        return base_lr * torch.where(step < warmup_steps, warm, lin)

    return fn


def make_schedule(cfg: OptimizerConfig, steps_per_epoch: int = 1,
                  max_epoch: Optional[float] = None) -> Schedule:
    if cfg.schedule == "warmup_cosine_epoch":
        return epoch_cosine_schedule(
            cfg.lr, cfg.min_lr, cfg.warmup_epochs,
            max_epoch if max_epoch is not None else 1.0, steps_per_epoch)
    if cfg.schedule == "warmup_cosine_step":
        return warmup_cosine_step_schedule(cfg.lr, cfg.warmup_steps,
                                           cfg.total_steps)
    if cfg.schedule == "warmup_linear_step":
        return warmup_linear_step_schedule(cfg.lr, cfg.warmup_steps,
                                           cfg.total_steps)
    if cfg.schedule == "constant":
        return lambda step: torch.full_like(_f32(step), cfg.lr)
    raise ValueError(f"unknown schedule {cfg.schedule}")


@dataclass
class SGDState:
    """optax.sgd's state: the update count and the momentum trace."""

    count: torch.Tensor
    trace: Dict[str, torch.Tensor]


class SGD:
    """optax.chain([clip], [masked add_decayed_weights], sgd(momentum)):
    g' = clip(g) + wd*p (ndim > 1 leaves), t = g' + momentum*t,
    p -= lr*t, lr = schedule(count). Plain PyTorch, in place."""

    def __init__(self, schedule: Schedule, momentum: float,
                 weight_decay: float, grad_clip: Optional[float] = None):
        self.schedule = schedule
        self.momentum = float(momentum)
        self.weight_decay = float(weight_decay)
        self.grad_clip = grad_clip

    def init(self, params: Mapping[str, torch.Tensor]) -> SGDState:
        dev = next(iter(params.values())).device
        return SGDState(count=torch.zeros((), dtype=torch.int32, device=dev),
                        trace={k: torch.zeros_like(p)
                               for k, p in params.items()})

    def apply(self, params: Mapping[str, torch.Tensor],
              grads: Mapping[str, torch.Tensor], state: SGDState) -> SGDState:
        lr = self.schedule(state.count).to(torch.float32)
        decay = _decay_mask(params)
        gdiv = gmul = None
        if self.grad_clip is not None:
            gdiv, gmul = clip_scale(list(grads.values()), self.grad_clip)
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k].float()
                if gdiv is not None:
                    g = g / gdiv * gmul
                if self.weight_decay > 0 and decay[k]:
                    g = g + self.weight_decay * p
                t = state.trace[k]
                t.copy_(g + self.momentum * t)
                p.add_(-lr * t)
        return SGDState(count=state.count + 1, trace=state.trace)


def make_optimizer(cfg: OptimizerConfig, steps_per_epoch: int = 1,
                   max_epoch: Optional[float] = None,
                   freeze_mask=None, lr_scales=None):
    """The optimizer of `cfg`: `FusedAdamW` for adamw, `SGD` for sgd."""
    if cfg.accum_steps > 1 or freeze_mask is not None or lr_scales is not None:
        raise NotImplementedError(
            "gradient accumulation, freeze masks and layer-wise lr scales "
            "are not ported yet (ROADMAP Queue 1 item 9, the "
            "classification fine-tune)")
    sched = make_schedule(cfg, steps_per_epoch, max_epoch)
    if cfg.name == "adamw":
        return FusedAdamW(sched, b1=cfg.betas[0], b2=cfg.betas[1], eps=1e-8,
                          weight_decay=cfg.weight_decay, mask_fn=_decay_mask,
                          grad_clip=cfg.grad_clip or None)
    if cfg.name == "sgd":
        return SGD(sched, cfg.momentum, cfg.weight_decay,
                   grad_clip=cfg.grad_clip or None)
    raise ValueError(f"unknown optimizer {cfg.name}")
