"""Optimizers and LR schedules (counterpart of `ecamp_tpu/train/optim.py`).

AdamW is `kernels.fused_adamw.FusedAdamW`: the multi-tensor kernel for
CUDA parameters, always (the JAX opt-in gate is not carried over), in
optax.adamw's op order, with weight decay only on leaves of ndim > 1 (timm
add_weight_decay, main_pretrain.py:253-254). SGD with momentum (the
linear-probe fine-tune) is plain PyTorch, as optax.sgd has no kernel.

Each schedule maps a step (a tensor, or an int) to an fp32 tensor on the
step's device, so the optimizer reads its lr without a host
synchronisation.

`make_optimizer` wraps the optimizer as the JAX package's optax chain
does: layer-wise lr scales after it (`LayerwiseScaled`), a freeze mask
around that (`Masked`, optax.multi_transform with set_to_zero) and
gradient accumulation (`MultiSteps`, optax.MultiSteps). Every optimizer
here has `init(params) -> state` and `apply(params, grads, state) ->
state`, which updates the parameters in place.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional

import torch

from ..core.config import OptimizerConfig
from ..core.distributed import Zero1
from ..kernels.fused_adamw import FusedAdamW, clip_scale, zero_pieces

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


def layerwise_lr_scales(params: Mapping[str, torch.Tensor], decay: float,
                        num_layers: int) -> Dict[str, float]:
    """BEiT-style layer-wise lr decay scales (reference util/lr_decay.py:
    15-75), by state-dict name: the patch embedding, cls token and pos
    embed at layer 0, `blocks.{i}.*` at i + 1, everything else (norms,
    heads) at num_layers + 1; scale = decay ** (num_layers + 1 - layer)."""

    def layer_id(name: str) -> int:
        m = re.search(r"(?:^|\.)blocks\.(\d+)\.", name)
        if m:
            return int(m.group(1)) + 1
        if any(k in ("patch_embed", "cls_token", "pos_embed")
               for k in name.split(".")):
            return 0
        return num_layers + 1

    return {k: decay ** (num_layers + 1 - layer_id(k)) for k in params}


class LayerwiseScaled:
    """Per-leaf lr multipliers applied after the optimizer (JAX
    `scale_by_layerwise_lr`): a leaf's update u becomes scale * u, as
    p0 + scale * (p1 - p0) around the inner optimizer's in-place step."""

    def __init__(self, inner, scales: Mapping[str, float]):
        self.inner = inner
        self.scales = dict(scales)

    def init(self, params):
        return self.inner.init(params)

    def apply(self, params, grads, state):
        before = {k: params[k].detach().clone() for k in params
                  if self.scales[k] != 1.0}
        state = self.inner.apply(params, grads, state)
        with torch.no_grad():
            for k, p0 in before.items():
                p = params[k]
                p.copy_(p0 + self.scales[k] * (p - p0))
        return state


class Masked:
    """A freeze mask (True = trainable), as optax.multi_transform with
    set_to_zero on the frozen leaves: the inner optimizer sees only the
    trainable leaves, so a frozen leaf gets no update, no weight decay and
    no momentum trace, and a global-norm clip inside the inner optimizer
    sees the trainable leaves only."""

    def __init__(self, inner, mask: Mapping[str, bool]):
        self.inner = inner
        self.mask = dict(mask)

    def _trainable(self, tree):
        # reads the trainable entries only: no frozen leaf's gradient is
        # made when `tree` builds its values on demand (TrainState's)
        return {k: tree[k] for k in tree if self.mask[k]}

    def init(self, params):
        return self.inner.init(self._trainable(params))

    def apply(self, params, grads, state):
        return self.inner.apply(self._trainable(params),
                                self._trainable(grads), state)


@dataclass
class MultiStepsState:
    """optax MultiStepsState: micro-steps into the cycle, the inner
    optimizer's state and the running mean of the cycle's gradients."""

    mini_step: int
    inner_opt_state: Any
    acc_grads: Dict[str, torch.Tensor]


class MultiSteps:
    """Gradient accumulation as optax.MultiSteps (use_grad_mean): every
    call folds its gradients into the running mean acc + (g - acc) / (n + 1)
    (Welford); the k-th call applies the inner optimizer to that mean, and
    the others leave the parameters alone. Counts are host ints, so no call
    synchronises.

    Under data parallelism the gradients a call folds are already averaged
    over the ranks (every micro-step reduces them; the mean of means is the
    same linear mean). Under ZeRO-1 and FSDP (the inner `FusedAdamW`'s
    `zero1`) the running mean holds the rank's piece of each leaf only, as
    JAX's `shard_opt_state_zero1` shards `acc_grads`, and the inner update
    takes it as pieces; under FSDP the gradients folded in are those
    pieces already (the rank's gradient shard)."""

    def __init__(self, inner, every_k: int):
        self.inner = inner
        self.every_k = int(every_k)
        self.zero1 = getattr(inner, "zero1", None)

    def init(self, params) -> MultiStepsState:
        return MultiStepsState(0, self.inner.init(params),
                               zero_pieces(params, self.zero1))

    def apply(self, params, grads, state: MultiStepsState) -> MultiStepsState:
        n = state.mini_step
        acc = state.acc_grads
        z = self.zero1
        whole = z is not None and not z.holds_pieces
        with torch.no_grad():
            for k, a in acc.items():
                g = z.local(grads[k], k) if whole else grads[k]
                a.add_((g.to(a.dtype) - a) / (n + 1))
        if n < self.every_k - 1:
            return MultiStepsState(n + 1, state.inner_opt_state, acc)
        inner = (self.inner.apply(params, acc, state.inner_opt_state)
                 if z is None else
                 self.inner.apply(params, acc, state.inner_opt_state,
                                  sharded=True))
        for a in acc.values():
            a.zero_()
        return MultiStepsState(0, inner, acc)


def make_optimizer(cfg: OptimizerConfig, steps_per_epoch: int = 1,
                   max_epoch: Optional[float] = None,
                   freeze_mask: Optional[Mapping[str, bool]] = None,
                   lr_scales: Optional[Mapping[str, float]] = None,
                   zero1: Optional[Zero1] = None):
    """The optimizer of `cfg`: `FusedAdamW` for adamw, `SGD` for sgd, with
    the global-norm clip inside; then the layer-wise lr scales, the freeze
    mask (True = trainable; the reference's requires_grad_(False),
    Classification/train.py:156-159) and accumulation over
    `cfg.accum_steps` micro-steps, as the JAX package composes them. The
    mask goes outside the accumulation here (optax puts it inside): the
    updates are the same, and no running mean is kept for a frozen leaf.
    Under accumulation a step schedule counts updates, and the epoch
    cosine is read at each cycle's first micro-step, as in the JAX
    package (`ecamp_tpu/train/optim.py:153-165`). `zero1` shards AdamW's
    moments and the running mean over the data-parallel ranks, ZeRO-1's or
    FSDP's share (pretraining: no freeze mask, no lr scales)."""
    if zero1 is not None and (cfg.name != "adamw" or freeze_mask is not None
                              or lr_scales is not None):
        raise ValueError("ZeRO-1 and FSDP shard AdamW without a freeze mask "
                         "or layer-wise lr scales only")
    sched = make_schedule(cfg, steps_per_epoch, max_epoch)
    if cfg.accum_steps > 1 and cfg.schedule == "warmup_cosine_epoch":
        inner_sched, accum = sched, cfg.accum_steps
        sched = lambda u: inner_sched(u * accum)  # noqa: E731
    if cfg.name == "adamw":
        tx = FusedAdamW(sched, b1=cfg.betas[0], b2=cfg.betas[1], eps=1e-8,
                        weight_decay=cfg.weight_decay, mask_fn=_decay_mask,
                        grad_clip=cfg.grad_clip or None, zero1=zero1)
    elif cfg.name == "sgd":
        tx = SGD(sched, cfg.momentum, cfg.weight_decay,
                 grad_clip=cfg.grad_clip or None)
    else:
        raise ValueError(f"unknown optimizer {cfg.name}")
    if lr_scales is not None:
        tx = LayerwiseScaled(tx, lr_scales)
    if cfg.accum_steps > 1:
        tx = MultiSteps(tx, cfg.accum_steps)
    if freeze_mask is not None:
        tx = Masked(tx, freeze_mask)
    return tx
