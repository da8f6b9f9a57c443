"""Train state (counterpart of `ecamp_tpu/train/state.py`): the step, the
parameters, and the optimizer state (for AdamW the optax-style count, mu
and nu).

The parameters are the model's own `nn.Parameter`s, keyed by state-dict
name and updated in place by the optimizer. The AdamW moments round-trip
to the reference's torch.optim.AdamW layout (`exp_avg` / `exp_avg_sq`,
indexed in the order timm's add_weight_decay gives torch: the no-decay
group, then the decay group), the layout `ecamp_tpu/ckpt/torch_import.py::
import_ecamp_adamw_state` reads. Under gradient accumulation that layout
holds the inner AdamW (its step the update count); the open cycle
(`MultiStepsState.mini_step` and the running mean `acc_grads`) has a
state dict of its own (`cycle_state_dict`). Under ZeRO-1 (`zero1`) the
moments and the running mean hold this rank's pieces: their state dicts
gather the whole leaves from every rank first (a collective every rank
calls), and loading one takes the rank's pieces, so a file has the same
layout whatever wrote it and loads into any number of ranks. Under FSDP
(a share that `holds_pieces`) the parameters themselves are this rank's
pieces (`core/distributed.py::Fsdp.pieces`, views of its shards whose
`.grad` views its gradient shard); what reads a leaf's shape reads the
share's (`leaf_shaped`), and the model's whole parameters are gathered
where a file needs them (`ckpt/checkpoint.py`).

`opt_state_dict` / `load_opt_state_dict` round-trip every fine-tune
optimizer state whole (the fine-tune CLIs' preemption files): SGD's count
and trace, AdamW's count and moments, and under accumulation the open
cycle around either. `Masked` keeps state for the trainable leaves only
and `LayerwiseScaled` none of its own, so the state of either is its
inner optimizer's.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn

from ..core.distributed import Zero1
from ..kernels.fused_adamw import AdamWState, leaf_shaped
from .optim import MultiStepsState, SGDState


def reference_param_order(params: Mapping[str, torch.Tensor]
                          ) -> Tuple[List[str], int]:
    """The reference AdamW's parameter indices: no-decay params (ndim <= 1
    or a `.bias`) first, then the rest, each in state-dict order. Returns
    (names in index order, size of the no-decay group)."""
    no_decay = [k for k, p in params.items()
                if p.ndim <= 1 or k.endswith(".bias")]
    skip = set(no_decay)
    return no_decay + [k for k in params if k not in skip], len(no_decay)


def adamw_state(opt_state) -> AdamWState:
    """The AdamW state of `opt_state`, inside a `MultiStepsState` under
    accumulation; a TypeError for any other optimizer."""
    if isinstance(opt_state, MultiStepsState):
        opt_state = opt_state.inner_opt_state
    if not isinstance(opt_state, AdamWState):
        raise TypeError("only an AdamW state has the reference layout")
    return opt_state


class _Grads(Mapping):
    """The parameters' `.grad`s by name, a missing one read as zeros, made
    only when the optimizer reads it (`Masked` reads the trainable leaves
    alone, so a frozen trunk makes none)."""

    def __init__(self, params: Mapping[str, torch.Tensor]):
        self._params = params

    def __getitem__(self, k: str) -> torch.Tensor:
        p = self._params[k]
        return p.grad if p.grad is not None else torch.zeros_like(p)

    def __iter__(self):
        return iter(self._params)

    def __len__(self) -> int:
        return len(self._params)


@dataclass
class TrainState:
    step: torch.Tensor                 # int32 device scalar
    params: Dict[str, torch.Tensor]    # the model's parameters, by name
    opt_state: Any                     # AdamWState or SGDState
    zero1: Optional[Zero1] = None      # the optimizer's ZeRO-1 / FSDP share

    @classmethod
    def create(cls, model: nn.Module, tx) -> "TrainState":
        """The step at 0, the parameters (under FSDP the rank's pieces)
        and the optimizer's fresh state."""
        zero1 = getattr(tx, "zero1", None)
        params = (zero1.dp.pieces if zero1 is not None and zero1.holds_pieces
                  else dict(model.named_parameters()))
        dev = next(iter(params.values())).device
        return cls(step=torch.zeros((), dtype=torch.int32, device=dev),
                   params=params, opt_state=tx.init(params), zero1=zero1)

    def apply_gradients(self, tx) -> "TrainState":
        """One optimizer update from the parameters' `.grad` (a missing
        gradient counts as zero, as JAX's would be). The step advances in
        place, as the parameters do, so a CUDA graph of the update reads
        the current step at every replay."""
        opt_state = tx.apply(self.params, _Grads(self.params), self.opt_state)
        with torch.no_grad():
            self.step.add_(1)
        return replace(self, opt_state=opt_state)

    def _whole(self, tree: Mapping[str, torch.Tensor]
               ) -> Mapping[str, torch.Tensor]:
        """Per-leaf optimizer tensors as whole leaves (under ZeRO-1 gathered
        from every rank)."""
        return tree if self.zero1 is None else self.zero1.gather(tree)

    def _mine(self, whole: Mapping[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        """Whole leaves of a file as this state's fp32 tensors on the
        parameters' devices (under ZeRO-1 the rank's pieces)."""
        if self.zero1 is not None:
            return self.zero1.take(whole, self.step.device)
        return {k: v.to(self.params[k].device, torch.float32).reshape(
            self.params[k].shape) for k, v in whole.items()}

    def optimizer_state_dict(self, weight_decay: float = 0.0
                             ) -> Dict[str, Any]:
        """The AdamW state as a reference torch.optim.AdamW state dict
        (CPU tensors; Linear weights stay (out, in), as the moments live in
        the weight's coordinates)."""
        st = adamw_state(self.opt_state)
        order, n_nd = reference_param_order(leaf_shaped(self.params,
                                                        self.zero1))
        step = st.count.detach().float().cpu()
        mu, nu = self._whole(st.mu), self._whole(st.nu)
        return {
            "state": {i: {"step": step.clone(),
                          "exp_avg": mu[k].detach().cpu().clone(),
                          "exp_avg_sq": nu[k].detach().cpu().clone()}
                      for i, k in enumerate(order)},
            "param_groups": [
                {"params": list(range(n_nd)), "weight_decay": 0.0},
                {"params": list(range(n_nd, len(order))),
                 "weight_decay": weight_decay}]}

    def load_optimizer_state_dict(self, sd: Mapping[str, Any]) -> "TrainState":
        """The inverse of `optimizer_state_dict`: moments and count from a
        reference AdamW state dict, copied onto the parameters' devices
        (under accumulation into the inner state; the cycle is kept)."""
        adamw_state(self.opt_state)
        order, n_nd = reference_param_order(leaf_shaped(self.params,
                                                        self.zero1))
        sizes = [len(g["params"]) for g in sd["param_groups"]]
        if sizes != [n_nd, len(order) - n_nd]:
            raise ValueError(f"param-group sizes {sizes} do not match "
                             f"[{n_nd}, {len(order) - n_nd}]")
        states = [sd["state"][i] for i in range(len(order))]
        mu = self._mine({k: st["exp_avg"] for k, st in zip(order, states)})
        nu = self._mine({k: st["exp_avg_sq"] for k, st in zip(order, states)})
        count = torch.full((), max((int(st["step"]) for st in states),
                                   default=0),
                           dtype=torch.int32, device=self.step.device)
        adam = AdamWState(count=count, mu=mu, nu=nu)
        st = self.opt_state
        if isinstance(st, MultiStepsState):
            adam = MultiStepsState(st.mini_step, adam, st.acc_grads)
        return replace(self, opt_state=adam)

    def cycle_state_dict(self) -> Optional[Dict[str, Any]]:
        """The open accumulation cycle (None without accumulation):
        `mini_step`, and while it is above 0 the running mean of the
        cycle's gradients by parameter name (CPU tensors)."""
        st = self.opt_state
        if not isinstance(st, MultiStepsState):
            return None
        sd: Dict[str, Any] = {"mini_step": st.mini_step}
        if st.mini_step:
            sd["acc_grads"] = {k: v.detach().cpu().clone()
                               for k, v in self._whole(st.acc_grads).items()}
        return sd

    def load_cycle_state_dict(self, sd: Optional[Mapping[str, Any]],
                              every_k: int = 1) -> "TrainState":
        """The inverse of `cycle_state_dict` under accumulation over
        `every_k` micro-steps; None (a reference file) starts an empty
        cycle. A cycle longer than `every_k` allows raises."""
        mini = int(sd["mini_step"]) if sd else 0
        if mini >= every_k:
            raise ValueError(f"the checkpoint holds an open cycle of {mini} "
                             f"micro-steps; this run updates every "
                             f"{every_k}")
        st = self.opt_state
        if not isinstance(st, MultiStepsState):
            return self
        acc = st.acc_grads
        src = self._mine(sd["acc_grads"]) if mini else {}
        with torch.no_grad():
            for k, a in acc.items():
                if mini:
                    a.copy_(src[k])
                else:
                    a.zero_()
        return replace(self, opt_state=MultiStepsState(
            mini, st.inner_opt_state, acc))


def _leaves_sd(tree: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone() for k, v in tree.items()}


def opt_state_dict(opt_state) -> Dict[str, Any]:
    """A fine-tune optimizer state as a dict of CPU tensors, ints and
    strings, which `torch.load(weights_only=True)` reads: `kind` names the
    state, the count is an int, and each per-leaf tree is keyed by
    parameter name."""
    if isinstance(opt_state, MultiStepsState):
        return {"kind": "multi_steps", "mini_step": int(opt_state.mini_step),
                "inner": opt_state_dict(opt_state.inner_opt_state),
                "acc_grads": _leaves_sd(opt_state.acc_grads)}
    if isinstance(opt_state, AdamWState):
        return {"kind": "adamw", "count": int(opt_state.count),
                "mu": _leaves_sd(opt_state.mu), "nu": _leaves_sd(opt_state.nu)}
    if isinstance(opt_state, SGDState):
        return {"kind": "sgd", "count": int(opt_state.count),
                "trace": _leaves_sd(opt_state.trace)}
    raise TypeError(f"no state dict for {type(opt_state).__name__}")


def _pairs(opt_state, sd: Mapping[str, Any], out: list):
    """(what, the optimizer's tree, the file's tree) of every per-leaf tree
    of `opt_state`, after checking that `sd` holds the same kind."""
    kinds = {MultiStepsState: "multi_steps", AdamWState: "adamw",
             SGDState: "sgd"}
    kind = kinds.get(type(opt_state))
    if kind is None or sd.get("kind") != kind:
        raise ValueError(f"the file holds a {sd.get('kind')!r} state, the "
                         f"optimizer a {type(opt_state).__name__}")
    if kind == "multi_steps":
        _pairs(opt_state.inner_opt_state, sd["inner"], out)
        out.append(("acc_grads", opt_state.acc_grads, sd["acc_grads"]))
    for name in {"adamw": ("mu", "nu"), "sgd": ("trace",)}.get(kind, ()):
        out.append((name, getattr(opt_state, name), sd[name]))
    return out


def load_opt_state_dict(opt_state, sd: Mapping[str, Any]):
    """The inverse of `opt_state_dict`: copies `sd` into the tensors of
    `opt_state` in place (the fused AdamW's pointer table and the running
    mean stay valid) and returns the state, the count always together with
    its moments or trace. A different kind, leaf name or shape raises
    before anything is copied."""
    pairs = _pairs(opt_state, sd, [])
    for what, dst, src in pairs:
        if set(dst) != set(src):
            raise ValueError(
                f"{what}: the file's leaves differ from the optimizer's: "
                f"missing {sorted(set(dst) - set(src))}, unexpected "
                f"{sorted(set(src) - set(dst))}")
        for k, t in dst.items():
            if tuple(src[k].shape) != tuple(t.shape):
                raise ValueError(f"{what} {k}: shape {tuple(src[k].shape)} "
                                 f"in the file, {tuple(t.shape)} in the "
                                 f"optimizer")
    with torch.no_grad():
        for _, dst, src in pairs:
            for k, t in dst.items():
                t.copy_(src[k])
        if isinstance(opt_state, MultiStepsState):
            opt_state.inner_opt_state.count.fill_(int(sd["inner"]["count"]))
            return MultiStepsState(int(sd["mini_step"]),
                                   opt_state.inner_opt_state,
                                   opt_state.acc_grads)
        opt_state.count.fill_(int(sd["count"]))
    return opt_state
