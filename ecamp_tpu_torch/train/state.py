"""Train state (counterpart of `ecamp_tpu/train/state.py`): the step, the
parameters, and the optimizer state (for AdamW the optax-style count, mu
and nu).

The parameters are the model's own `nn.Parameter`s, keyed by state-dict
name and updated in place by the optimizer. The AdamW moments round-trip
to the reference's torch.optim.AdamW layout (`exp_avg` / `exp_avg_sq`,
indexed in the order timm's add_weight_decay gives torch: the no-decay
group, then the decay group), the layout `ecamp_tpu/ckpt/torch_import.py::
import_ecamp_adamw_state` reads. Writing files is not part of the port yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Tuple

import torch
from torch import nn

from ..kernels.fused_adamw import AdamWState


def reference_param_order(params: Mapping[str, torch.Tensor]
                          ) -> Tuple[List[str], int]:
    """The reference AdamW's parameter indices: no-decay params (ndim <= 1
    or a `.bias`) first, then the rest, each in state-dict order. Returns
    (names in index order, size of the no-decay group)."""
    no_decay = [k for k, p in params.items()
                if p.ndim <= 1 or k.endswith(".bias")]
    skip = set(no_decay)
    return no_decay + [k for k in params if k not in skip], len(no_decay)


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

    @classmethod
    def create(cls, model: nn.Module, tx) -> "TrainState":
        params = dict(model.named_parameters())
        dev = next(iter(params.values())).device
        return cls(step=torch.zeros((), dtype=torch.int32, device=dev),
                   params=params, opt_state=tx.init(params))

    def apply_gradients(self, tx) -> "TrainState":
        """One optimizer update from the parameters' `.grad` (a missing
        gradient counts as zero, as JAX's would be)."""
        return TrainState(step=self.step + 1, params=self.params,
                          opt_state=tx.apply(self.params, _Grads(self.params),
                                             self.opt_state))

    def optimizer_state_dict(self, weight_decay: float = 0.0
                             ) -> Dict[str, Any]:
        """The AdamW state as a reference torch.optim.AdamW state dict
        (CPU tensors; Linear weights stay (out, in), as the moments live in
        the weight's coordinates)."""
        st = self.opt_state
        if not isinstance(st, AdamWState):
            raise TypeError("only an AdamW state has the reference layout")
        order, n_nd = reference_param_order(self.params)
        step = st.count.detach().float().cpu()
        return {
            "state": {i: {"step": step.clone(),
                          "exp_avg": st.mu[k].detach().cpu().clone(),
                          "exp_avg_sq": st.nu[k].detach().cpu().clone()}
                      for i, k in enumerate(order)},
            "param_groups": [
                {"params": list(range(n_nd)), "weight_decay": 0.0},
                {"params": list(range(n_nd, len(order))),
                 "weight_decay": weight_decay}]}

    def load_optimizer_state_dict(self, sd: Mapping[str, Any]) -> "TrainState":
        """The inverse of `optimizer_state_dict`: moments and count from a
        reference AdamW state dict, copied onto the parameters' devices."""
        if not isinstance(self.opt_state, AdamWState):
            raise TypeError("only an AdamW state has the reference layout")
        order, n_nd = reference_param_order(self.params)
        sizes = [len(g["params"]) for g in sd["param_groups"]]
        if sizes != [n_nd, len(order) - n_nd]:
            raise ValueError(f"param-group sizes {sizes} do not match "
                             f"[{n_nd}, {len(order) - n_nd}]")
        mu, nu, steps = {}, {}, []
        for i, k in enumerate(order):
            p = self.params[k]
            st = sd["state"][i]
            mu[k] = st["exp_avg"].to(p.device, torch.float32).reshape(p.shape)
            nu[k] = st["exp_avg_sq"].to(p.device,
                                        torch.float32).reshape(p.shape)
            steps.append(int(st["step"]))
        count = torch.full((), max(steps, default=0), dtype=torch.int32,
                           device=self.step.device)
        return TrainState(step=self.step, params=self.params,
                          opt_state=AdamWState(count=count, mu=mu, nu=nu))
