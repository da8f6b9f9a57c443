"""Fused AdamW: the multi-tensor CUDA kernel `csrc/adamw.cu` and its plain
version, in optax.adamw's op order.

Counterpart of `ecamp_tpu/kernels/fused_adamw.py`. Per element:
    g'  = (g / gdiv) * gmul             global-norm clip as two scalars
    mu' = (1-b1)*g' + b1*mu
    nu' = (1-b2)*g'^2 + b2*nu
    u   = (mu'/bc1) / (sqrt(nu'/bc2) + eps)   bc_i = 1 - b_i^(count+1)
    p'  = p - lr*(u + wd*p)             wd only on leaves that decay
with lr = schedule(count) at the pre-increment count, as
optax.scale_by_schedule reads it. The five scalars [lr, bc1, bc2, gdiv,
gmul] are one fp32 device tensor, computed with device ops from the
device-side count and grad norm, so a step needs no host synchronisation.

`FusedAdamW.apply` runs the kernel when the parameters are CUDA tensors:
one launch for every leaf, p, mu and nu updated in place. For CPU tensors
it runs the plain version, `_leaf_update_plain` leaf by leaf (JAX
`_leaf_update_jnp`); `plain = True` routes CUDA tensors there too, as the
on-card reference. The v5e-measured opt-in (`fused_adamw` config flag,
`ECAMP_FUSED_ADAMW`) is not carried over.

Under ZeRO-1 (`zero1`, a `core/distributed.py::Zero1`) the moments hold
this rank's piece of each leaf only (a flat tensor, empty for a leaf
outside its span), the update (kernel or plain) runs on those pieces of
the parameters and gradients, contiguous views, and the ranks then
exchange their spans of the parameters (JAX `_zero1_update`). Under FSDP
(a share that `holds_pieces`) the parameters and gradients handed in are
those pieces already, views of the rank's shards, and nothing is
exchanged: the next forward gathers. Every element sees the same
arithmetic as unsharded, so the parameters equal the unsharded update's
bit for bit. The clip's global norm is local where the gradients are
whole (ZeRO-1 without accumulation, as in JAX); where they are pieces
(FSDP, ZeRO-1's running mean) the ranks' sums of squares are all-reduced
(`global_norm(..., over_ranks=True)`), so it is the norm of the whole
gradients, as JAX's clip is under both layouts. That all-reduce goes
through the share's step group (`zero1.dp.group`), as the step's other
collectives do, so a CUDA graph of the update captures it on the
graphs' communicator.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch

from ..core import distributed
from ..core.distributed import Zero1
from . import _build

SOURCE = "ecamp_tpu_torch/csrc/adamw.cu"
CHUNK = 65536  # elements a thread block updates; a multiple of 4

launches = _build.LaunchCounter()


def _leaf_update_plain(g, m, v, p, lr, bc1, bc2, gdiv, gmul, b1: float,
                       b2: float, eps: float, wd: float):
    """One leaf's update, the per-leaf PyTorch formula; returns
    (p', mu', nu') in the dtypes of p, m and v."""
    g = g.float() / gdiv * gmul
    m_new = (1.0 - b1) * g + b1 * m.float()
    v_new = (1.0 - b2) * (g * g) + b2 * v.float()
    u = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
    if wd:
        u = u + wd * p.float()
    return ((p.float() - lr * u).to(p.dtype), m_new.to(m.dtype),
            v_new.to(v.dtype))


def _not_capturing(dev: torch.device, what: str) -> None:
    """A blocking host-to-device copy cannot be captured into a CUDA graph,
    and a graph that skipped it would read stale addresses: raise."""
    if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"AdamW kernel: {what} under CUDA graph capture; "
                           f"run an eager step on these tensors first")


class _LeafTable:
    """The kernel's device tables for one parameter set: per leaf the p, g,
    mu, nu addresses, size and weight decay; per chunk its leaf and start.
    Built once; the address table is rebuilt only when an address changes
    (a gradient freed and allocated anew), which a CUDA graph's capture
    refuses."""

    def __init__(self, params, grads, mu, nu, wd: List[float]):
        dev = params[0].device
        _not_capturing(dev, "the leaf table built")
        self.numel = torch.tensor([p.numel() for p in params],
                                  dtype=torch.int64, device=dev)
        self.wd_host = list(wd)
        self.wd = torch.tensor(wd, dtype=torch.float32, device=dev)
        leaf, start = [], []
        for i, p in enumerate(params):
            for s in range(0, max(p.numel(), 1), CHUNK):
                leaf.append(i)
                start.append(s)
        self.chunk_leaf = torch.tensor(leaf, dtype=torch.int32, device=dev)
        self.chunk_start = torch.tensor(start, dtype=torch.int64, device=dev)
        self.n_chunks = len(leaf)
        self.addresses: Tuple[int, ...] = ()
        self.ptrs = None
        self.update(params, grads, mu, nu)

    def update(self, params, grads, mu, nu) -> None:
        addresses = tuple(t.data_ptr() for leaf in zip(params, grads, mu, nu)
                          for t in leaf)
        if addresses != self.addresses:
            if self.addresses:
                _not_capturing(params[0].device, "a leaf's address changed")
            self.ptrs = torch.tensor(addresses, dtype=torch.int64).to(
                params[0].device)
            self.addresses = addresses


def _check_leaves(params, grads, mu, nu) -> None:
    dev = params[0].device
    for name, group in (("param", params), ("grad", grads), ("mu", mu),
                        ("nu", nu)):
        for i, (t, p) in enumerate(zip(group, params)):
            if t.device != dev or t.dtype != torch.float32:
                raise ValueError(f"AdamW kernel takes fp32 tensors on one "
                                 f"device: {name} {i} is {t.dtype} on "
                                 f"{t.device}")
            if t.shape != p.shape or not t.is_contiguous():
                raise ValueError(f"AdamW kernel: {name} {i} must be "
                                 f"contiguous with its param's shape")


@dataclass
class AdamWState:
    """optax ScaleByAdamState: the update count (a device int32 scalar)
    and the moments, keyed like the parameters. An update advances all
    three in place, so a CUDA graph of it reads the current count at
    every replay."""

    count: torch.Tensor
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


class FusedAdamW:
    """AdamW with optax.adamw's semantics over a dict of fp32 parameters,
    updated in place; `mask_fn` maps the parameters to a dict of bools
    (True = weight decay), and `grad_clip` folds a global-norm clip into
    the same pass. Counterpart of JAX `fused_adamw(...)`."""

    def __init__(self, schedule: Callable[[torch.Tensor], torch.Tensor],
                 b1: float, b2: float, eps: float, weight_decay: float,
                 mask_fn: Optional[Callable] = None,
                 grad_clip: Optional[float] = None,
                 zero1: Optional[Zero1] = None):
        self.schedule = schedule
        self.b1, self.b2, self.eps = float(b1), float(b2), float(eps)
        self.weight_decay = float(weight_decay)
        self.mask_fn = mask_fn
        self.grad_clip = grad_clip
        self.plain = False  # see set_plain
        self.zero1 = zero1
        self._table: Optional[_LeafTable] = None

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamWState:
        """Count 0 and zero moments: whole, or under ZeRO-1 and FSDP the
        rank's pieces."""
        dev = next(iter(params.values())).device
        return AdamWState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            mu=zero_pieces(params, self.zero1),
            nu=zero_pieces(params, self.zero1))

    def scalars(self, count: torch.Tensor, grads: List[torch.Tensor],
                over_ranks: bool = False, group=None) -> torch.Tensor:
        """[lr, bc1, bc2, gdiv, gmul] as one fp32 tensor on the count's
        device, from device ops only (`over_ranks`: `grads` are the rank's
        pieces, the clip's norm sums every rank's over `group`)."""
        # torch.full, not torch.tensor: a blocking host-to-device copy
        # would synchronise the stream
        def full(value):
            return torch.full((), value, dtype=torch.float32,
                              device=count.device)

        cf = (count + 1).float()
        b1, b2, one = full(self.b1), full(self.b2), full(1.0)
        lr = self.schedule(count).to(torch.float32)
        gdiv = gmul = one
        if self.grad_clip is not None:
            gdiv, gmul = clip_scale(grads, self.grad_clip, over_ranks,
                                    group)
        return torch.stack([lr, 1.0 - b1 ** cf, 1.0 - b2 ** cf, gdiv, gmul])

    def _decays(self, params: Mapping[str, torch.Tensor]) -> List[float]:
        wd = self.weight_decay
        if wd > 0 and self.mask_fn is not None:
            mask = self.mask_fn(leaf_shaped(params, self.zero1))
            return [wd if mask[k] else 0.0 for k in params]
        return [wd] * len(params)

    def apply(self, params: Mapping[str, torch.Tensor],
              grads: Mapping[str, torch.Tensor],
              state: AdamWState, sharded: bool = False) -> AdamWState:
        """One update: p, mu, nu and the count in place; returns the
        state. Under ZeRO-1 `params` and `grads` are whole, or with
        `sharded` the grads already the rank's pieces (`MultiSteps`'
        running mean); under FSDP both are the rank's pieces."""
        names = list(params)
        z = self.zero1
        pieces = z is not None and z.holds_pieces
        over_ranks = pieces or sharded
        if (over_ranks and self.grad_clip is not None
                and z.world != distributed.world_size()):
            raise ValueError(f"the clip's global norm sums the ranks' "
                             f"pieces: a share of {z.world} ranks needs a "
                             f"process group of {z.world}, not "
                             f"{distributed.world_size()}")
        dev = params[names[0]].device
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"no AdamW kernel for {dev}")
        group = None if z is None or z.dp is None else z.dp.group
        scal = self.scalars(state.count, [grads[k] for k in names],
                            over_ranks, group)
        with torch.no_grad():
            ps, gs, ms, vs, wd = [], [], [], [], []
            for k, w in zip(names, self._decays(params)):
                p, g = params[k], grads[k]
                if z is not None:
                    if not pieces:
                        p = z.local(p, k)
                        g = g if sharded else z.local(g, k)
                    if not p.numel():
                        continue  # outside this rank's span
                ps.append(p)
                gs.append(g)
                ms.append(state.mu[k])
                vs.append(state.nu[k])
                wd.append(w)
            if dev.type == "cuda" and not self.plain:
                if ps:
                    self._apply_cuda(ps, gs, ms, vs, wd, scal)
            else:
                lr, bc1, bc2, gdiv, gmul = scal.unbind()
                for p, g, m, v, w in zip(ps, gs, ms, vs, wd):
                    p_new, m_new, v_new = _leaf_update_plain(
                        g, m, v, p, lr, bc1, bc2, gdiv, gmul, self.b1,
                        self.b2, self.eps, w)
                    p.copy_(p_new)
                    m.copy_(m_new)
                    v.copy_(v_new)
            if z is not None:
                z.exchange_params()
            state.count.add_(1)
        return state

    def _apply_cuda(self, ps, gs, ms, vs, wd, scal) -> None:
        _check_leaves(ps, gs, ms, vs)
        table = self._table
        if (table is None or table.wd_host != wd
                or table.ptrs.device != ps[0].device):
            table = self._table = _LeafTable(ps, gs, ms, vs, wd)
        else:
            table.update(ps, gs, ms, vs)
        dev = ps[0].device
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = _build.library().ecamp_adamw_multi(
                table.ptrs.data_ptr(), table.numel.data_ptr(),
                table.wd.data_ptr(), table.chunk_leaf.data_ptr(),
                table.chunk_start.data_ptr(), table.n_chunks,
                scal.data_ptr(), CHUNK, self.b1, 1.0 - self.b1, self.b2,
                1.0 - self.b2, self.eps, stream)
        _build.check(err, "ecamp_adamw_multi")
        launches.add()


def zero_pieces(params: Mapping[str, torch.Tensor],
                zero1: Optional[Zero1]) -> Dict[str, torch.Tensor]:
    """A zero tensor for every leaf of `params`: its shape, or under a
    share (ZeRO-1, FSDP) the rank's piece, flat."""
    if zero1 is None:
        return {k: torch.zeros_like(p) for k, p in params.items()}
    out = {}
    for k, p in params.items():
        lo, hi = zero1.piece(k)
        out[k] = torch.zeros(hi - lo, dtype=p.dtype, device=p.device)
    return out


def leaf_shaped(params: Mapping[str, torch.Tensor],
                zero1: Optional[Zero1]) -> Mapping[str, torch.Tensor]:
    """`params` where they are whole; where they are the rank's pieces
    (FSDP), leaf-shaped stand-ins on the meta device (no storage), for
    what reads a leaf's shape (the decay mask, the reference order)."""
    if zero1 is None or not zero1.holds_pieces:
        return params
    shapes = zero1.shapes()
    return {k: torch.empty(shapes[k], device="meta") for k in params}


def global_norm(tensors: List[torch.Tensor],
                over_ranks: bool = False, group=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm), an
    fp32 device scalar. With `over_ranks` the tensors are this rank's
    pieces of the gradients: the ranks' sums of squares are all-reduced
    first, over `group` (by default the whole group; outside a process
    group the pieces are whole)."""
    if not over_ranks or not distributed.is_distributed():
        return torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(t.float()) for t in tensors]))
    sq = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t.float()) for t in tensors])).square()
    return distributed.all_reduce_sum_(sq.reshape(1),
                                       group).sqrt().reshape(())


def clip_scale(grads: List[torch.Tensor], max_norm: float,
               over_ranks: bool = False, group=None):
    """optax.clip_by_global_norm as (gdiv, gmul): updates are
    (g / gdiv) * gmul, (1, 1) inside the bound, (gnorm, max_norm) past it
    (NaN norms propagate, as there). `over_ranks`, `group`:
    `global_norm`'s."""
    gnorm = global_norm(grads, over_ranks, group)
    one = torch.ones_like(gnorm)
    trigger = gnorm < max_norm
    return (torch.where(trigger, one, gnorm),
            torch.where(trigger, one, torch.full_like(gnorm, max_norm)))
