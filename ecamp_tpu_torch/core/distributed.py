"""Data-parallel training over processes (counterpart of the data-axis half
of `ecamp_tpu/core/mesh.py`; reference util/misc.py:216-248
`init_distributed_mode` and misc.py:341-349 `all_reduce_mean`).

One process a rank and one card a rank, `cuda:LOCAL_RANK`. Ranks talk over
NCCL on CUDA and over gloo on the CPU; where a host runs more ranks than
it has cards they share the cards round-robin, which NCCL refuses, so
they talk over gloo. `initialize_distributed` reads the launcher's
environment: torchrun's RANK / WORLD_SIZE / LOCAL_RANK /
LOCAL_WORLD_SIZE, or OpenMPI's OMPI_COMM_WORLD_* or SLURM's SLURM_PROCID /
SLURM_NTASKS / SLURM_LOCALID / SLURM_NTASKS_PER_NODE where those count
more than one task; MASTER_ADDR and MASTER_PORT give the rendezvous. With
none of them it does nothing, and every function here then reads one
process: rank 0 of 1.

`DataParallel` moves a model's trained parameters and their gradients into
two flat buffers of one layout (`FlatLayout`), so the gradient all-reduce
is a few bucketed calls on one buffer (`all_reduce_grads_`) and the
gradients stay where the optimizer's pointer table expects them; frozen
leaves (a fine-tune's trunk) stay where they are and are not reduced.

Statistics over the global batch (the flax BatchNorm's and the soft dice's,
which JAX takes over the whole batch under GSPMD) go through
`all_reduce_sum`, an all-reduce that autograd sees: its backward sums the
incoming gradients over the ranks. `all_gather_rows` gathers host arrays
(the sharded evaluation's per-sample results).

ZeRO-1 (`Zero1`): the flat layout is cut into `world` equal spans; rank r
keeps the AdamW moments (and the accumulation buffers) of the elements in
span r only, updates those elements of the parameters, and
`DataParallel.exchange_params_` then broadcasts every span from its owner.
Moments and the update are elementwise, so any partition gives the
unsharded numbers bit for bit. JAX's `zero1_spec` shards each leaf along
its first axis divisible by the ranks, which is not contiguous in general;
a span of a flat buffer is, so every piece is a pointer and a length for
the multi-tensor kernel, and the exchange writes the parameters in place.

FSDP / ZeRO-3 (`Fsdp`): the parameters are sharded too. The model is cut
into units (each transformer block, BERT's embeddings, fusion layer and
MLM head, and a root unit for the rest; `nn/mae.py::ECAMP.fsdp_units`),
each with a `FlatLayout` of its own leaves cut into `world` spans. Rank r
keeps span r of every unit: an fp32 parameter shard and a gradient shard.
A unit's call (`nn/layers.py::call`) all-gathers its flat parameters
(`_GatherUnit`, an autograd Function), runs the unit's module on views of
the gathered buffer (`torch.func.functional_call`) and, in the backward,
reduce-scatters the unit's flat gradient into the rank's gradient shard,
divided by the world size once. The module's own parameters are empty
placeholders between calls; `whole_params` gives them their whole values
for a moment (an initialisation, a load, a save). The same `Zero1` share,
over the units' layouts, tells AdamW and `MultiSteps` the rank's pieces,
which here are the shards themselves (`holds_pieces`).

CUDA graphs of the data-parallel step (`train/graphed.py`) capture its
collectives: the gradient all-reduce, ZeRO-1's broadcasts, FSDP's unit
all-gathers and reduce-scatters, the clip's norm over the ranks and the
metrics' all-reduce. NCCL collectives can be captured; gloo's run on the
host and cannot, so `graph_capturable` is true only under NCCL, which
`initialize_distributed` picks only where every rank has a card of its
own. A graphed step sends its collectives through a communicator of its
own (`graph_group`, set as `DataParallel.group` or `Fsdp.group`), so the
collectives that run eagerly between replays (the preemption agreement,
the gathers of a checkpoint: ZeRO-1's moments, FSDP's `whole`) never
share a communicator with a captured one: only a step's own collectives
read `group`.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

ALIGN = 128        # elements: every leaf starts 512 bytes into a flat buffer
BUCKET = 1 << 25   # elements an all-reduce call sends (128 MiB of fp32)


def _launcher_ranks(env: Mapping[str, str]
                    ) -> Optional[Tuple[int, int, int, int]]:
    """(rank, world size, local rank, ranks on this host) from the
    launcher's variables, or None outside a multi-process launch:
    torchrun's (any size), OpenMPI's and SLURM's where they count more
    than one task. Where the launcher does not say how many ranks share the
    host, it counts one."""
    if "RANK" in env and "WORLD_SIZE" in env:
        return (int(env["RANK"]), int(env["WORLD_SIZE"]),
                int(env.get("LOCAL_RANK", 0)),
                int(env.get("LOCAL_WORLD_SIZE", 1)))
    if int(env.get("OMPI_COMM_WORLD_SIZE", 1)) > 1:
        return (int(env["OMPI_COMM_WORLD_RANK"]),
                int(env["OMPI_COMM_WORLD_SIZE"]),
                int(env.get("OMPI_COMM_WORLD_LOCAL_RANK", 0)),
                int(env.get("OMPI_COMM_WORLD_LOCAL_SIZE", 1)))
    if int(env.get("SLURM_NTASKS", 1)) > 1:
        per_node = env.get("SLURM_NTASKS_PER_NODE", "1")
        return (int(env["SLURM_PROCID"]), int(env["SLURM_NTASKS"]),
                int(env.get("SLURM_LOCALID", 0)),
                int(per_node) if per_node.isdigit() else 1)
    return None


def initialize_distributed(device_type: str = "cuda") -> bool:
    """Join the launcher's process group; call it before any device query.
    A process outside a multi-process launch stays alone (returns False);
    inside one, this selects the rank's card, initialises the group from
    MASTER_ADDR / MASTER_PORT (NCCL on CUDA unless the host's ranks
    outnumber its cards, else gloo) and waits for every rank (returns
    True)."""
    if dist.is_initialized():
        return True
    ranks = _launcher_ranks(os.environ)
    if ranks is None:
        return False
    rank, world, local, on_host = ranks
    missing = [k for k in ("MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"a {world}-process launch needs {missing} for "
                           f"the rendezvous")
    backend, kw = "gloo", {}
    if device_type == "cuda":
        cards = torch.cuda.device_count()
        card = torch.device("cuda", local % cards)
        torch.cuda.set_device(card)
        if on_host <= cards:
            backend = "nccl"
            kw["device_id"] = card  # binds the communicator to the card
    dist.init_process_group(backend, init_method="env://", rank=rank,
                            world_size=world, **kw)
    dist.barrier()
    return True


def shutdown_distributed() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        _GRAPH_GROUP.clear()
        dist.destroy_process_group()


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank_device(device_type: str = "cuda") -> torch.device:
    """The rank's device: the card `initialize_distributed` selected (the
    current one) for CUDA, else the CPU."""
    if device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device_type)


def _comm_device() -> torch.device:
    """Where a host value must live for a collective: the card under
    NCCL, the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return rank_device("cuda")
    return torch.device("cpu")


def graph_capturable() -> bool:
    """Whether a CUDA graph can capture this process's collectives: true
    outside a process group (there are none) and under NCCL (one card a
    rank); false under gloo, whose collectives run on the host, also where
    they take CUDA tensors (ranks sharing a card)."""
    return not is_distributed() or dist.get_backend() == "nccl"


_GRAPH_GROUP = []


def graph_group():
    """The process group of every rank that a graphed step's collectives
    go through: a second NCCL communicator, made on first use (a
    collective: every rank calls it at the same point) and kept for the
    process; None outside a process group."""
    if not is_distributed():
        return None
    if not graph_capturable():
        raise RuntimeError(
            f"a CUDA graph of a step captures its collectives, which the "
            f"{dist.get_backend()} process group runs on the host: graphed "
            f"steps need NCCL, one card a rank (ranks that share a card "
            f"talk over gloo)")
    if not _GRAPH_GROUP:
        _GRAPH_GROUP.append(dist.new_group(backend="nccl"))
    return _GRAPH_GROUP[0]


def barrier() -> None:
    if is_distributed():
        dist.barrier()


def all_reduce_mean_(flat: torch.Tensor, bucket: int = BUCKET,
                     group=None) -> torch.Tensor:
    """Average a contiguous tensor over the ranks (of `group`, by default
    the whole group) in place: a sum of each bucket of `bucket` elements,
    then one correctly rounded division by the world size. Every rank gets
    the same bits. Outside a process group it leaves `flat` as it is."""
    if not is_distributed():
        return flat
    view = flat.view(-1)
    for s in range(0, view.numel(), bucket):
        dist.all_reduce(view[s:s + bucket], group=group)
    return flat.div_(world_size())


def all_reduce_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of `t` over the ranks (of `group`, by default the whole
    group), in place, on every rank (no autograd); outside a process group
    `t` as it is."""
    if is_distributed():
        dist.all_reduce(t, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the ranks, on every rank. Each rank's loss
    reads y, so dL/dx on a rank is the sum of the ranks' dL/dy: the
    backward is the same all-reduce of the incoming gradient."""

    @staticmethod
    def forward(ctx, x):
        y = x.contiguous().clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of a (small) tensor over the ranks, differentiable; outside
    a process group `x` itself. Every rank must call it at the same point
    of its step."""
    if not is_distributed():
        return x
    return _AllReduceSum.apply(x)


def all_gather_rows(arr: np.ndarray) -> np.ndarray:
    """(W, n, ...): every rank's `arr`, whose shapes are equal, stacked in
    rank order (a collective); outside a process group `arr[None]`."""
    arr = np.ascontiguousarray(arr)
    if not is_distributed():
        return arr[None]
    t = torch.from_numpy(arr).to(_comm_device())
    out = [torch.empty_like(t) for _ in range(world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).cpu().numpy()


def any_rank(flag: bool) -> bool:
    """True on every rank when `flag` is True on any (an all-reduce of the
    maximum); a host synchronisation."""
    if not is_distributed():
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32, device=_comm_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


class FlatLayout:
    """Named leaves in one flat buffer, each at a multiple of ALIGN
    elements, the total padded to `world * ALIGN` and cut into `world`
    equal spans of `span` elements (span r belongs to rank r)."""

    def __init__(self, shapes: Mapping[str, torch.Size], world: int = 1):
        self.shapes = {k: torch.Size(s) for k, s in shapes.items()}
        self.world = world
        self.offsets: Dict[str, int] = {}
        end = 0
        for k, s in self.shapes.items():
            self.offsets[k] = end
            end += -(-math.prod(s) // ALIGN) * ALIGN
        unit = world * ALIGN
        self.total = -(-end // unit) * unit
        self.span = self.total // world

    def view(self, flat: torch.Tensor, name: str) -> torch.Tensor:
        """Leaf `name` inside `flat`, in its shape."""
        o, shape = self.offsets[name], self.shapes[name]
        return flat[o:o + math.prod(shape)].view(shape)

    def piece(self, name: str, rank: int) -> Tuple[int, int]:
        """(lo, hi): the elements of leaf `name`, flattened, that lie in
        rank's span; lo == hi where none do."""
        o, n = self.offsets[name], math.prod(self.shapes[name])
        lo = min(max(rank * self.span - o, 0), n)
        hi = max(min((rank + 1) * self.span - o, n), lo)
        return lo, hi


def broadcast_spans_(flat: torch.Tensor, layout: FlatLayout,
                     group=None) -> None:
    """Every rank's span of `flat` from that rank to all others, in place
    (an all-gather made of broadcasts, which gloo also takes for CUDA
    tensors), over `group` (every rank; by default the whole group);
    outside a process group there is one span and nothing to send."""
    if not is_distributed():
        return
    for r in range(layout.world):
        dist.broadcast(flat[r * layout.span:(r + 1) * layout.span], src=r,
                       group=group)


def all_gather_spans_(flat: torch.Tensor, layout: FlatLayout,
                      group=None) -> None:
    """`broadcast_spans_`'s result, as one all-gather where the backend
    has it for these tensors (NCCL's `all_gather_into_tensor`, in place:
    the rank's span is the input); gloo keeps the broadcasts."""
    if not is_distributed():
        return
    if dist.get_backend(group) == "nccl":
        r = rank()
        dist.all_gather_into_tensor(
            flat, flat[r * layout.span:(r + 1) * layout.span], group=group)
    else:
        broadcast_spans_(flat, layout, group=group)


def reduce_scatter_mean_(flat: torch.Tensor, layout: FlatLayout,
                         out: torch.Tensor, group=None) -> torch.Tensor:
    """Rank r's span of the ranks' mean of `flat` into `out` (span
    elements): the sum over the ranks, then one correctly rounded division
    by the world size, as `all_reduce_mean_` takes it, so every element
    has its bits. NCCL reduce-scatters; gloo all-reduces `flat` (in place)
    and slices. Outside a process group `out` is `flat`'s one span."""
    if not is_distributed():
        return out.copy_(flat)
    r = rank()
    if dist.get_backend(group) == "nccl":
        dist.reduce_scatter_tensor(out, flat, group=group)
    else:
        dist.all_reduce(flat, group=group)
        out.copy_(flat[r * layout.span:(r + 1) * layout.span])
    return out.div_(world_size())


class DataParallel:
    """One rank's share of data-parallel training of `model`: its trained
    parameters (those `trainable` marks True, every one without it) and
    their gradients moved into flat buffers of one `FlatLayout` (each such
    parameter's `.data` and `.grad` become views, which `zero_grad(
    set_to_none=False)`, the backward pass and `load_state_dict`'s in-place
    copies keep), the gradient average over the ranks, and ZeRO-1's
    parameter exchange. The trained parameters share one floating dtype
    (fp32 for the kernels; the CPU tests' float64 models too). `group` is
    the process group the step's collectives go through: None (the whole
    group) until a graphed step sets `graph_group()`."""

    def __init__(self, model: nn.Module,
                 trainable: Optional[Mapping[str, bool]] = None):
        params = {k: p for k, p in model.named_parameters()
                  if trainable is None or trainable[k]}
        first = next(iter(params.values()))
        dev, dtype = first.device, first.dtype
        for k, p in params.items():
            if p.dtype != dtype or p.device != dev or \
                    not p.is_floating_point():
                raise ValueError(f"data parallelism takes floating "
                                 f"parameters of one dtype on one device: "
                                 f"{k} is {p.dtype} on {p.device}, the "
                                 f"first {dtype} on {dev}")
        self.layout = FlatLayout({k: p.shape for k, p in params.items()},
                                 world_size())
        self.params_flat = torch.zeros(self.layout.total, dtype=dtype,
                                       device=dev)
        self.grads_flat = torch.zeros(self.layout.total, dtype=dtype,
                                      device=dev)
        self.group = None
        with torch.no_grad():
            for k, p in params.items():
                view = self.layout.view(self.params_flat, k)
                view.copy_(p)
                p.data = view
                p.grad = self.layout.view(self.grads_flat, k)

    def all_reduce_grads_(self) -> None:
        """Average the gradients over the ranks, in place."""
        all_reduce_mean_(self.grads_flat, group=self.group)

    def exchange_params_(self) -> None:
        """Give every rank the parameters each rank updated in its span."""
        broadcast_spans_(self.params_flat, self.layout, group=self.group)


def reduce_step(dp: Optional[DataParallel], metrics: torch.Tensor
                ) -> torch.Tensor:
    """A fine-tune step's collectives after its backward pass: the
    gradients averaged over the ranks in place and the ranks' mean of
    `metrics` (a detached tensor) returned. Without `dp`, `metrics` as it
    is."""
    if dp is None:
        return metrics
    dp.all_reduce_grads_()
    return all_reduce_mean_(metrics.clone())


class Zero1:
    """One rank's share of training state sharded over the ranks: the
    elements of each leaf it updates and keeps optimizer state for
    (`piece`), those elements of a leaf-shaped tensor (`local`, `take`),
    per-leaf pieces gathered back into whole leaves (`gather`) and the
    parameter exchange after an update. ZeRO-1 shares one `FlatLayout`
    (its `DataParallel`'s); FSDP one a unit (`Fsdp`), whose shards are
    the pieces themselves, so the optimizer is handed pieces of the
    parameters and gradients (`holds_pieces`) and exchanges nothing (the
    next forward gathers). Without a `dp` there is nothing to exchange: a
    single process can update each rank's pieces in turn."""

    def __init__(self, layout, rank: int, dp=None):
        layouts = [layout] if isinstance(layout, FlatLayout) else list(layout)
        self.layouts = layouts
        self._layout_of = {k: lay for lay in layouts for k in lay.shapes}
        self.rank = rank
        self.dp = dp
        self.holds_pieces = isinstance(dp, Fsdp)

    @property
    def world(self) -> int:
        return self.layouts[0].world

    def shapes(self) -> Dict[str, torch.Size]:
        """Every leaf's whole shape, by name."""
        return {k: lay.shapes[k] for k, lay in self._layout_of.items()}

    def piece(self, name: str) -> Tuple[int, int]:
        return self._layout_of[name].piece(name, self.rank)

    def local(self, t: torch.Tensor, name: str) -> torch.Tensor:
        """The rank's elements of leaf-shaped `t`, a flat view."""
        lo, hi = self.piece(name)
        return t.reshape(-1)[lo:hi]

    def take(self, full: Mapping[str, torch.Tensor], device
             ) -> Dict[str, torch.Tensor]:
        """The rank's pieces of whole leaves, as fp32 tensors of their own
        on `device`."""
        return {k: self.local(v, k).to(device, torch.float32, copy=True)
                for k, v in full.items()}

    def gather(self, pieces: Mapping[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        """Whole leaves from every rank's pieces (a collective: every rank
        calls it and gets them)."""
        dev = next(iter(pieces.values())).device
        out = {}
        for lay in self.layouts:
            names = [k for k in lay.shapes if k in pieces]
            if not names:
                continue
            flat = torch.zeros(lay.total, device=dev)
            for k in names:
                self.local(lay.view(flat, k), k).copy_(pieces[k])
            broadcast_spans_(flat, lay)
            out.update((k, lay.view(flat, k)) for k in names)
        return {k: out[k] for k in pieces}

    def exchange_params(self) -> None:
        if self.dp is not None:
            self.dp.exchange_params_()


# elements under which a unit's gathered leaf is handed out as a copy and
# not as a view: autograd saves some small fp32 leaves whole (a LayerNorm
# saves its weight), and a view would keep the unit's whole gathered
# buffer alive until the backward
SMALL_LEAF = 1 << 16


class _GatherUnit(torch.autograd.Function):
    """A unit's leaves from the ranks' shards: the forward all-gathers the
    unit's flat parameters and returns each leaf in its shape (a view of
    the gathered buffer, a copy under SMALL_LEAF elements); the backward
    reduce-scatters the leaves' gradients, laid out flat, into the rank's
    gradient shard (accumulated), divided by the world size once. The
    shard itself gets no gradient from autograd."""

    @staticmethod
    def forward(ctx, shard, unit):
        ctx.unit = unit
        ctx.set_materialize_grads(False)
        flat = unit.gathered(unit.owner.group)
        return tuple(unit.layout.view(flat, k).clone()
                     if unit.layout.shapes[k].numel() < SMALL_LEAF
                     else unit.layout.view(flat, k) for k in unit.names)

    @staticmethod
    def backward(ctx, *grads):
        unit = ctx.unit
        lay = unit.layout
        flat = torch.zeros(lay.total, dtype=unit.grad.dtype,
                           device=unit.grad.device)
        for k, g in zip(unit.names, grads):
            if g is not None:
                lay.view(flat, k).copy_(g)
        unit.grad.add_(reduce_scatter_mean_(
            flat, lay, torch.empty_like(unit.grad), group=unit.owner.group))
        return None, None


class _Unit:
    """One FSDP unit: `module` (named `prefix` in the model) and the
    parameters under it that no smaller unit holds, in a `FlatLayout` of
    their model names; the rank's span of it as a parameter shard and a
    gradient shard. Calling it runs the module on the gathered leaves."""

    def __init__(self, owner: "Fsdp", prefix: str, module: nn.Module,
                 params: Mapping[str, nn.Parameter]):
        self.owner, self.module = owner, module
        self.names = list(params)
        self.local_names = [k[len(prefix) + 1:] if prefix else k
                            for k in self.names]
        self.layout = FlatLayout({k: p.shape for k, p in params.items()},
                                 owner.world)
        first = next(iter(params.values()))
        full = torch.zeros(self.layout.total, dtype=first.dtype,
                           device=first.device)
        with torch.no_grad():
            for k, p in params.items():
                self.layout.view(full, k).copy_(p)
        self.shard = self.span(full).clone().requires_grad_(True)
        self.grad = torch.zeros_like(self.shard, requires_grad=False)

    def span(self, flat: torch.Tensor) -> torch.Tensor:
        r, n = self.owner.rank, self.layout.span
        return flat[r * n:(r + 1) * n]

    def gathered(self, group=None) -> torch.Tensor:
        """The unit's whole flat parameters (a collective over `group`, by
        default the whole group), no autograd."""
        with torch.no_grad():
            flat = torch.empty(self.layout.total, dtype=self.shard.dtype,
                               device=self.shard.device)
            self.span(flat).copy_(self.shard)
            all_gather_spans_(flat, self.layout, group=group)
        return flat

    def __call__(self, *args, **kwargs):
        leaves = _GatherUnit.apply(self.shard, self)
        return torch.func.functional_call(
            self.module, dict(zip(self.local_names, leaves)), args, kwargs,
            tie_weights=False, strict=False)


class Fsdp:
    """One rank's share of fully sharded data parallelism (ZeRO-3) of
    `model`, beside `DataParallel`: the model's parameters split into
    units (`units`: module names; every parameter belongs to the longest
    one it lies under, the rest to the root unit, ""), each unit's span of
    this rank held as an fp32 parameter shard and a gradient shard, and
    the module's parameters left as empty placeholders. A unit runs on its
    gathered parameters where the model calls it through
    `nn/layers.py::call` (each unit module carries its `_Unit` as
    `fsdp_unit`); its backward reduce-scatters the gradient. `pieces`,
    each leaf's elements in this rank's shard (a flat view, its `.grad`
    the same elements of the gradient shard), are what the optimizer
    updates. In one process there is one span: the shards are whole and
    the collectives copies. The parameters share one floating dtype and
    device, as `DataParallel`'s. `group` is the process group of a step's
    gathers and reduce-scatters (None, the whole group, until a graphed
    step sets `graph_group()`); `whole` always gathers over the whole
    group."""

    def __init__(self, model: nn.Module, units: Sequence[str]):
        params = dict(model.named_parameters())
        first = next(iter(params.values()))
        for k, p in params.items():
            if p.dtype != first.dtype or p.device != first.device or \
                    not p.is_floating_point():
                raise ValueError(f"FSDP takes floating parameters of one "
                                 f"dtype on one device: {k} is {p.dtype} on "
                                 f"{p.device}, the first {first.dtype} on "
                                 f"{first.device}")
        self.world, self.rank = world_size(), rank()
        self.group = None
        self.model = model
        self._params = params
        by_length = sorted(units, key=len, reverse=True)
        owner = {k: next((u for u in by_length if k.startswith(u + ".")), "")
                 for k in params}
        modules = dict(model.named_modules())
        self.units: List[_Unit] = []
        for prefix in ["", *units]:
            mine = {k: p for k, p in params.items() if owner[k] == prefix}
            if mine:
                unit = _Unit(self, prefix, modules[prefix], mine)
                modules[prefix].fsdp_unit = unit
                self.units.append(unit)
        self.pieces: Dict[str, torch.Tensor] = {}
        for unit in self.units:
            lay, base = unit.layout, self.rank * unit.layout.span
            shard, grad = unit.shard.detach(), unit.grad
            for k in unit.names:
                lo, hi = lay.piece(k, self.rank)
                at = lay.offsets[k] + lo - base  # [at, at) where empty
                piece = shard[at:at + hi - lo]
                piece.grad = grad[at:at + hi - lo]
                self.pieces[k] = piece
        self.pieces = {k: self.pieces[k] for k in params}  # model order
        self._placeholders()

    def _placeholders(self) -> None:
        for p in self._params.values():
            p.data = p.data.new_empty(0)

    def layouts(self) -> List[FlatLayout]:
        return [u.layout for u in self.units]

    def zero_grad_(self) -> None:
        for u in self.units:
            u.grad.zero_()

    def all_reduce_grads_(self) -> None:
        """Nothing: each unit's backward reduce-scattered its gradient."""

    def exchange_params_(self) -> None:
        """Nothing: the next forward gathers the updated shards."""

    @contextlib.contextmanager
    def whole(self, write_back: bool = True):
        """The model's parameters whole inside the block (a collective over
        the whole group, not `group`): every unit gathered, each
        parameter's data a view of its unit's buffer; on leaving, with
        `write_back`, each rank takes its span back into its shards (what
        the block wrote into the parameters is kept), and the placeholders
        return."""
        with torch.no_grad():
            flats = [u.gathered() for u in self.units]
            for u, flat in zip(self.units, flats):
                for k in u.names:
                    self._params[k].data = u.layout.view(flat, k)
        ok = False
        try:
            yield self.model
            ok = True
        finally:
            with torch.no_grad():
                if ok and write_back:
                    for u, flat in zip(self.units, flats):
                        u.shard.detach().copy_(u.span(flat))
                self._placeholders()


def whole_params(model: nn.Module, write_back: bool = True):
    """`Fsdp.whole` of the FSDP share that holds `model`'s parameters (a
    collective), or a block that changes nothing where they are not
    sharded."""
    unit = next((u for m in model.modules()
                 if (u := getattr(m, "fsdp_unit", None)) is not None), None)
    if unit is None:
        return contextlib.nullcontext(model)
    return unit.owner.whole(write_back)
