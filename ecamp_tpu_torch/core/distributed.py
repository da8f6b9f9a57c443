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
"""

from __future__ import annotations

import math
import os
from typing import Dict, Mapping, Optional, Tuple

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


def barrier() -> None:
    if is_distributed():
        dist.barrier()


def all_reduce_mean_(flat: torch.Tensor, bucket: int = BUCKET
                     ) -> torch.Tensor:
    """Average a contiguous tensor over the ranks in place: a sum of each
    bucket of `bucket` elements, then one correctly rounded division by
    the world size. Every rank gets the same bits. Outside a process
    group it leaves `flat` as it is."""
    if not is_distributed():
        return flat
    view = flat.view(-1)
    for s in range(0, view.numel(), bucket):
        dist.all_reduce(view[s:s + bucket])
    return flat.div_(world_size())


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


def broadcast_spans_(flat: torch.Tensor, layout: FlatLayout) -> None:
    """Every rank's span of `flat` from that rank to all others, in place
    (an all-gather made of broadcasts, which gloo also takes for CUDA
    tensors); outside a process group there is one span and nothing to
    send."""
    if not is_distributed():
        return
    for r in range(layout.world):
        dist.broadcast(flat[r * layout.span:(r + 1) * layout.span], src=r)


class DataParallel:
    """One rank's share of data-parallel training of `model`: its trained
    parameters (those `trainable` marks True, every one without it) and
    their gradients moved into flat buffers of one `FlatLayout` (each such
    parameter's `.data` and `.grad` become views, which `zero_grad(
    set_to_none=False)`, the backward pass and `load_state_dict`'s in-place
    copies keep), the gradient average over the ranks, and ZeRO-1's
    parameter exchange. The trained parameters share one floating dtype
    (fp32 for the kernels; the CPU tests' float64 models too)."""

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
        with torch.no_grad():
            for k, p in params.items():
                view = self.layout.view(self.params_flat, k)
                view.copy_(p)
                p.data = view
                p.grad = self.layout.view(self.grads_flat, k)

    def all_reduce_grads_(self) -> None:
        """Average the gradients over the ranks, in place."""
        all_reduce_mean_(self.grads_flat)

    def exchange_params_(self) -> None:
        """Give every rank the parameters each rank updated in its span."""
        broadcast_spans_(self.params_flat, self.layout)


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
    """One rank's ZeRO-1 share of a `FlatLayout`: the elements of each leaf
    it updates and keeps optimizer state for (`piece`), those elements of
    a leaf-shaped tensor (`local`, `take`), per-leaf pieces gathered back
    into whole leaves (`gather`) and the parameter exchange. Without a
    `DataParallel` there is nothing to exchange: a single process can
    update each rank's pieces in turn."""

    def __init__(self, layout: FlatLayout, rank: int,
                 dp: Optional[DataParallel] = None):
        self.layout = layout
        self.rank = rank
        self.dp = dp

    def piece(self, name: str) -> Tuple[int, int]:
        return self.layout.piece(name, self.rank)

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
        flat = torch.zeros(self.layout.total, device=dev)
        for k, t in pieces.items():
            self.local(self.layout.view(flat, k), k).copy_(t)
        broadcast_spans_(flat, self.layout)
        return {k: self.layout.view(flat, k) for k in pieces}

    def exchange_params(self) -> None:
        if self.dp is not None:
            self.dp.exchange_params_()
