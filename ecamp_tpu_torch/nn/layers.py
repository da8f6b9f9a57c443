"""Shared transformer layers (counterpart of `ecamp_tpu/nn/layers.py`).

timm-0.4.12-semantics ViT block: pre-LN, fused qkv with bias, exact (erf)
GELU. Parameter names follow the reference's torch module tree
(`qkv/proj/fc1/fc2/norm1/norm2`, LayerNorm `weight`/`bias`), so a
reference state dict loads with `load_state_dict(strict=True)`.

Precision: parameters stay fp32; each module casts its weights to its
compute `dtype` at every call, as flax's `Dense(dtype=bf16)` does inside
the jitted apply. No bf16 copy of the weights is kept, so serving holds
one fp32 copy and pays one cast per weight per call.

For serving, `serve/quantize.py` can replace the weight of a `Dense`,
`PatchProj` or `Conv2d` (modules that hold a flax `kernel`) by an int8
buffer `weight_q` and an fp32 per-output-channel `weight_scale`: `Dense`
and `PatchProj` then run the int8-weight linear kernel, `Conv2d` widens
the weight to `bf16(q·s)` in torch ops before `F.conv2d` (a dequantised
copy each call, where XLA fuses the widening into the convolution).

Initialisation mirrors the JAX defaults (xavier-uniform Linear, lecun-
normal patch conv, zero biases, unit LayerNorm) and draws from an explicit
`torch.Generator` passed to `reset_parameters`.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core import distributed
from ..kernels import dot_product_attention, fused_layer_norm
from ..kernels.flash_attention import _attention_reference
from ..kernels.int8_linear import (_int8_linear_reference, dequantize_int8,
                                   int8_linear)
from ..kernels.layer_norm import _ln_reference

# flax truncated_normal / variance_scaling draw from N(0, 1) cut at +-2 and
# divide by the cut distribution's std so the result has the asked std
_TRUNC_STD = 0.87962566103423978


def trunc_normal_(t: torch.Tensor, std: float,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """Normal(0, std) truncated at +-2 std (flax `truncated_normal`)."""
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


def lecun_normal_(t: torch.Tensor,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's conv default, lecun_normal: a truncated normal of variance
    1 / fan_in, for an OIHW weight (fan_in = I * H * W)."""
    return trunc_normal_(t, math.sqrt(1.0 / t[0].numel()) / _TRUNC_STD,
                         generator)


def is_quantized(module: nn.Module) -> bool:
    """Whether `serve/quantize.py` replaced module's weight by int8."""
    return "weight_q" in module._buffers


def compute_weight(module: nn.Module, dtype: torch.dtype) -> torch.Tensor:
    """module's weight in `dtype`: its fp32 parameter cast, or its int8
    weight widened to `dtype(q·s)` once quantized."""
    if is_quantized(module):
        return dequantize_int8(module.weight_q, module.weight_scale, dtype)
    return module.weight.to(dtype)


def _quantized_linear(module: nn.Module, x, weight_q):
    """x · dtype(q·s)ᵀ + bias for module's int8 weight viewed as (out, in)
    through the int8-weight linear kernel (its plain version with the
    module's `plain` flag)."""
    fn = _int8_linear_reference if module.plain else int8_linear
    b = None if module.bias is None else module.bias.to(module.dtype)
    return fn(x.to(module.dtype), weight_q, module.weight_scale, b)


class LayerNorm(nn.Module):
    """LayerNorm over the last axis with fp32 statistics; its output is in
    the compute dtype. Launches the LayerNorm kernel for CUDA tensors."""

    def __init__(self, dim: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.plain = False  # see set_plain
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def reset_parameters(self, generator=None) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        fn = _ln_reference if self.plain else fused_layer_norm
        return fn(x.to(self.dtype), self.weight, self.bias, self.eps)


class Dense(nn.Module):
    """Linear with a (out, in) weight, xavier-uniform by default (reference
    model_ecamp.py:127-132) or truncated normal with `init_std`."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: torch.dtype = torch.float32,
                 init_std: Optional[float] = None):
        super().__init__()
        self.dtype = dtype
        self.init_std = init_std
        self.plain = False  # see set_plain; read once quantized
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def reset_parameters(self, generator=None) -> None:
        if self.init_std is None:
            nn.init.xavier_uniform_(self.weight, generator=generator)
        else:
            trunc_normal_(self.weight, self.init_std, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        if is_quantized(self):
            return _quantized_linear(self, x, self.weight_q)
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


class Dropout(nn.Module):
    """Dropout from 16-bit random integers, as the JAX `Dropout` draws it:
    keep where bits >= round(rate * 65536), scale kept values by
    65536 / (65536 - thresh), so E[dropout(x)] == x for the quantized
    rate. The identity in eval mode or at rate 0.

    In training mode it draws from `self.generator`, an explicit
    `torch.Generator` on the input's device (`set_generator`); a rate > 0
    with no generator raises. The bits are not the TPU's: tests compare
    with dropout off, or compare distributions."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate
        self.generator: Optional[torch.Generator] = None

    def _generator(self) -> torch.Generator:
        if self.generator is None:
            raise RuntimeError(f"{type(self).__name__} in training mode draws "
                               f"from an explicit generator: call "
                               f"set_generator")
        return self.generator

    def _thresh(self) -> int:
        return min(int(round(self.rate * 65536)), 65535)

    def draws(self) -> bool:
        """Whether a call draws from the generator (training, rate > 0)."""
        return self.training and self._thresh() > 0

    def forward(self, x):
        if not self.draws():
            return x
        thresh = self._thresh()
        keep = torch.randint(0, 65536, x.shape, generator=self._generator(),
                             device=x.device, dtype=torch.int32) >= thresh
        return torch.where(keep, x * (65536.0 / (65536 - thresh)),
                           torch.zeros((), dtype=x.dtype, device=x.device))


class DropPath(Dropout):
    """Stochastic depth (timm DropPath, JAX `DropPath`): drop a residual
    branch per sample with probability `rate`, scaling kept samples by
    1 / (1 - rate)."""

    def draws(self) -> bool:
        return self.training and self.rate != 0.0

    def forward(self, x):
        if not self.draws():
            return x
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        keep = torch.rand(shape, generator=self._generator(),
                          device=x.device) < 1.0 - self.rate
        return torch.where(keep, x / (1.0 - self.rate),
                           torch.zeros((), dtype=x.dtype, device=x.device))


class Mlp(nn.Module):
    def __init__(self, in_features: int, hidden_features: int,
                 out_features: int, drop_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Dense(in_features, hidden_features, dtype=dtype)
        self.fc2 = Dense(hidden_features, out_features, dtype=dtype)
        self.drop = Dropout(drop_rate)

    def forward(self, x):
        x = self.drop(F.gelu(self.fc1(x)))  # exact erf GELU
        return self.drop(self.fc2(x))


class Attention(nn.Module):
    """timm-style multi-head self-attention with fused qkv projection;
    launches the attention kernel for CUDA tensors."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 attn_drop: float = 0.0, proj_drop: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.plain = False  # see set_plain
        self.qkv = Dense(dim, 3 * dim, bias=qkv_bias, dtype=dtype)
        self.proj = Dense(dim, dim, dtype=dtype)
        self.attn_drop = Dropout(attn_drop)
        self.proj_drop = Dropout(proj_drop)

    def forward(self, x, return_probs: bool = False):
        b, n, d = x.shape
        # (B, N, 3, H, hd) -> (3, B, H, N, hd); one copy makes q, k and v
        # each contiguous, as the kernel takes them
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, d // self.num_heads)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).contiguous().unbind(0)
        fn = _attention_reference if self.plain else dot_product_attention
        out = fn(q, k, v, return_probs=return_probs)
        probs = None
        if return_probs:
            out, probs = out
        out = out.transpose(1, 2).reshape(b, n, d)
        out = self.proj_drop(self.proj(self.attn_drop(out)))
        return (out, probs) if return_probs else out


class Block(nn.Module):
    """Pre-LN transformer block (timm Block semantics)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_rate: float = 0.0,
                 attn_drop: float = 0.0, norm_eps: float = 1e-6,
                 drop_path: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(dim, norm_eps, dtype)
        self.attn = Attention(dim, num_heads, qkv_bias, attn_drop, drop_rate,
                              dtype)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, norm_eps, dtype)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, drop_rate, dtype)

    def forward(self, x):
        x = x + self.drop_path(self.attn(self.norm1(x)))
        return x + self.drop_path(self.mlp(self.norm2(x)))


class Conv2d(nn.Module):
    """flax `nn.Conv` on NCHW tensors (channels_last in memory when the
    input is): the reference's OIHW `weight` and `bias` (none with
    `bias=False`), lecun-normal and zero at init, computed in `dtype`.
    Without `padding` it pads SAME, and a `stride` is taken by 1x1 kernels
    only, where flax's SAME padding is 0 at every input size. An integer
    `padding` is flax's explicit symmetric padding (`nn.Conv(padding=p)`,
    the ResNet stem's and strided 3x3's), with any stride."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, dtype: torch.dtype = torch.float32,
                 bias: bool = True, stride: int = 1,
                 padding: Optional[int] = None):
        super().__init__()
        if padding is None:
            if stride != 1 and kernel_size != 1:
                raise ValueError("a strided SAME Conv2d takes a 1x1 kernel "
                                 "only; give an explicit padding")
            padding = kernel_size // 2
        self.dtype = dtype
        self.padding = padding
        self.stride = stride
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def reset_parameters(self, generator=None) -> None:
        lecun_normal_(self.weight, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), compute_weight(self, self.dtype), b,
                        stride=self.stride, padding=self.padding)


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm(momentum, epsilon)` over the channels of an NCHW
    tensor, with torch BatchNorm's names (`weight`, `bias`,
    `running_mean`, `running_var`, `num_batches_tracked`). Not
    `F.batch_norm`: flax reduces in fp32 at least (float64 stays), takes
    the fast variance E[x^2] - E[x]^2 clipped at 0, feeds the running
    variance the biased batch variance, and normalises in fp32 before the
    cast to `dtype`. `momentum` is flax's (0.9 is torch's 0.1).

    `forward(x, train)`: with `train` the batch statistics normalise, and
    the running ones are updated in place; otherwise the running ones
    normalise. The module's `training` flag plays no part, as in flax.

    In a data-parallel process group the batch statistics are the global
    batch's, as flax's under GSPMD: each rank's fp32 mean and mean of
    squares are summed over the ranks by the differentiable all-reduce
    and divided by the world size (the loader gives every rank as many
    rows), so the running statistics stay equal on every rank. `train=
    False` calls no collective: ranks evaluate shards of their own."""

    def __init__(self, num_features: int, momentum: float = 0.9,
                 eps: float = 1e-5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    def reset_parameters(self, generator=None) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)
        self.running_mean.zero_()
        self.running_var.fill_(1.0)
        self.num_batches_tracked.zero_()

    def forward(self, x, train: bool = False):
        shape = (1, -1) + (1,) * (x.ndim - 2)
        if train:
            axes = [0] + list(range(2, x.ndim))
            # flax's `_compute_stats`: at least fp32 (float64 stays)
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            mean, mean_sq = xf.mean(axes), (xf * xf).mean(axes)
            if distributed.is_distributed():
                mean, mean_sq = (distributed.all_reduce_sum(
                    torch.stack([mean, mean_sq]))
                    / distributed.world_size()).unbind()
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x - mean.reshape(shape)) * mul.reshape(shape) \
            + self.bias.reshape(shape)
        return y.to(self.dtype)


def reset_conv_bn(module: nn.Module, generator) -> None:
    """Re-draw every `Conv2d` under `module` from `generator` and reset
    every `BatchNorm` to its start, in module order."""
    for m in module.modules():
        if isinstance(m, (Conv2d, BatchNorm)):
            m.reset_parameters(generator)


class PatchProj(nn.Module):
    """The patch embedding's strided conv, held as the reference's OIHW
    `weight` (D, C, p, p) and `bias`, computed exactly as a patch reshape
    and one matmul (no convolution algorithm choice, no TF32)."""

    def __init__(self, in_chans: int, embed_dim: int, patch_size: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        self.plain = False  # see set_plain; read once quantized
        self.weight = nn.Parameter(
            torch.empty(embed_dim, in_chans, patch_size, patch_size))
        self.bias = nn.Parameter(torch.zeros(embed_dim))

    def reset_parameters(self, generator=None) -> None:
        lecun_normal_(self.weight, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        """x: (B, H, W, C) -> (B, H/p * W/p, D)."""
        b, h, w, c = x.shape
        p = self.patch_size
        gh, gw = h // p, w // p
        x = x[:, :gh * p, :gw * p].to(self.dtype)  # VALID padding
        patches = (x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 5, 2, 4)
                   .reshape(b, gh * gw, c * p * p))
        if is_quantized(self):  # (D, C, p, p) -> (D, C * p * p), as patches
            return _quantized_linear(
                self, patches,
                self.weight_q.reshape(self.weight_q.shape[0], -1))
        return F.linear(patches, self.weight.reshape(self.weight.shape[0], -1)
                        .to(self.dtype), self.bias.to(self.dtype))


class PatchEmbed(nn.Module):
    """Image-to-patch embedding (timm PatchEmbed). Input is NHWC, as in the
    JAX package."""

    def __init__(self, patch_size: int = 16, in_chans: int = 3,
                 embed_dim: int = 768, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = PatchProj(in_chans, embed_dim, patch_size, dtype)

    def forward(self, x):
        return self.proj(x)


def set_plain(module: nn.Module, plain: bool = True) -> nn.Module:
    """Route every module under `module` that launches a kernel (LayerNorm,
    attention, the SR head, a quantized Dense or PatchProj: each has a
    `plain` flag) to the plain versions of its kernels, called directly
    (plain=True), or back to the kernel wrappers. The plain route is the
    on-card reference that the kernels are held against; serving and
    training never set it."""
    for m in module.modules():
        if hasattr(m, "plain"):
            m.plain = plain
    return module


def set_generator(module: nn.Module,
                  generator: Optional[torch.Generator]) -> nn.Module:
    """Give every Dropout and DropPath under `module` the generator they
    draw from in training mode."""
    for m in module.modules():
        if isinstance(m, Dropout):
            m.generator = generator
    return module


# -- activation checkpointing (the JAX package's `nn.remat` per block) -----

def _generators(block: nn.Module) -> List[torch.Generator]:
    """The distinct generators that `block`'s Dropout and DropPath modules
    draw from in a call, in module order."""
    gens: List[torch.Generator] = []
    for m in block.modules():
        if isinstance(m, Dropout) and m.draws():
            g = m._generator()
            if not any(g is h for h in gens):
                gens.append(g)
    return gens


class RematTape:
    """Where each remat block's dropout starts, for CUDA graphs of a step.

    Eagerly, `remat` snapshots each generator of a block with `get_state`
    and sets that state again for the backward's recompute. A capture
    cannot: there a generator's position is an offset within the graph,
    which no host call reads or sets, and a `clone_state` taken in the
    capture is not registered with the graph, so it cannot draw there. A
    graph's recomputes therefore draw from replay generators, one a block
    and generator, registered with the graph before its capture
    (`register`) and set before each replay (`seed`) to the seed of the
    generator they stand for and to the offset at which that generator
    entered the block. The offsets are recorded in an eager run of the
    same kind of step (`remat_tape(tape, "record")`), which draws the same
    counts: the step reseeds its generators first, so a block starts at
    the same offset in every such step. `remat_tape(tape, "replay")` hands
    the replay generators to the blocks in the order they run."""

    def __init__(self):
        self.entries: list = []   # (generators, their offsets at entry)
        self.replays: list = []   # per entry, a replay generator each
        self.taken = 0

    def register(self, graph) -> None:
        """Make the replay generators (once) and register each with
        `graph`, before its capture."""
        if not self.replays:
            self.replays = [[torch.Generator(g.device) for g in gens]
                            for gens, _ in self.entries]
        for reps in self.replays:
            for r in reps:
                graph.register_generator_state(r)

    def seed(self) -> None:
        """Before a replay, after the step's generators were reseeded: each
        replay generator at its generator's seed and recorded offset."""
        for (gens, offsets), reps in zip(self.entries, self.replays):
            for g, offset, r in zip(gens, offsets, reps):
                r.manual_seed(g.initial_seed())
                r.set_offset(offset)

    def take(self, gens) -> List[torch.Generator]:
        """The replay generators of the next block in a capture."""
        if self.taken >= len(self.entries):
            raise RuntimeError("remat under a CUDA graph capture: more "
                               "blocks draw dropout than the eager step "
                               "recorded")
        want, _ = self.entries[self.taken]
        if len(want) != len(gens) or any(a is not b
                                         for a, b in zip(want, gens)):
            raise RuntimeError("remat under a CUDA graph capture: a block "
                               "draws from other generators than the eager "
                               "step recorded")
        self.taken += 1
        return self.replays[self.taken - 1]


_TAPE: Optional[tuple] = None  # (RematTape, "record" or "replay")


@contextlib.contextmanager
def remat_tape(tape: RematTape, mode: str):
    """Record the remat blocks' dropout offsets in an eager step
    (`mode="record"`), or hand a capture's blocks their replay generators
    (`"replay"`; every recorded block must take its own)."""
    global _TAPE
    if mode not in ("record", "replay"):
        raise ValueError(f"remat_tape mode {mode!r}")
    prev, _TAPE = _TAPE, (tape, mode)
    tape.taken = 0
    if mode == "record":
        tape.entries, tape.replays = [], []
    try:
        yield tape
    finally:
        _TAPE = prev
    if mode == "replay" and tape.taken != len(tape.entries):
        raise RuntimeError(f"remat under a CUDA graph capture: "
                           f"{tape.taken} blocks drew dropout, the eager "
                           f"step recorded {len(tape.entries)}")


@contextlib.contextmanager
def _states_set(gens, states, get, put):
    """`gens` at `states` inside, at what they held before after."""
    held = [get(g) for g in gens]
    for g, s in zip(gens, states):
        put(g, s)
    try:
        yield
    finally:
        for g, s in zip(gens, held):
            put(g, s)


def _dropout_replay(gens):
    """`checkpoint`'s context_fn: nothing around the forward, and around
    the recompute the block's generators where the forward found them.
    Called at the block's entry, before its forward draws."""
    none = contextlib.nullcontext()
    if not gens:
        return none, none
    if gens[0].device.type == "cuda" and \
            torch.cuda.is_current_stream_capturing():
        if _TAPE is None or _TAPE[1] != "replay":
            raise RuntimeError(
                "remat under a CUDA graph capture replays dropout through "
                "generators registered with the graph: capture the step "
                "through train/graphed.py::GraphedSteps")
        return none, _states_set(
            gens, _TAPE[0].take(gens), lambda g: g.graphsafe_get_state(),
            lambda g, s: g.graphsafe_set_state(s))
    if _TAPE is not None and _TAPE[1] == "record":
        _TAPE[0].entries.append((list(gens),
                                 [g.get_offset() for g in gens]))
    return none, _states_set(gens, [g.get_state() for g in gens],
                             lambda g: g.get_state(),
                             lambda g, s: g.set_state(s))


def call(module: nn.Module, *args, **kwargs):
    """`module(*args, **kwargs)`; where `module` is a unit of a model whose
    parameters are sharded over the ranks (FSDP, `core/distributed.py::
    Fsdp`), on its parameters all-gathered for the call, whose backward
    reduce-scatters their gradient."""
    unit = getattr(module, "fsdp_unit", None)
    if unit is None:
        return module(*args, **kwargs)
    return unit(*args, **kwargs)


def remat(block: nn.Module, *args):
    """`call(block, *args)` under an activation checkpoint, as the JAX
    package's `nn.remat(Block)`: the forward keeps the block's inputs
    only, and the backward runs the block again from them, through the
    same kernels (their `autograd.Function`s save through
    `save_for_backward`, which the non-reentrant checkpoint intercepts)
    and with the same dropout bits, so gradients and updates equal the
    plain call's; only peak memory and time change. The default generators are not stashed
    (`preserve_rng_state=False`): the port draws from explicit ones
    (`set_generator`), which `_dropout_replay` sets back for the
    recompute. An FSDP unit's gather runs inside the checkpoint, so the
    recompute gathers again and the gathered parameters are not held
    from the forward to the backward. Without autograd (`torch.no_grad`,
    an eval step, a `stop_trunk_grad` trunk) or with nothing in the call
    that requires a gradient, the block runs as it is."""
    if not torch.is_grad_enabled() or not (
            any(torch.is_tensor(a) and a.requires_grad for a in args)
            or any(p.requires_grad for p in block.parameters())):
        return call(block, *args)
    return checkpoint(call, block, *args, use_reentrant=False,
                      preserve_rng_state=False,
                      context_fn=functools.partial(_dropout_replay,
                                                   _generators(block)))
