"""int8-weight linear: the CUDA kernel `csrc/int8_linear.cu` and its plain
version, `y = x · bf16(float(q) · s)ᵀ + b`.

Replaces no Pallas kernel. The JAX package's `--quantize int8`
(`ecamp_tpu/serve/quantize.py:60-83`) keeps each chosen weight as int8 with
one fp32 scale an output channel and dequantises it inside the jitted
apply, where XLA fuses the convert into the consuming dot: the weights leave
device memory as int8. Done in torch ops, the same math would write a
dequantised bf16 copy of every weight and read it again on every forward,
more bytes than serving the fp32 weights. The kernel is that fusion: it
reads the int8 weight and widens it on chip (see the note in the source).

What bounds it on the H100: at bucket 64's M = 12,608 the tensor cores
(2·M·N·K operations); at serving's M = 197 rows an image the few tiles
there are to spread over 132 SMs, each walking the whole K. The kernel is
one TMA + `wgmma` mainloop on tiles of 128 output channels by BT tokens
(BT = 256 or 128) that widens the int8 weight on chip straight into
`wgmma`'s register operand; where the tiles are too few, it splits K
across blocks and a second launch sums the fp32 partials in a fixed order
(see the note in the source). `_plan` picks BT and the split from the
shape: a plain function, so the CPU tests can read what the card will
run.

`int8_linear` launches the kernel for CUDA tensors and runs the plain
version only for CPU tensors; it never falls back. The weights are frozen,
so there is no backward: a call that autograd would have to see raises, on
either device. On a CUDA tensor it also raises for another x than bf16, a
K that is not a multiple of 16, and a bias in another dtype than x's.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build

SOURCE = "ecamp_tpu_torch/csrc/int8_linear.cu"
K_MULTIPLE = 16  # a wgmma step's depth; keeps TMA's row strides 16-byte
MAX_ROWS = 2 ** 31 - 1  # the C entry's int M (a persistent grid: no limit)
MAX_SPLIT_ROWS = 65535  # split-K's reduction: a block a row of partials
BN, BK = 128, 64  # channels of a tile (two warpgroups of 64); a stage's depth
TILE_T = (256, 128)  # tokens (rows of x) of a tile, the wider first
# _plan's cost model, in microseconds of an H100 SXM at 700 W, fitted to
# `tools/kernel_ab.py . TAG int8_plans` (PERF.md, PR 16)
STAGE_US = {128: 0.51, 256: 0.72}  # one 64-deep stage of a BT x 128 tile
UNIT_US = 1.5  # a unit's first loads and its epilogue
REDUCE_US = 2.2  # split-K's reduction: its launch and the partials' epilogue
PARTIAL_BYTES_PER_US = 4.5e6  # fp32 partials written and read back (in L2)

launches = _build.LaunchCounter()


class Plan(NamedTuple):
    """How the kernel cuts y = x · wᵀ: tiles of `bt` tokens by 128
    channels, numbered row of tiles by row of tiles; the first `whole` of
    them one work unit each, the rest (the tail) cut into the other units,
    on a persistent grid of `grid` blocks. More units than tiles split the
    tail's K: tile t takes `splits` or `splits` - 1 units, each a whole
    number of 64-deep stages, and a second launch sums their fp32 partials
    (rows `row0(n)` on) into y."""
    bt: int
    tiles: int
    whole: int
    units: int
    grid: int

    @property
    def splits(self) -> int:
        """The most units of one tile (the partials' depth)."""
        if self.units == self.tiles:
            return 1
        return -(-(self.units - self.whole) // (self.tiles - self.whole))

    def row0(self, n: int) -> int:
        """The partials' first row: the first row of the first tail tile."""
        return self.whole // -(-n // BN) * self.bt


def split_stages(plan: Plan, k: int) -> list:
    """The (first, end) stage of every unit of every tile, tile by tile, in
    the kernel's order of units (`unit_of` in the source)."""
    nk = -(-k // BK)
    ranges = [[(0, nk)] for _ in range(plan.whole)]
    tail = plan.tiles - plan.whole
    if tail:
        base, extra = divmod(plan.units - plan.whole, tail)
        for i in range(tail):
            n = base + (i < extra)
            ranges.append([(j * nk // n, (j + 1) * nk // n) for j in range(n)])
    return ranges


def _modelled_us(plan: Plan, m: int, n: int, k: int, sms: int) -> float:
    """_plan's cost model: blocks take their units in turn, each UNIT_US
    plus STAGE_US a stage of its longest split; a split adds the
    reduction and its fp32 partials' round trip."""
    nk, stage = -(-k // BK), STAGE_US[plan.bt]
    if plan.units == plan.tiles:
        return -(-plan.tiles // sms) * (UNIT_US + nk * stage)
    tail, tail_units = plan.tiles - plan.whole, plan.units - plan.whole
    us = plan.whole // sms * (UNIT_US + nk * stage)
    tail_stages = -(-nk // (tail_units // tail))
    us += -(-tail_units // sms) * (UNIT_US + tail_stages * stage)
    rows = m - plan.row0(n)
    return us + REDUCE_US + 4 * plan.splits * rows * n / PARTIAL_BYTES_PER_US


@functools.lru_cache(maxsize=4096)
def _plan(m: int, n: int, k: int, sms: int) -> Plan:
    """The token tile and the work units for an (m, k) x and an (n, k)
    weight on a card of `sms` SMs: the plan of least modelled time
    (`_modelled_us`). Candidates: one unit a tile; where the tiles are
    fewer than the SMs, K split into one to three whole waves of units;
    where the last wave of tiles would leave SMs idle, the waves of whole
    tiles and the last tiles split into one wave of units."""
    nk = -(-k // BK)
    best = None
    for bt in TILE_T:
        tiles = -(-m // bt) * -(-n // BN)
        cands = [Plan(bt, tiles, tiles, tiles, min(tiles, sms))]
        if tiles < sms:
            cands += [Plan(bt, tiles, 0, r * sms, sms) for r in (1, 2, 3)
                      if tiles < r * sms <= tiles * nk]
        elif tiles % sms:
            whole = tiles // sms * sms
            if sms <= (tiles - whole) * nk:
                cands.append(Plan(bt, tiles, whole, whole + sms, sms))
        for plan in cands:
            if plan.units > tiles and m - plan.row0(n) > MAX_SPLIT_ROWS:
                continue
            key = (_modelled_us(plan, m, n, k, sms), plan.units, -bt)
            if best is None or key < best[0]:
                best = (key, plan)
    return best[1]


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def dequantize_int8(q, s, dtype):
    """The weight `q · s` (scale per output channel, axis 0) in fp32, then
    in `dtype`: the JAX package's `dequantize` (`q.astype(f32) * s`)
    followed by the consuming layer's cast to its compute dtype."""
    return (q.float() * s.reshape((-1,) + (1,) * (q.ndim - 1))).to(dtype)


def _int8_linear_reference(x, q, s, b=None):
    """Plain PyTorch: F.linear with the dequantised weight in x's dtype."""
    return F.linear(x, dequantize_int8(q, s, x.dtype), b)


def _int8_linear_cuda(x, q, s, b, plan=None):
    """The kernel's launch; `plan` replaces `_plan`'s (the card tests drive
    every path with it, tools/kernel_ab.py times the candidates)."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"int8-linear kernel takes a bf16 x, got {x.dtype}")
    if q.dtype != torch.int8 or q.ndim != 2:
        raise ValueError(f"int8-linear kernel takes an (N, K) int8 weight, "
                         f"got {tuple(q.shape)} {q.dtype}")
    n, k = q.shape
    if x.shape[-1] != k:
        raise ValueError(f"x's last dim {x.shape[-1]} != the weight's K {k}")
    if k == 0 or k % K_MULTIPLE:
        raise ValueError(f"int8-linear kernel takes K a multiple of "
                         f"{K_MULTIPLE}, got {k}")
    if s.shape != (n,) or s.dtype != torch.float32:
        raise ValueError(f"scales must be ({n},) fp32, got {tuple(s.shape)} "
                         f"{s.dtype}")
    if b is not None and (b.shape != (n,) or b.dtype != x.dtype):
        raise ValueError(f"bias must be ({n},) {x.dtype}, got "
                         f"{tuple(b.shape)} {b.dtype}")
    if any(t is not None and t.device != x.device for t in (q, s, b)):
        raise ValueError("x, q, s and b must be on one device")
    lead = x.shape[:-1]
    rows = x.numel() // k
    if rows > MAX_ROWS:
        raise ValueError(f"int8-linear kernel takes <= {MAX_ROWS} rows, "
                         f"got {rows}")
    if not _build.on_current_device(x):
        with torch.cuda.device(x.device):
            return _int8_linear_cuda(x, q, s, b, plan)
    x2 = x.reshape(rows, k)
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        x2 = x2.clone(memory_format=torch.contiguous_format)
    if not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError("int8-linear kernel takes a contiguous, 16-byte "
                         "aligned weight")
    s = s.contiguous()
    b = None if b is None else b.contiguous()
    y = torch.empty((rows, n), dtype=x.dtype, device=x.device)
    if rows == 0 or n == 0:
        return y.reshape(*lead, n)
    if plan is None:
        plan = _plan(rows, n, k, _sm_count(x.get_device()))
    part = None
    if plan.units > plan.tiles:  # split-K: the fp32 partials
        part = torch.empty(plan.splits * (rows - plan.row0(n)) * n,
                           dtype=torch.float32, device=x.device)
    err = _build.library().ecamp_int8_linear(
        x2.data_ptr(), q.data_ptr(), s.data_ptr(),
        None if b is None else b.data_ptr(), y.data_ptr(),
        None if part is None else part.data_ptr(), rows, n, k, plan.bt,
        plan.whole, plan.units, plan.grid, _build.launch_stream(x))
    _build.check(err, "ecamp_int8_linear")
    launches.add()
    return y.reshape(*lead, n)


def int8_linear(x, q, s, b=None):
    """y = x · bf16(float(q) · s)ᵀ + b. x: (..., K); q: (N, K) int8;
    s: (N,) fp32; b: (N,) in x's dtype or None. Not differentiable."""
    if _build.needs_grad(x, b):
        raise RuntimeError("int8_linear has no backward (the quantized "
                           "weights are frozen): call it under "
                           "torch.no_grad() or torch.inference_mode()")
    if x.is_cuda:
        return _int8_linear_cuda(x, q, s, b)
    if x.device.type != "cpu":
        raise ValueError(f"no int8-linear kernel for device {x.device}")
    return _int8_linear_reference(x, q, s, b)
