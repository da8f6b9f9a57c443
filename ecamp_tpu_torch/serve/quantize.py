"""Weight-only int8 quantization for serving (counterpart of
`ecamp_tpu/serve/quantize.py`).

Small-batch inference is bound by reading the weights: symmetric
per-output-channel int8 halves those bytes against bf16. The tensors
quantized are exactly those the JAX package's `_should_quantize` picks: the
weights that are flax `kernel` leaves there (those of `Dense`, `PatchProj`,
`Conv2d` and the SR head's `Conv3x3` here, the MLM decoder's included)
with at least `min_elems` elements (ndim >= 2 always holds for them).
Embeddings, LayerNorm and BatchNorm parameters, biases and BatchNorm
statistics stay in float.

One scale an output channel, axis 0 of the port's (out, in) and OIHW
weights (the last axis of flax's (in, out) and HWIO): s = max|w| / 127 in
fp32, 1 for an all-zero channel; q = clamp(round_half_even(w / s), -127,
127). The arithmetic is the JAX package's, on the CPU, so q and s are
bit-equal to it.

`quantize_module_int8` replaces each chosen `weight` parameter in place by
an int8 buffer `weight_q` of the same shape and an fp32 `(out,)` buffer
`weight_scale`; the fp32 parameter is dropped, so a model moved to the
card afterwards holds the int8 copy only. `Dense` and `PatchProj` then run
the int8-weight linear kernel (`kernels/int8_linear.py`), `Conv2d` and
`Conv3x3` widen the weight in torch ops (`nn/layers.py::compute_weight`).
A quantized module has no backward.
"""

from __future__ import annotations

from typing import Iterator, List, Mapping, Optional, Tuple

import torch
from torch import nn

from ..kernels.int8_linear import dequantize_int8
from ..nn.layers import Conv2d, Dense, PatchProj, is_quantized

MIN_ELEMS = 1 << 16  # the JAX package's default size floor


def _kernel_modules() -> tuple:
    """The port's modules whose `weight` is a flax `kernel` leaf in JAX."""
    from ..nn.mae import Conv3x3

    return Dense, PatchProj, Conv2d, Conv3x3


def _chosen(model: nn.Module, min_elems: int
            ) -> Iterator[Tuple[str, nn.Module]]:
    kinds = _kernel_modules()
    for name, m in model.named_modules():
        if (isinstance(m, kinds) and not is_quantized(m)
                and m.weight.ndim >= 2 and m.weight.numel() >= min_elems):
            yield name, m


def quantize_weight_int8(w: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8 of w's shape, s fp32 (out,)) of a weight with its output
    channels on axis 0, computed in fp32 on the CPU."""
    w = w.detach().to("cpu", torch.float32)
    s = w.abs().amax(dim=tuple(range(1, w.ndim)))
    # a tensor divisor: torch may turn a division by a scalar into a
    # multiplication by its reciprocal, which is not numpy's rounding
    s = s / torch.full_like(s, 127.0)
    s = torch.where(s == 0, torch.ones_like(s), s)
    q = torch.round(w / s.reshape((-1,) + (1,) * (w.ndim - 1)))
    return torch.clamp(q, -127, 127).to(torch.int8), s


def quantize_module_int8(model: nn.Module,
                         min_elems: Optional[int] = None) -> List[str]:
    """Quantize, in place, every weight of `model` that the JAX package
    quantizes at this `min_elems` (`MIN_ELEMS` if None); returns the names
    of the modules whose weight was replaced, in module order."""
    if min_elems is None:
        min_elems = MIN_ELEMS
    names = []
    for name, m in _chosen(model, min_elems):
        device = m.weight.device
        q, s = quantize_weight_int8(m.weight)
        del m.weight
        m.register_buffer("weight_q", q.to(device))
        m.register_buffer("weight_scale", s.to(device))
        names.append(name)
    return names


def quantized_modules(model: nn.Module) -> List[str]:
    """Names of the modules of `model` that hold an int8 weight."""
    return [name for name, m in model.named_modules() if is_quantized(m)]


def dequantized_state(model: nn.Module) -> dict:
    """{"<module>.weight": fp32 q · s} of every quantized module: the
    weights the int8 model computes with before the cast to its compute
    dtype (the JAX package's `dequantize`)."""
    return {f"{name}.weight" if name else "weight":
            dequantize_int8(m.weight_q, m.weight_scale, torch.float32)
            for name, m in model.named_modules() if is_quantized(m)}


def quantization_error(state: Mapping[str, torch.Tensor],
                       model: nn.Module) -> float:
    """Largest relative L2 error ||w - q·s|| / ||w|| over the quantized
    weights of `model`, against `state`, its state dict from before
    `quantize_module_int8` (symmetric int8 on well-scaled weights lands
    around 0.2-0.5%)."""
    worst = 0.0
    for key, d in dequantized_state(model).items():
        o = state[key].detach().to("cpu", torch.float32)
        err = float(torch.linalg.vector_norm(o - d.cpu())
                    / max(float(torch.linalg.vector_norm(o)), 1e-12))
        worst = max(worst, err)
    return worst
