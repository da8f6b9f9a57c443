"""Attention dispatch (counterpart of `ecamp_tpu/kernels/attention.py`).

Every attention goes to `flash_attention`: the CUDA kernel for CUDA
tensors, its plain version for CPU tensors. The TPU's work gate
(`_MIN_FUSED_WORK`, a v5e measurement) is not carried over. Only a caller
that needs the probabilities materialised (`return_probs=True`, the
visualizer) gets the plain version, which returns them.
"""

from __future__ import annotations

from typing import Optional

import torch

from .flash_attention import _attention_reference, flash_attention


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          bias: Optional[torch.Tensor] = None,
                          scale: Optional[float] = None,
                          return_probs: bool = False):
    """q, k, v: (B, H, N, D). bias: additive, broadcastable to
    (B, H, Nq, Nk).

    Returns (B, H, Nq, D); with return_probs=True also the fp32 probs
    (the kernel never materialises them)."""
    if return_probs:
        return _attention_reference(q, k, v, bias, scale, return_probs=True)
    return flash_attention(q, k, v, bias=bias, scale=scale)
