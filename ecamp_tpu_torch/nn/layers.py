"""Shared transformer layers (counterpart of `ecamp_tpu/nn/layers.py`).

timm-0.4.12-semantics ViT block: pre-LN, fused qkv with bias, exact (erf)
GELU. Parameter names follow the reference's torch module tree
(`qkv/proj/fc1/fc2/norm1/norm2`, LayerNorm `weight`/`bias`), so a
reference state dict loads with `load_state_dict(strict=True)`.

Precision: parameters stay fp32; each module casts its weights to its
compute `dtype` at every call, as flax's `Dense(dtype=bf16)` does inside
the jitted apply. No bf16 copy of the weights is kept, so serving holds
one fp32 copy and pays one cast per weight per call.

Initialisation mirrors the JAX defaults (xavier-uniform Linear, lecun-
normal patch conv, zero biases, unit LayerNorm) and draws from an explicit
`torch.Generator` passed to `reset_parameters`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import dot_product_attention, fused_layer_norm
from ..kernels.flash_attention import _attention_reference
from ..kernels.layer_norm import _ln_reference

# flax truncated_normal / variance_scaling draw from N(0, 1) cut at +-2 and
# divide by the cut distribution's std so the result has the asked std
_TRUNC_STD = 0.87962566103423978


def trunc_normal_(t: torch.Tensor, std: float,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """Normal(0, std) truncated at +-2 std (flax `truncated_normal`)."""
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


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
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


class Dropout(nn.Module):
    """Identity at inference. The training path is not ported yet (ROADMAP
    Queue 1); a non-zero rate in training mode raises rather than run
    without the regulariser."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x):
        if self.training and self.rate > 0.0:
            raise NotImplementedError(
                "dropout in training mode is not ported (ROADMAP Queue 1)")
        return x


DropPath = Dropout  # stochastic depth: the same inference identity


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


class PatchProj(nn.Module):
    """The patch embedding's strided conv, held as the reference's OIHW
    `weight` (D, C, p, p) and `bias`, computed exactly as a patch reshape
    and one matmul (no convolution algorithm choice, no TF32)."""

    def __init__(self, in_chans: int, embed_dim: int, patch_size: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_size = patch_size
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(embed_dim, in_chans, patch_size, patch_size))
        self.bias = nn.Parameter(torch.zeros(embed_dim))

    def reset_parameters(self, generator=None) -> None:
        # flax nn.Conv default: lecun_normal = truncated normal, var 1/fan_in
        fan_in = self.weight[0].numel()
        trunc_normal_(self.weight, math.sqrt(1.0 / fan_in) / _TRUNC_STD,
                      generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        """x: (B, H, W, C) -> (B, H/p * W/p, D)."""
        b, h, w, c = x.shape
        p = self.patch_size
        gh, gw = h // p, w // p
        x = x[:, :gh * p, :gw * p].to(self.dtype)  # VALID padding
        patches = (x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 5, 2, 4)
                   .reshape(b, gh * gw, c * p * p))
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
    """Route every LayerNorm and Attention under `module` to the plain
    versions of their kernels, called directly (plain=True), or back to
    the kernel wrappers. The plain route is the on-card reference that the
    kernels are held against; serving never sets it."""
    for m in module.modules():
        if isinstance(m, (LayerNorm, Attention)):
            m.plain = plain
    return module
