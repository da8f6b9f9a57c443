"""ViT trunk + classification model (counterpart of `ecamp_tpu/nn/vit.py`).

Forward semantics match timm 0.4.12 as the reference uses it:
patch_embed -> prepend cls -> +pos_embed (learnable) -> blocks ->
either global-pool (mean of patch tokens) + fc_norm (Classification/
models_vit.py:90-93) or norm + cls token (:95-96).

`ViTClassifier` subclasses the trunk, as timm's classifier does, so its
state dict has the reference's flat namespace (`patch_embed.*`,
`cls_token`, `pos_embed`, `blocks.{i}.*`, `fc_norm.*` or `norm.*`,
`head.*`) with no `trunk.` prefix.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core.config import ViTConfig
from .layers import Block, Dense, Dropout, LayerNorm, PatchEmbed


class VisionTransformer(nn.Module):
    """Trunk: returns the full token sequence (cls + patches) after the
    blocks. Heads decide what normalization to apply."""

    def __init__(self, cfg: ViTConfig, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.dtype = dtype
        self.patch_embed = PatchEmbed(c.patch_size, c.in_chans, c.embed_dim,
                                      dtype)
        self.cls_token = nn.Parameter(torch.empty(1, 1, c.embed_dim))
        self.pos_embed = nn.Parameter(
            torch.empty(1, c.num_patches + 1, c.embed_dim))
        self.pos_drop = Dropout(c.drop_rate)
        # stochastic-depth rate ramps linearly across blocks (timm)
        self.blocks = nn.ModuleList([
            Block(c.embed_dim, c.num_heads, c.mlp_ratio, c.qkv_bias,
                  c.drop_rate, c.attn_drop_rate, c.norm_eps,
                  c.drop_path_rate * i / max(c.depth - 1, 1), dtype)
            for i in range(c.depth)])
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Initialise every parameter from `generator` (JAX init rules)."""
        with torch.no_grad():
            nn.init.normal_(self.cls_token, 0.0, 0.02, generator=generator)
            nn.init.normal_(self.pos_embed, 0.0, 0.02, generator=generator)
            for m in self.modules():
                if m is not self and hasattr(m, "reset_parameters"):
                    m.reset_parameters(generator)

    def forward(self, x):
        """x: (B, H, W, C) -> tokens (B, 1 + N, D) in the compute dtype."""
        x = self.patch_embed(x)
        b = x.shape[0]
        cls = self.cls_token.to(self.dtype).expand(b, -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(self.dtype)
        x = self.pos_drop(x)
        for blk in self.blocks:
            x = blk(x)
        return x


class ViTClassifier(VisionTransformer):
    """Classification / linear-probe model (reference
    Classification/models_vit.py:60-98 + head)."""

    def __init__(self, cfg: ViTConfig, num_classes: int,
                 global_pool: bool = True, head_init_std: float = 2e-5,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg, dtype, generator)
        self.global_pool = global_pool
        norm = LayerNorm(cfg.embed_dim, cfg.norm_eps, dtype)
        if global_pool:
            self.fc_norm = norm
        else:
            self.norm = norm
        # the head runs in fp32 on the fp32-cast pooled feature
        self.head = Dense(cfg.embed_dim, num_classes, dtype=torch.float32,
                          init_std=head_init_std)
        norm.reset_parameters(generator)
        self.head.reset_parameters(generator)

    def forward(self, x, stop_trunk_grad: bool = False,
                features_only: bool = False):
        """x: (B, H, W, C) -> fp32 logits (B, num_classes), or with
        `features_only` the pooled pre-head feature. `stop_trunk_grad` is
        the linear probe's mode (train.py:156-159 freezes all but the head):
        the trunk runs with its dropout and drop-path as the module's mode
        says, but records no autograd graph, so only the norm and the head
        receive gradients and the trunk's backward is never run. Its
        LayerNorm and attention wrappers then launch their kernels without
        an `autograd.Function`."""
        if stop_trunk_grad:
            with torch.no_grad():
                tokens = super().forward(x)
        else:
            tokens = super().forward(x)
        if self.global_pool:
            feat = self.fc_norm(tokens[:, 1:, :].mean(dim=1))
        else:
            feat = self.norm(tokens)[:, 0]
        if features_only:
            return feat
        return self.head(feat.float())
