"""ViT configuration, field for field the same as `ecamp_tpu.core.config`.

Only the trunk config is ported with the serving path; the other configs
follow with the modules that read them.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ViTConfig:
    """ViT trunk hyperparameters (ViT-B/16 default).

    Mirrors the shared encoder of the reference (model_ecamp.py:328-333,
    Classification/models_vit.py:124-128).
    """

    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    norm_eps: float = 1e-6
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    # stochastic depth, linspace-ramped 0 -> rate across blocks (timm)
    drop_path_rate: float = 0.0
    # kept for field parity with the JAX config; the port serves (no
    # backward pass), so activation checkpointing has nothing to act on
    remat: bool = False

    @property
    def grid_size(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size


def vit_tiny(**kw) -> ViTConfig:
    return ViTConfig(embed_dim=192, depth=12, num_heads=12, **kw)


def vit_base(**kw) -> ViTConfig:
    return ViTConfig(embed_dim=768, depth=12, num_heads=12, **kw)
