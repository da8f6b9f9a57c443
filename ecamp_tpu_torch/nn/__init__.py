from .layers import (Attention, Block, Dense, Dropout, DropPath, LayerNorm,
                     Mlp, PatchEmbed, set_plain)
from .pos_embed import interpolate_pos_embed
from .vit import ViTClassifier, VisionTransformer

__all__ = ["Attention", "Block", "Dense", "Dropout", "DropPath", "LayerNorm",
           "Mlp", "PatchEmbed", "set_plain", "interpolate_pos_embed",
           "ViTClassifier", "VisionTransformer"]
