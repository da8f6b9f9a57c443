from .layers import (Attention, Block, Dense, Dropout, DropPath, LayerNorm,
                     Mlp, PatchEmbed, set_generator, set_plain)
from .pos_embed import get_2d_sincos_pos_embed, interpolate_pos_embed
from .vit import ViTClassifier, VisionTransformer

__all__ = ["Attention", "Block", "Dense", "Dropout", "DropPath", "LayerNorm",
           "Mlp", "PatchEmbed", "set_generator", "set_plain",
           "get_2d_sincos_pos_embed", "interpolate_pos_embed",
           "ViTClassifier", "VisionTransformer"]
