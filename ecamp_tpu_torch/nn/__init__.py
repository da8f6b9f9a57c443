from .layers import (Attention, BatchNorm, Block, Conv2d, Dense, Dropout,
                     DropPath, LayerNorm, Mlp, PatchEmbed, set_generator,
                     set_plain)
from .det import (YOLO_ANCHORS, Bottleneck, DetectionLayers,
                  DetectionModel, DetEncoder, ViTDetector)
from .pos_embed import get_2d_sincos_pos_embed, interpolate_pos_embed
from .resnet import ResNet50Backbone
from .seg import ConvDecoder, SegEncoder, SegViT, SegViTDual
from .unet import ResNetUNet
from .vit import ViTClassifier, VisionTransformer

__all__ = ["Attention", "BatchNorm", "Block", "Conv2d", "Dense", "Dropout",
           "DropPath", "LayerNorm", "Mlp", "PatchEmbed", "set_generator",
           "set_plain", "get_2d_sincos_pos_embed", "interpolate_pos_embed",
           "YOLO_ANCHORS", "Bottleneck", "DetectionLayers", "DetectionModel",
           "DetEncoder", "ViTDetector", "ResNet50Backbone", "ResNetUNet",
           "ConvDecoder", "SegEncoder", "SegViT", "SegViTDual",
           "ViTClassifier", "VisionTransformer"]
