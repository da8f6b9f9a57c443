from .config import (BertConfig, ClassificationConfig, DataConfig,
                     DetectionConfig,
                     MAEDecoderConfig, OptimizerConfig, PretrainConfig,
                     SegmentationConfig, ViTConfig, vit_base,
                     vit_base_singlechannel, vit_huge, vit_large, vit_tiny)
from .dtypes import DEFAULT_POLICY, FP32_POLICY, DTypePolicy, policy

__all__ = ["BertConfig", "ClassificationConfig", "DataConfig",
           "DetectionConfig",
           "MAEDecoderConfig", "OptimizerConfig", "PretrainConfig",
           "SegmentationConfig", "ViTConfig", "vit_base",
           "vit_base_singlechannel", "vit_huge", "vit_large", "vit_tiny",
           "DTypePolicy", "DEFAULT_POLICY", "FP32_POLICY", "policy"]
