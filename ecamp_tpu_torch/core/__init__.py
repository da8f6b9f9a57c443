from .config import (BertConfig, DataConfig, MAEDecoderConfig,
                     OptimizerConfig, PretrainConfig, ViTConfig, vit_base,
                     vit_tiny)
from .dtypes import DEFAULT_POLICY, FP32_POLICY, DTypePolicy, policy

__all__ = ["BertConfig", "DataConfig", "MAEDecoderConfig", "OptimizerConfig",
           "PretrainConfig", "ViTConfig", "vit_base", "vit_tiny",
           "DTypePolicy", "DEFAULT_POLICY", "FP32_POLICY", "policy"]
