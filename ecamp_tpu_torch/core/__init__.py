from .config import ViTConfig, vit_base, vit_tiny
from .dtypes import DEFAULT_POLICY, FP32_POLICY, DTypePolicy, policy

__all__ = ["ViTConfig", "vit_base", "vit_tiny", "DTypePolicy",
           "DEFAULT_POLICY", "FP32_POLICY", "policy"]
