"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Importing this package builds nothing: the CUDA library is compiled at
the first launch (`_build.py`), so the CPU tests import every module.
"""

from .attention import dot_product_attention
from .layer_norm import fused_layer_norm

# `flash_attention` stays the submodule's name here (the wrapper of the same
# name is `kernels.flash_attention.flash_attention`)
__all__ = ["dot_product_attention", "fused_layer_norm"]
