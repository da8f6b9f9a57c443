"""Mixed-precision policy (counterpart of `ecamp_tpu.core.dtypes`).

Params stay fp32; activations and matmuls run in bf16; LayerNorm and
softmax statistics and the classifier head run in fp32. bf16 has fp32's
exponent range, so no loss scaling is needed.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class DTypePolicy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    # dtype for loss/softmax/layer-norm statistics accumulation
    reduce_dtype: torch.dtype = torch.float32


DEFAULT_POLICY = DTypePolicy()
FP32_POLICY = DTypePolicy(compute_dtype=torch.float32)


def policy(bf16: bool = True) -> DTypePolicy:
    return DEFAULT_POLICY if bf16 else FP32_POLICY
