"""Engine factory for the classifier (counterpart of
`ecamp_tpu/serve/loaders.py::classifier_engine`).

The other engines (segmentation, detection, embedding) are not ported yet
(ROADMAP Queue 1); nor are orbax checkpoints or int8 weights. The
classifier serves the `.pth` that `cli/finetune_cls.py` writes.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from ..core.config import ViTConfig
from ..core.dtypes import policy
from .engine import InferenceEngine, sigmoid_np, softmax_np


def classifier_engine(checkpoint: str = "", num_classes: int = 14,
                      img_size: int = 224, multilabel: bool = True,
                      vit: Optional[ViTConfig] = None,
                      buckets=(8, 32, 64), bf16: bool = True,
                      device="cuda", seed: int = 0) -> InferenceEngine:
    """Serve ViTClassifier logits -> probabilities (sigmoid for multilabel
    BCE tasks, softmax for single-label CE tasks — Classification/
    train.py:199-202 semantics).

    Without a checkpoint the weights are a seeded random init (`seed`,
    through a `torch.Generator`). The served module is `engine.model`."""
    from ..ckpt import load_classifier_state, load_reference_pth
    from ..nn import ViTClassifier

    if checkpoint and not checkpoint.endswith(".pth"):
        kind = "an orbax directory" if os.path.isdir(checkpoint) else "not a .pth"
        raise ValueError(
            f"checkpoint {checkpoint!r} is {kind}: the port loads reference "
            f".pth files only, as its fine-tune CLI writes them "
            f"(best/checkpoint-best.pth); orbax checkpoints are not read")
    vcfg = vit or ViTConfig(img_size=img_size)
    dtype = policy(bf16).compute_dtype
    model = ViTClassifier(vcfg, num_classes, dtype=dtype,
                          generator=torch.Generator().manual_seed(seed))
    if checkpoint:
        load_classifier_state(model, load_reference_pth(checkpoint))
    model = model.to(device).eval()

    def apply_fn(x):
        # fp32 on device before the host copy: bf16 logits would leave the
        # served probabilities with only ~2-3 significant digits
        return model(x).float()

    engine = InferenceEngine(apply_fn, buckets=buckets,
                             postprocess=sigmoid_np if multilabel else softmax_np,
                             input_dtype=dtype, device=device)
    engine.model = model
    return engine
