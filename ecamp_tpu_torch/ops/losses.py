"""Pretraining losses (counterpart of `ecamp_tpu/ops/losses.py`), with the
reference's reductions, documented quirks included, and fp32 sums."""

from __future__ import annotations

from typing import Tuple

import torch


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Per-position CE for integer labels: (..., V) -> (...) fp32. The max
    and exp run in the logits' dtype (bf16 in training: the 30000-way
    logits are the largest tensor of the step); the sum and the rest in
    fp32, as in the JAX package."""
    m = logits.amax(dim=-1, keepdim=True)
    s = torch.exp(logits - m).sum(dim=-1, dtype=torch.float32)
    logz = m[..., 0].float() + torch.log(s)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0].float()
    return logz - gold


def weighted_mlm_loss(logits: torch.Tensor, labels: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """Entity-weighted MLM loss (bert_modeling.py:211-217): CE at every
    position (pads included, no -100), times `weights`, mean over B*L."""
    return (softmax_cross_entropy(logits, labels) * weights.float()).mean()


def masked_pixel_losses(pred_img: torch.Tensor, imgs: torch.Tensor,
                        super_pred: torch.Tensor, big_imgs: torch.Tensor,
                        pixel_mask: torch.Tensor, super_mask: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MIM and SR losses (model_ecamp.py:276-300): the mean over the FULL
    tensor of (pred*mask - target*mask)^2, so the scale follows the mask
    ratio and the SR window, as in the reference. Squares in the input
    dtype, mean in fp32."""
    pm = pixel_mask.to(pred_img.dtype)
    sm = super_mask.to(super_pred.dtype)
    mim = torch.square(pred_img * pm - imgs.to(pred_img.dtype) * pm).mean(
        dtype=torch.float32)
    res = torch.square(super_pred * sm - big_imgs.to(super_pred.dtype) * sm
                       ).mean(dtype=torch.float32)
    return mim, res
