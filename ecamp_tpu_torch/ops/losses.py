"""Pretraining, classification and segmentation losses (counterpart of
`ecamp_tpu/ops/losses.py`), with the reference's reductions, documented
quirks included, and fp32 sums."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..core import distributed


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


def sigmoid_bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean BCE-with-logits over every element, in fp32 (classification
    multilabel path, Classification/train.py:442-447)."""
    x = logits.float()
    t = targets.float()
    per = torch.clamp(x, min=0) - x * t + torch.log1p(torch.exp(-x.abs()))
    return per.mean()


def focal_loss(logits: torch.Tensor, targets: torch.Tensor,
               gamma: float = 2.0) -> torch.Tensor:
    """Focal loss as the reference writes it
    (Segmentation/utils/segmentation_loss.py:55-76): stable BCE-with-logits
    weighted by exp(gamma * logsigmoid(-x*(2t-1))), mean-reduced, fp32."""
    x = logits.float()
    t = targets.float()
    max_val = torch.clamp(-x, min=0.0)
    bce = x - x * t + max_val + torch.log(torch.exp(-max_val)
                                          + torch.exp(-x - max_val))
    invprobs = F.logsigmoid(-x * (t * 2.0 - 1.0))
    return (torch.exp(invprobs * gamma) * bce).mean()


def dice_coefficient(logits: torch.Tensor, targets: torch.Tensor,
                     smooth: float = 1.0) -> torch.Tensor:
    """Soft dice over the whole batch (segmentation_loss.py:7-24): the
    reference flattens across the batch, not per sample.

    In a data-parallel process group the whole batch is the global one, as
    in JAX under GSPMD: the three sums go through the differentiable
    all-reduce before the ratio, so every rank computes the global dice.
    The other losses here (focal, BCE, CE) and the YOLO loss are means
    over shards of equal size, so averaging the ranks' gradients already
    gives the global batch's; a ratio of sums is not such a mean."""
    p = torch.sigmoid(logits.float()).reshape(-1)
    t = targets.float().reshape(-1)
    inter, p_sum, t_sum = (p * t).sum(), p.sum(), t.sum()
    if distributed.is_distributed():
        inter, p_sum, t_sum = distributed.all_reduce_sum(
            torch.stack([inter, p_sum, t_sum])).unbind()
    return (2.0 * inter + smooth) / (p_sum + t_sum + smooth)


def mixed_loss(logits: torch.Tensor, targets: torch.Tensor,
               alpha: float = 10.0, gamma: float = 2.0) -> torch.Tensor:
    """MixedLoss = alpha*focal - log(dice) (segmentation_loss.py:79-90)."""
    return alpha * focal_loss(logits, targets, gamma) - torch.log(
        dice_coefficient(logits, targets))
