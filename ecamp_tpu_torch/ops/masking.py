"""MAE masking (counterpart of `ecamp_tpu/ops/masking.py`).

`random_masking` is the reference's argsort-of-noise scheme
(model_ecamp.py:168-193) and takes its uniform noise as an argument, so
the JAX package's draw can be handed to it. Token permutes are gathers:
the JAX default's one-hot matmul is a TPU layout choice with the same
result.
"""

from __future__ import annotations

from typing import Tuple

import torch


def permute_tokens(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """x[b, ids[b, k], :]: (N, L, D), (N, K) -> (N, K, D)."""
    return torch.gather(x, 1, ids[:, :, None].expand(-1, -1, x.shape[-1]))


def random_masking(x: torch.Tensor, mask_ratio: float, noise: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """Per-sample token masking by argsorted noise.

    x: (N, L, D); noise: (N, L) uniform. Returns (x_kept (N, len_keep, D),
    mask (N, L) in x's dtype with 1 = removed, ids_restore (N, L),
    ids_keep (N, len_keep))."""
    n, L, _ = x.shape
    if tuple(noise.shape) != (n, L):
        raise ValueError(f"noise {tuple(noise.shape)} must be ({n}, {L})")
    len_keep = int(L * (1 - mask_ratio))
    ids_shuffle = torch.argsort(noise, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    ids_keep = ids_shuffle[:, :len_keep]
    mask = torch.ones((n, L), dtype=x.dtype, device=x.device)
    mask[:, :len_keep] = 0.0
    mask = torch.gather(mask, 1, ids_restore)
    return permute_tokens(x, ids_keep), mask, ids_restore, ids_keep


def mask_to_pixel(mask: torch.Tensor, column: torch.Tensor, row: torch.Tensor,
                  patch_size: int = 16, sr_scale: int = 2, window: int = 12
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A (N, L) patch mask in pixel space, and the SR loss window.

    Returns NHWC masks in mask's dtype: pixel_mask (N, g*p, g*p, 1)
    marking removed patches, super_mask (N, g*p*s, g*p*s, 1) marking the
    window x window block of patches at (column, row), column on the
    vertical axis (super_mask[i, column:column+12, row:row+12] = 1,
    model_ecamp.py:208)."""
    n, L = mask.shape
    g = int(round(L ** 0.5))
    p, sp = patch_size, patch_size * sr_scale
    pixel = mask.reshape(n, g, g).repeat_interleave(p, 1).repeat_interleave(
        p, 2)
    idx = torch.arange(g, device=mask.device)[None, :]
    col = column.reshape(n, 1).to(mask.device)
    row_ = row.reshape(n, 1).to(mask.device)
    in_rows = (idx >= col) & (idx < col + window)
    in_cols = (idx >= row_) & (idx < row_ + window)
    super2d = (in_rows[:, :, None] & in_cols[:, None, :]).to(mask.dtype)
    sup = super2d.repeat_interleave(sp, 1).repeat_interleave(sp, 2)
    return pixel[..., None], sup[..., None]


def patchify(imgs: torch.Tensor, patch_size: int) -> torch.Tensor:
    """(N, H, W, C) -> (N, L, p*p*C), channel-last within a patch
    (the reference's nchpwq->nhwpqc einsum, model_ecamp.py:138-150)."""
    n, h, w, c = imgs.shape
    p = patch_size
    x = imgs.reshape(n, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, (h // p) * (w // p), p * p * c)


def unpatchify(x: torch.Tensor, patch_size: int,
               channels: int = 3) -> torch.Tensor:
    """(N, L, p*p*C) -> (N, H, W, C) (model_ecamp.py:153-165)."""
    n, L, _ = x.shape
    p = patch_size
    g = int(round(L ** 0.5))
    x = x.reshape(n, g, g, p, p, channels).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, g * p, g * p, channels)
