"""Position-embedding resize (counterpart of `ecamp_tpu/nn/pos_embed.py`).

Used when a checkpoint's patch grid differs from the served `img_size`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def interpolate_pos_embed(pos_embed: torch.Tensor, new_grid: int,
                          num_extra_tokens: int = 1) -> torch.Tensor:
    """Bicubic resize of the patch-token part of a (1, N+extra, D) or
    (N+extra, D) pos embed to a new grid (reference util/pos_embed.py:75-96:
    F.interpolate bicubic, a=-0.75, align_corners=False, in fp32)."""
    squeeze = pos_embed.ndim == 2
    if squeeze:
        pos_embed = pos_embed[None]
    d = pos_embed.shape[-1]
    extra = pos_embed[:, :num_extra_tokens]
    patch = pos_embed[:, num_extra_tokens:]
    orig = int(round(patch.shape[1] ** 0.5))
    if orig != new_grid:
        grid = patch.reshape(1, orig, orig, d).permute(0, 3, 1, 2).float()
        grid = F.interpolate(grid, size=(new_grid, new_grid), mode="bicubic",
                             align_corners=False)
        patch = grid.permute(0, 2, 3, 1).reshape(1, new_grid * new_grid, d)
        pos_embed = torch.cat([extra.float(), patch], dim=1)
    return pos_embed[0] if squeeze else pos_embed
