"""Position embeddings (counterpart of `ecamp_tpu/nn/pos_embed.py`).

`get_2d_sincos_pos_embed` builds the fixed table of the MAE encoder and
decoder; the model holds it as a buffer, not a parameter, as the JAX
package holds it as a trace-time constant. `interpolate_pos_embed` resizes
a checkpoint's learned table when its patch grid differs from the served
`img_size`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _1d_sincos(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega = 1.0 / 10000 ** (omega / embed_dim / 2.0)
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int,
                            cls_token: bool = False) -> np.ndarray:
    """(grid_size**2 [+1], embed_dim) float32, the reference generator
    (util/pos_embed.py:20-67) with its frequency scale arange(d/2)/d/2 and
    its xy meshgrid (w first); a zero row for the cls token."""
    if embed_dim % 4:
        raise ValueError(f"embed_dim {embed_dim} must be a multiple of 4")
    grid = np.arange(grid_size, dtype=np.float64)
    grid = np.stack(np.meshgrid(grid, grid), axis=0)
    pos = np.concatenate([_1d_sincos(embed_dim // 2, grid[0]),
                          _1d_sincos(embed_dim // 2, grid[1])], axis=1)
    if cls_token:
        pos = np.concatenate([np.zeros([1, embed_dim]), pos], axis=0)
    return pos.astype(np.float32)


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
