"""Segmentation models: SIIM/RSNA single decoder, RIGA dual decoder
(counterpart of `ecamp_tpu/nn/seg.py`; reference Segmentation/
models_vit.py:27-145 and models_vit_RIGA.py:109-151).

The ViT tokens pass a `seg_head` Linear and are reshaped to a (B, 14, 14,
768) map, then a 4-stage conv + BatchNorm + ReLU + bilinear
(align_corners) x2 decoder gives full-resolution logits. Inputs and outputs
are NHWC, as in the JAX package; the decoder runs on NCHW tensors that are
channels_last in memory (a permute of the NHWC map, no copy), which is what
cuDNN's NHWC convolutions take.

The module tree gives `state_dict()` the reference namespace: the trunk at
`encoder.*` (`encoder.blocks.{i}.*`, `encoder.pos_embed`, ...),
`encoder.seg_head.*`, `decoder.decoder_{i}.0.*` (conv),
`decoder.decoder_{i}.1.*` (BatchNorm) and `decoder.final_out.*`; RIGA's
decoders are `decoder_disc` and `decoder_cup`.

`forward(x, train, stop_trunk_grad)`: `train` selects the BatchNorm batch
statistics (and updates the running ones). Dropout in the trunk follows
the module's `training` flag; the segmentation task keeps the model in
eval mode, as the JAX step runs the trunk deterministic.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..core.config import ViTConfig
from ..ops.image_ops import upsample_align_corners
from .layers import BatchNorm, Conv2d, Dense, reset_conv_bn
from .vit import VisionTransformer


class SegEncoder(VisionTransformer):
    """ViT trunk + seg_head token-to-map projection
    (Segmentation/models_vit.py:30-63)."""

    def __init__(self, cfg: ViTConfig, sample_rate: int = 4,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg, dtype, generator)
        sample_v = 2 ** sample_rate
        self.sub = cfg.patch_size // sample_v  # p1 == p2
        out_dim = cfg.patch_size ** 2 * cfg.embed_dim // (sample_v ** 2)
        self.seg_head = Dense(cfg.embed_dim, out_dim, dtype=dtype)
        self.seg_head.reset_parameters(generator)

    def forward(self, x, stop_trunk_grad: bool = False):
        """x: (B, H, W, C) -> (B, H/p * sub, W/p * sub, D) in the compute
        dtype. `stop_trunk_grad` (the frozen encoder, train.py:128-133) runs
        the trunk without an autograd graph: its backward is never run."""
        c = self.cfg
        b, h_img = x.shape[0], x.shape[1]
        if stop_trunk_grad:
            with torch.no_grad():
                tokens = super().forward(x)
        else:
            tokens = super().forward(x)
        tokens = self.seg_head(tokens[:, 1:, :])
        grid, sub = h_img // c.patch_size, self.sub
        # einops: b (h w) (p1 p2 c) -> b (h p1) (w p2) c
        t = tokens.reshape(b, grid, grid, sub, sub, c.embed_dim)
        return t.permute(0, 1, 3, 2, 4, 5).reshape(b, grid * sub, grid * sub,
                                                   c.embed_dim)


class ConvDecoder(nn.Module):
    """4x (conv3x3 + BN + ReLU + bilinear-up x2) + final conv
    (Segmentation/models_vit.py:70-106). `final_out` runs in fp32 on the
    fp32-cast features; every other conv in the compute dtype."""

    def __init__(self, in_channels: int, out_channels: int = 1,
                 features: Sequence[int] = (512, 256, 128, 64),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        widths = [in_channels] + list(features)
        for i, f in enumerate(features):
            self.add_module(f"decoder_{i + 1}", nn.Sequential(
                Conv2d(widths[i], f, 3, dtype),
                BatchNorm(f, momentum=0.9, eps=1e-5, dtype=dtype)))
        self.n_stages = len(features)
        self.final_out = Conv2d(widths[-1], out_channels, 3, torch.float32)

    def reset_parameters(self, generator=None) -> None:
        reset_conv_bn(self, generator)

    def forward(self, x, train: bool = False):
        """x: (B, h, w, C) NHWC -> fp32 logits (B, h * 2^n, w * 2^n, out)."""
        x = x.permute(0, 3, 1, 2)  # NCHW view, channels_last in memory
        for i in range(self.n_stages):
            conv, bn = getattr(self, f"decoder_{i + 1}")
            x = torch.relu(bn(conv(x), train))
            x = upsample_align_corners(x, 2)
        return self.final_out(x.float()).permute(0, 2, 3, 1)


class SegViT(nn.Module):
    """Single-decoder segmentation model (SIIM / RSNA)."""

    DECODERS: Tuple[str, ...] = ("decoder",)

    def __init__(self, cfg: ViTConfig, out_channels: int = 1,
                 sample_rate: int = 4,
                 features: Sequence[int] = (512, 256, 128, 64),
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.encoder = SegEncoder(cfg, sample_rate, dtype, generator)
        for name in self.DECODERS:
            dec = ConvDecoder(cfg.embed_dim, out_channels, features, dtype)
            dec.reset_parameters(generator)
            self.add_module(name, dec)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Initialise every parameter from `generator` (JAX init rules) and
        the BatchNorm statistics to their start."""
        self.encoder.reset_parameters(generator)
        for name in self.DECODERS:
            getattr(self, name).reset_parameters(generator)

    def forward(self, x, train: bool = False, stop_trunk_grad: bool = False):
        """x: (B, H, W, C) -> fp32 logits (B, H, W, out_channels)."""
        return self.decoder(self.encoder(x, stop_trunk_grad), train)


class SegViTDual(SegViT):
    """Dual-decoder RIGA model: disc + cup (models_vit_RIGA.py:135-151)."""

    DECODERS = ("decoder_disc", "decoder_cup")

    def forward(self, x, train: bool = False, stop_trunk_grad: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        feat = self.encoder(x, stop_trunk_grad)
        return (self.decoder_disc(feat, train),
                self.decoder_cup(feat, train))
