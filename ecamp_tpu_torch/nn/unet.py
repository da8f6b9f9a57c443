"""ResNet-50 UNet, the segmentation baseline (counterpart of
`ecamp_tpu/nn/unet.py`; the reference's smp.Unet path,
Segmentation/train.py:139-180). Trained end to end; it never loads the
ECAMP encoder.

The ResNet-50 encoder is inline at the top level (`conv1`, `bn1`,
`layer{1..4}.{i}.*`: torchvision's names, as `nn/resnet.py`), with the
skips layer3, layer2, layer1 and the stem's relu output, then no skip.
Each of the five decoder blocks (`decoder_{i}.conv1/bn1/conv2/bn2`) is a
nearest x2 upsample, the channel concat with its skip, and two
conv3x3-BatchNorm-relu. `seg_head`, a 3x3 conv with a bias, runs in fp32
on the fp32 cast of the decoder's output, as the JAX model computes it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.image_ops import upsample_nearest
from .layers import BatchNorm, Conv2d, reset_conv_bn
from .resnet import ResNet50Backbone

# the encoder's skips for decoder blocks 0..4: layer3, layer2, layer1, the
# stem's relu output, none
_SKIP_CHANNELS = (1024, 512, 256, 64, 0)


class DecoderBlock(nn.Module):
    """Upsample x2 (nearest), concat the skip, two conv-BN-relu."""

    def __init__(self, in_channels: int, channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = Conv2d(in_channels, channels, 3, dtype, bias=False,
                            padding=1)
        self.bn1 = BatchNorm(channels, dtype=dtype)
        self.conv2 = Conv2d(channels, channels, 3, dtype, bias=False,
                            padding=1)
        self.bn2 = BatchNorm(channels, dtype=dtype)

    def forward(self, x, skip=None, train: bool = False):
        x = upsample_nearest(x, 2)
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        x = torch.relu(self.bn1(self.conv1(x), train))
        return torch.relu(self.bn2(self.conv2(x), train))


class ResNetUNet(ResNet50Backbone):
    """UNet over ResNet-50 (3, 4, 6, 3): decoder widths `decoder_channels`
    (five blocks), `out_channels` fp32 logits at the input's size."""

    def __init__(self, out_channels: int = 1,
                 decoder_channels: Sequence[int] = (256, 128, 64, 32, 16),
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(dtype, (3, 4, 6, 3), generator)
        width = 2048
        self.decoders = []
        for i, (ch, skip) in enumerate(zip(decoder_channels, _SKIP_CHANNELS)):
            self.decoders.append(f"decoder_{i}")
            self.add_module(self.decoders[-1],
                            DecoderBlock(width + skip, ch, dtype))
            width = ch
        self.seg_head = Conv2d(width, out_channels, 3, torch.float32,
                               padding=1)
        for name in self.decoders + ["seg_head"]:
            reset_conv_bn(getattr(self, name), generator)

    def forward(self, x, train: bool = False):
        """x: (B, H, W, C) -> fp32 logits (B, H, W, out_channels)."""
        s1, (c1, c2, c3, c4) = self.encode(x, train)
        d = c4
        for name, skip in zip(self.decoders, (c3, c2, c1, s1, None)):
            d = getattr(self, name)(d, skip, train)
        return self.seg_head(d.float()).permute(0, 2, 3, 1)
