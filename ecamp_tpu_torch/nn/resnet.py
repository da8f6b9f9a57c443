"""ResNet-50 backbone with the layer2 / layer3 / layer4 taps (counterpart
of `ecamp_tpu/nn/resnet.py`; the reference's baseline paths
Detection/detector_backbone_resnet.py:16-53 and Segmentation/train.py:
139-180, torchvision resnet50).

torchvision V1.5 semantics: the stride sits on each bottleneck's 3x3, the
7x7 / 2 stem pads 3, the 3x3 / 2 max pool pads 1 (with -inf, as flax's
`nn.max_pool` and `F.max_pool2d` both do). The BatchNorms are flax's
(`nn/layers.py::BatchNorm` at its defaults, eps 1e-5, momentum 0.9). At 224 px the taps
are 28^2 x 512, 14^2 x 1024 and 7^2 x 2048.

The module tree gives `state_dict()` the torchvision names that the JAX
package's generic key map produces (`ecamp_tpu/ckpt/torch_import.py:
117-121`): `conv1`, `bn1`, `layer{1..4}.{i}.conv{1,2,3}` / `bn{1,2,3}`,
`layer{1..4}.0.downsample.0` (the conv) and `.1` (its BatchNorm). Inputs
are NHWC, as the port's other models take them; the network runs on the
NCHW view of that tensor, channels_last in memory.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, Conv2d, reset_conv_bn

PLANES = (64, 128, 256, 512)


class Bottleneck(nn.Module):
    """torchvision's Bottleneck (expansion 4). The first block of a stage
    has a `downsample` branch: a strided 1x1 conv and its BatchNorm."""

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 has_downsample: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        out = planes * 4
        self.conv1 = Conv2d(in_channels, planes, 1, dtype, bias=False)
        self.bn1 = BatchNorm(planes, dtype=dtype)
        self.conv2 = Conv2d(planes, planes, 3, dtype, bias=False,
                            stride=stride, padding=1)
        self.bn2 = BatchNorm(planes, dtype=dtype)
        self.conv3 = Conv2d(planes, out, 1, dtype, bias=False)
        self.bn3 = BatchNorm(out, dtype=dtype)
        self.downsample = nn.ModuleList([
            Conv2d(in_channels, out, 1, dtype, bias=False, stride=stride),
            BatchNorm(out, dtype=dtype)]) if has_downsample else None

    def forward(self, x, train: bool = False):
        out = torch.relu(self.bn1(self.conv1(x), train))
        out = torch.relu(self.bn2(self.conv2(out), train))
        out = self.bn3(self.conv3(out), train)
        identity = x
        if self.downsample is not None:
            conv, bn = self.downsample
            identity = bn(conv(x), train)
        return torch.relu(out + identity)


class ResNet50Backbone(nn.Module):
    """The stem and four stages of `layers` bottlenecks each ((3, 4, 6, 3)
    is ResNet-50). `forward` returns the layer2, layer3 and layer4 maps,
    NCHW in the compute dtype: the YOLO head's inputs in place of the ViT
    detector's neck."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 layers: Sequence[int] = (3, 4, 6, 3),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 7, dtype, bias=False, stride=2, padding=3)
        self.bn1 = BatchNorm(64, dtype=dtype)
        width = 64
        for li, (n_blocks, p) in enumerate(zip(layers, PLANES)):
            stride = 1 if li == 0 else 2
            blocks = []
            for bi in range(n_blocks):
                blocks.append(Bottleneck(width, p, stride if bi == 0 else 1,
                                         bi == 0, dtype))
                width = p * 4
            self.add_module(f"layer{li + 1}", nn.ModuleList(blocks))
        reset_conv_bn(self, generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Initialise every conv from `generator` (flax's lecun-normal, a
        bias 0) and every BatchNorm to its start."""
        reset_conv_bn(self, generator)

    def encode(self, x, train: bool = False
               ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """x: (B, H, W, C) -> (the stem's relu output at H/2, [layer1 ..
        layer4 outputs at H/4 .. H/32]), NCHW."""
        x = self.conv1(x.permute(0, 3, 1, 2))
        s1 = torch.relu(self.bn1(x, train))
        h = F.max_pool2d(s1, 3, 2, 1)
        taps = []
        for li in range(4):
            for block in getattr(self, f"layer{li + 1}"):
                h = block(h, train)
            taps.append(h)
        return s1, taps

    def forward(self, x, train: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x: (B, H, W, C) -> (layer2, layer3, layer4) NCHW maps."""
        _, taps = self.encode(x, train)
        return taps[1], taps[2], taps[3]
