"""Detection model: ViT backbone + multi-scale Bottleneck neck + YOLOv3
head (counterpart of `ecamp_tpu/nn/det.py`; reference Detection/
detector_backbone_vit.py and detector_model.py, classes=1).

The ViT tokens pass a `det_head` Linear and are reshaped to a (B, 14, 14,
768) map; the neck makes 28^2 x 512, 14^2 x 1024 and 7^2 x 2048 maps from
it (1x1 convs, an align-corners x2 upsample, a 1x1 stride-2 conv, one
Bottleneck each), and the YOLOv3 head turns them top-down into three
(B, 3 * (5 + C), G, G) maps. Inputs are NHWC, as in the JAX package; the
neck and head run on NCHW tensors that are channels_last in memory (a
permute of the NHWC map, no copy), which is what cuDNN's NHWC
convolutions take.

The module tree gives `state_dict()` the reference namespace, the one
`ecamp_tpu/ckpt/torch_export.py::export_detector` writes and
`import_detector(from_pretrain=False)` reads: the trunk at
`backbone.encoder.*` (`backbone.encoder.blocks.{i}.*`, ...),
`backbone.encoder.det_head.*`, `backbone.layers.{traspose, transpose1,
downsample, layer1, layer2, layer3}.*` (`traspose` spelled as in the
reference), and the head's `embedding{0,1,2}.{0..5}.{conv,bn}.*`,
`embedding{0,1,2}.conv_out.*` and `embedding{1,2}_cbl.{conv,bn}.*` at the
top level.

`backbone="resnet50"` is the reference's ResNetDetector baseline
(Detection/detector_backbone_resnet.py): `nn/resnet.py::ResNet50Backbone`
as `backbone` (`backbone.conv1`, `backbone.layer1.0.*`, ...), its
layer2 / layer3 / layer4 maps straight into the same head, no neck.

`forward(x, train, stop_trunk_grad)`: `train` selects the BatchNorm batch
statistics (and updates the running ones). Dropout in the trunk follows
the module's `training` flag; the detection task keeps the model in eval
mode, as the JAX step runs the trunk deterministic.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import ViTConfig
from ..ops.image_ops import upsample_align_corners, upsample_nearest
from .layers import BatchNorm, Conv2d, Dense, reset_conv_bn
from .resnet import ResNet50Backbone
from .vit import VisionTransformer

# COCO anchors * 224/416 (detector_model.py:14-18); scale order matches the
# head outputs (out0 = 7x7 coarse, out1 = 14x14, out2 = 28x28)
YOLO_ANCHORS = tuple(
    tuple((aw * 224 / 416, ah * 224 / 416) for aw, ah in scale)
    for scale in (
        ((116, 90), (156, 198), (373, 326)),
        ((30, 61), (62, 45), (59, 119)),
        ((10, 13), (16, 30), (33, 23)),
    )
)


def _bn(channels: int, dtype: torch.dtype) -> BatchNorm:
    return BatchNorm(channels, momentum=0.9, eps=1e-5, dtype=dtype)


class Bottleneck(nn.Module):
    """ResNet-V1.5 bottleneck with parametric expansion
    (detector_backbone_vit.py:41-99). Its input has planes * expansion
    channels, so it has no downsample branch."""

    def __init__(self, planes: int, expansion: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        width, out = planes, planes * expansion
        self.conv1 = Conv2d(out, width, 1, dtype, bias=False)
        self.bn1 = _bn(width, dtype)
        self.conv2 = Conv2d(width, width, 3, dtype, bias=False)
        self.bn2 = _bn(width, dtype)
        self.conv3 = Conv2d(width, out, 1, dtype, bias=False)
        self.bn3 = _bn(out, dtype)

    def forward(self, x, train: bool = False):
        out = torch.relu(self.bn1(self.conv1(x), train))
        out = torch.relu(self.bn2(self.conv2(out), train))
        return torch.relu(self.bn3(self.conv3(out), train) + x)


class DetEncoder(VisionTransformer):
    """ViT trunk + det_head projection to a (B, 14, 14, 768) map
    (detector_backbone_vit.py:102-138)."""

    def __init__(self, cfg: ViTConfig, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg, dtype, generator)
        self.det_head = Dense(cfg.embed_dim, cfg.embed_dim, dtype=dtype)
        self.det_head.reset_parameters(generator)

    def forward(self, x, stop_trunk_grad: bool = False):
        """x: (B, H, W, C) -> (B, H/p, W/p, D) NHWC in the compute dtype.
        `stop_trunk_grad` (the frozen encoder, Detection/train.py:169-174)
        runs the trunk without an autograd graph: its backward is never
        run; `det_head` still trains."""
        c = self.cfg
        b, h_img = x.shape[0], x.shape[1]
        if stop_trunk_grad:
            with torch.no_grad():
                tokens = super().forward(x)
        else:
            tokens = super().forward(x)
        tokens = self.det_head(tokens[:, 1:, :])
        grid = h_img // c.patch_size
        return tokens.reshape(b, grid, grid, c.embed_dim)


class DetectionLayers(nn.Module):
    """Multi-scale neck (detector_backbone_vit.py:141-188): an NCHW map of
    `in_channels` -> (x2 28^2 x 512, x1 14^2 x 1024, x0 7^2 x 2048)."""

    def __init__(self, in_channels: int,
                 channels: Sequence[int] = (512, 1024, 2048),
                 expansion: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        c0, c1, c2 = channels
        self.traspose = Conv2d(in_channels, c1, 1, dtype)
        self.layer1 = Bottleneck(c1 // expansion, expansion, dtype)
        self.transpose1 = Conv2d(in_channels, c0, 1, dtype)
        self.layer2 = Bottleneck(c0 // expansion, expansion, dtype)
        self.downsample = Conv2d(in_channels, c2, 1, dtype, bias=False,
                                 stride=2)
        self.layer3 = Bottleneck(c2 // expansion, expansion, dtype)

    def forward(self, x, train: bool = False):
        out1 = self.layer1(self.traspose(x), train)
        out2 = upsample_align_corners(self.transpose1(x), 2)
        out2 = self.layer2(out2, train)
        out3 = self.layer3(self.downsample(x), train)
        return out2, out1, out3


class ViTDetector(nn.Module):
    """Backbone wrapper (detector_backbone_vit.py:191-221): the encoder and
    the neck, as `backbone.encoder` and `backbone.layers`."""

    def __init__(self, cfg: ViTConfig, expansion: int = 4,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.encoder = DetEncoder(cfg, dtype, generator)
        self.layers = DetectionLayers(cfg.embed_dim, expansion=expansion,
                                      dtype=dtype)
        reset_conv_bn(self.layers, generator)

    def forward(self, x, train: bool = False, stop_trunk_grad: bool = False):
        feat = self.encoder(x, stop_trunk_grad)
        return self.layers(feat.permute(0, 3, 1, 2), train)


class _CBL(nn.Module):
    """conv (no bias) + BatchNorm + LeakyReLU(0.1) (detector_model.py:42-51)."""

    def __init__(self, in_channels: int, filters: int, kernel: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(in_channels, filters, kernel, dtype, bias=False)
        self.bn = _bn(filters, dtype)

    def forward(self, x, train: bool = False):
        return F.leaky_relu(self.bn(self.conv(x), train), 0.1)


class _Embedding(nn.Module):
    """A 6-CBL tower (children `0`..`5`) + the 1x1 `conv_out`; the branch is
    the 5th CBL's output (detector_model.py:53-71). `conv_out` runs in
    fp32 on the fp32-cast features."""

    def __init__(self, in_channels: int, filters: Tuple[int, int],
                 out_filters: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        f0, f1 = filters
        width = in_channels
        for i, (f, k) in enumerate([(f0, 1), (f1, 3)] * 3):
            self.add_module(str(i), _CBL(width, f, k, dtype))
            width = f
        self.conv_out = Conv2d(f1, out_filters, 1, torch.float32)

    def forward(self, x, train: bool = False):
        branch = None
        for i in range(6):
            x = getattr(self, str(i))(x, train)
            if i == 4:
                branch = x
        return self.conv_out(x.float()), branch


class DetectionModel(nn.Module):
    """The full detector: the ViT backbone and neck (`backbone`) and the
    YOLOv3 top-down head (detector_model.py:9-95, ModelMain). Outputs
    NCHW fp32 maps ((B, 18, 7, 7), (B, 18, 14, 14), (B, 18, 28, 28)) at
    1 class, the layout the YOLO loss and decode read.

    `backbone="resnet50"` (the reference's ResNetDetector baseline) puts a
    ResNet-50 in place of the ViT and its neck; `expansion` then plays no
    part."""

    def __init__(self, cfg: ViTConfig, num_classes: int = 1,
                 expansion: int = 4, backbone: str = "vit",
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if backbone not in ("vit", "resnet50"):
            raise ValueError(f"unknown detector backbone {backbone!r}")
        self.cfg = cfg
        self.num_classes = num_classes
        self.resnet = backbone == "resnet50"
        n_out = 3 * (5 + num_classes)
        self.backbone = (ResNet50Backbone(dtype, generator=generator)
                         if self.resnet
                         else ViTDetector(cfg, expansion, dtype, generator))
        self.embedding0 = _Embedding(2048, (512, 1024), n_out, dtype)
        self.embedding1_cbl = _CBL(512, 256, 1, dtype)
        self.embedding1 = _Embedding(256 + 1024, (256, 512), n_out, dtype)
        self.embedding2_cbl = _CBL(256, 128, 1, dtype)
        self.embedding2 = _Embedding(128 + 512, (128, 256), n_out, dtype)
        self._reset_head(generator)

    HEAD = ("embedding0", "embedding1_cbl", "embedding1", "embedding2_cbl",
            "embedding2")

    def _reset_head(self, generator) -> None:
        for name in self.HEAD:
            reset_conv_bn(getattr(self, name), generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Initialise every parameter from `generator` (JAX init rules) and
        the BatchNorm statistics to their start."""
        if self.resnet:
            self.backbone.reset_parameters(generator)
        else:
            self.backbone.encoder.reset_parameters(generator)
            reset_conv_bn(self.backbone.layers, generator)
        self._reset_head(generator)

    def forward(self, x, train: bool = False, stop_trunk_grad: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x: (B, H, W, C) -> three fp32 NCHW maps, coarse to fine. With
        the ResNet-50, `stop_trunk_grad` (its whole backbone frozen,
        Detection/train.py:126-127) runs it without an autograd graph, the
        gradient cut at the three taps as in JAX; in train mode its
        BatchNorm statistics still update."""
        if not self.resnet:
            x2, x1, x0 = self.backbone(x, train, stop_trunk_grad)
        else:
            with torch.set_grad_enabled(torch.is_grad_enabled()
                                        and not stop_trunk_grad):
                x2, x1, x0 = self.backbone(x, train)
        out0, b0 = self.embedding0(x0, train)
        y = upsample_nearest(self.embedding1_cbl(b0, train), 2)
        out1, b1 = self.embedding1(torch.cat([y, x1], dim=1), train)
        z = upsample_nearest(self.embedding2_cbl(b1, train), 2)
        out2, _ = self.embedding2(torch.cat([z, x2], dim=1), train)
        return out0, out1, out2
