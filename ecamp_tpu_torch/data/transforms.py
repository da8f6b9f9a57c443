"""Host-side eval transform (PIL + numpy), NHWC float32 output.

The serving path's preprocessing, ported from `ecamp_tpu/data/transforms.py`
(`EvalTransform`, `center_crop_resize`, `to_grayscale3`, `normalize`) so
that the port imports nothing of the JAX package. Matches the reference's
cls eval stack: Resize(img/ratio) + CenterCrop + Grayscale(3) + Normalize
(Classification/utils/data_utils.py:29-34). Grayscale is the ITU-R 601-2
luma transform (PIL 'L') replicated to 3 channels.
"""

from __future__ import annotations

import numpy as np
from PIL import Image


def center_crop_resize(img: Image.Image, size: int,
                       resize_to: int) -> Image.Image:
    """Resize smaller edge to resize_to then center-crop size x size."""
    w, h = img.size
    if w < h:
        nw, nh = resize_to, int(round(h * resize_to / w))
    else:
        nh, nw = resize_to, int(round(w * resize_to / h))
    img = img.resize((nw, nh), Image.BILINEAR)
    left = (nw - size) // 2
    top = (nh - size) // 2
    return img.crop((left, top, left + size, top + size))


def to_grayscale3(img: Image.Image) -> Image.Image:
    return img.convert("L").convert("RGB")


def normalize(arr: np.ndarray, mean: float, std: float) -> np.ndarray:
    """uint8 HWC -> float32 normalized."""
    x = arr.astype(np.float32) / 255.0
    return (x - mean) / std


class EvalTransform:
    """Resize(size / 0.875, bilinear) + CenterCrop + Grayscale(3) +
    Normalize, the JAX package's defaults."""

    def __init__(self, size: int, mean: float, std: float):
        self.size = size
        self.resize_to = int(size / 0.875)
        self.mean = mean
        self.std = std

    def __call__(self, img: Image.Image) -> np.ndarray:
        img = center_crop_resize(img, self.size, self.resize_to)
        return normalize(np.asarray(to_grayscale3(img)), self.mean, self.std)
