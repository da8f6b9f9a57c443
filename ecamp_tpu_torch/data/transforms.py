"""Host-side image transforms (PIL + numpy), NHWC output, ported from
`ecamp_tpu/data/transforms.py` so that the port imports nothing of the JAX
package:

  pretrain (`TrainTransform`): RandomResizedCrop(448, scale=(0.2, 1))
      bicubic + HFlip + Grayscale(3) + Normalize(0.4721, 0.3037)
      (pretrain_datasets.py:47-52)
  cls train (`TrainTransform`): RandomResizedCrop(224) bilinear + HFlip +
      Grayscale(3) + Normalize(0.4722, 0.3028) on a decoded image
  cls eval (`EvalTransform`): Resize(img/ratio) + CenterCrop + Grayscale(3)
      + Normalize (Classification/utils/data_utils.py:29-34)

RandomResizedCrop reproduces torchvision's sampling (10 area/log-ratio
draws, then the clamped centre). Grayscale is the ITU-R 601-2 luma
transform (PIL 'L') replicated to 3 channels. `TrainTransform` is the JAX
package's PIL path; its C++ fused resize (`ecamp_tpu/data/native.py`) is
not ported (ROADMAP Queue 1).
"""

from __future__ import annotations

import math
import random
from typing import Tuple

import numpy as np
from PIL import Image

_INTERP = {"bicubic": Image.BICUBIC, "bilinear": Image.BILINEAR,
           "nearest": Image.NEAREST}


def sample_crop_box(width: int, height: int, rng: random.Random,
                    scale: Tuple[float, float] = (0.08, 1.0),
                    ratio: Tuple[float, float] = (3 / 4, 4 / 3)
                    ) -> Tuple[int, int, int, int]:
    """torchvision RandomResizedCrop box sampling (10 area/log-ratio draws
    then the clamped centre). Returns (x0, y0, x1, y1)."""
    area = width * height
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(scale[0], scale[1])
        aspect = math.exp(rng.uniform(log_ratio[0], log_ratio[1]))
        w = int(round(math.sqrt(target_area * aspect)))
        h = int(round(math.sqrt(target_area / aspect)))
        if 0 < w <= width and 0 < h <= height:
            i = rng.randint(0, height - h)
            j = rng.randint(0, width - w)
            return (j, i, j + w, i + h)
    in_ratio = width / height
    if in_ratio < ratio[0]:
        w, h = width, int(round(width / ratio[0]))
    elif in_ratio > ratio[1]:
        h, w = height, int(round(height * ratio[1]))
    else:
        w, h = width, height
    i = (height - h) // 2
    j = (width - w) // 2
    return (j, i, j + w, i + h)


def center_crop_resize(img: Image.Image, size: int, resize_to: int,
                       interpolation: str = "bilinear") -> Image.Image:
    """Resize smaller edge to resize_to then center-crop size x size."""
    w, h = img.size
    if w < h:
        nw, nh = resize_to, int(round(h * resize_to / w))
    else:
        nh, nw = resize_to, int(round(w * resize_to / h))
    img = img.resize((nw, nh), _INTERP[interpolation])
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
    """Resize(size / crop_ratio) + CenterCrop + Grayscale(3) + Normalize.
    With `output_u8`, the quantized u8 gray (size, size, 1), normalized on
    the device (see `TrainTransform`)."""

    def __init__(self, size: int, mean: float, std: float,
                 crop_ratio: float = 0.875, interpolation: str = "bilinear",
                 output_u8: bool = False):
        self.size = size
        self.resize_to = int(size / crop_ratio)
        self.mean = mean
        self.std = std
        self.interpolation = interpolation
        self.output_u8 = output_u8

    def __call__(self, img: Image.Image) -> np.ndarray:
        img = center_crop_resize(img, self.size, self.resize_to,
                                 self.interpolation)
        if self.output_u8:
            return np.asarray(img.convert("L"))[..., None]
        return normalize(np.asarray(to_grayscale3(img)), self.mean, self.std)


class TrainTransform:
    """RandomResizedCrop + HFlip + Grayscale(3) + Normalize, from a
    `random.Random` stream (crop box, then flip). With `output_u8`, the
    quantized u8 gray (size, size, 1) instead of the normalized fp32
    (size, size, 3): 1/12 the bytes, normalized on the device
    (`train/pretrain.py::device_normalize`); the fp32 path normalizes
    exactly that u8 value."""

    def __init__(self, size: int, mean: float, std: float,
                 scale: Tuple[float, float] = (0.08, 1.0),
                 interpolation: str = "bilinear", seed: int = 0,
                 output_u8: bool = False):
        self.size = size
        self.mean = mean
        self.std = std
        self.scale = scale
        self.interpolation = interpolation
        self.seed = seed
        self.rng = random.Random(seed)
        self.output_u8 = output_u8

    def reseed(self, epoch: int, worker_id: int) -> None:
        """DataLoader worker protocol: rebind the crop/flip stream to one
        determined by (seed, epoch, worker)."""
        base = (self.seed * 1_000_003 + epoch) * 1_000_003 + worker_id
        self.rng = random.Random(base + 500_009)

    def load(self, path) -> np.ndarray:
        """Open, decode and transform one file. The crop box (drawn first,
        then the flip) comes from the header's size, so a JPEG decodes
        drafted (DCT-scaled by 1/2, 1/4 or 1/8) when the crop still has a
        source pixel per output pixel; a gray image decodes as one
        channel."""
        with open(path, "rb") as f:
            img = Image.open(f)
            w, h = img.size  # the header only
            box = sample_crop_box(w, h, self.rng, self.scale)
            flip = self.rng.random() < 0.5
            if img.format == "JPEG":
                bw, bh = box[2] - box[0], box[3] - box[1]
                shrink = max(1, min(bw, bh) // self.size)
                shrink = 1 << min(3, shrink.bit_length() - 1)
                if shrink > 1:
                    img.draft(img.mode, (w // shrink, h // shrink))
            if img.mode not in ("L", "RGB"):
                img = img.convert("RGB")
            img.load()
            sw, sh = img.size
        if (sw, sh) != (w, h):
            sx, sy = sw / w, sh / h
            box = (box[0] * sx, box[1] * sy, box[2] * sx, box[3] * sy)
        return self._emit(img, box, flip)

    def __call__(self, img: Image.Image) -> np.ndarray:
        """Transform a decoded image; the crop box is drawn, then the flip,
        as in `load`."""
        box = sample_crop_box(img.size[0], img.size[1], self.rng, self.scale)
        flip = self.rng.random() < 0.5
        return self._emit(img, box, flip)

    def _emit(self, img: Image.Image, box, flip: bool) -> np.ndarray:
        """Crop-resize to size x size, flip, then gray: u8 (size, size, 1)
        or normalized fp32 (size, size, 3)."""
        pil = img.resize((self.size, self.size), _INTERP[self.interpolation],
                         box=box)
        if flip:
            pil = pil.transpose(Image.FLIP_LEFT_RIGHT)
        if self.output_u8:
            return np.asarray(pil.convert("L"))[..., None]
        return normalize(np.asarray(to_grayscale3(pil)), self.mean, self.std)
