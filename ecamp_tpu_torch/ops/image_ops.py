"""On-device image ops, NHWC (counterpart of `ecamp_tpu/ops/image_ops.py`).

The reference resizes 448 -> 224 bicubic inside the model forward, on the
device (model_ecamp.py:318, torchvision Resize without antialias). As in
the JAX package, a resize is two dense products with the (dst, src)
matrices of torch's non-antialiased kernels, built once in numpy: the same
linear map as `F.interpolate`, and the same matrices as `_resize_matmul`.

The align-corners upsample of the segmentation decoder and the detector's
neck is the exception: the JAX package writes it as two dense fp32 (out,
in) products because a gather's backward is slow on the TPU; on the card
those products would cost ~0.7 TFLOP of fp32 work at B = 512, so it is
`F.interpolate`, which computes the same function. So is the YOLO head's
nearest upsample (a `repeat` in JAX).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _cubic(x: np.ndarray, a: float) -> np.ndarray:
    x = np.abs(x)
    return np.where(
        x <= 1.0, (a + 2.0) * x ** 3 - (a + 3.0) * x ** 2 + 1.0,
        np.where(x < 2.0,
                 a * x ** 3 - 5.0 * a * x ** 2 + 8.0 * a * x - 4.0 * a, 0.0))


@functools.lru_cache(maxsize=None)
def _resize_matrix(src: int, dst: int, method: str) -> np.ndarray:
    """(dst, src) fp32 matrix of torch's non-antialiased resize with
    align_corners=False: 'bicubic' is cubic convolution with a = -0.75 and
    border-replicated taps, 'bilinear' the triangle kernel with the source
    coordinate clamped at 0 (what `F.interpolate` does at the edges)."""
    m = np.zeros((dst, src), np.float64)
    scale = src / dst
    for o in range(dst):
        s = (o + 0.5) * scale - 0.5
        if method == "bicubic":
            i = int(np.floor(s))
            t = s - i
            taps = np.clip(np.arange(i - 1, i + 3), 0, src - 1)
            weights = _cubic(np.array([1.0 + t, t, 1.0 - t, 2.0 - t]), -0.75)
        elif method == "bilinear":
            s = max(s, 0.0)
            i = min(int(np.floor(s)), src - 1)
            t = s - i
            taps = np.array([i, min(i + 1, src - 1)])
            weights = np.array([1.0 - t, t])
        else:
            raise ValueError(f"unknown resize method {method}")
        for tap, wt in zip(taps, weights):
            m[o, tap] += wt
    return m.astype(np.float32)


def _resize_matmul(x: torch.Tensor, size: Tuple[int, int],
                   method: str) -> torch.Tensor:
    """Separable resize of an NHWC tensor as two products over the h and w
    axes, in x's dtype (bf16 products accumulate in fp32)."""
    n, h, w, c = x.shape
    mh = torch.from_numpy(_resize_matrix(h, size[0], method)).to(x.device,
                                                                  x.dtype)
    mw = torch.from_numpy(_resize_matrix(w, size[1], method)).to(x.device,
                                                                 x.dtype)
    y = torch.matmul(mh, x.permute(0, 3, 1, 2))        # (n, c, H', w)
    return torch.matmul(y, mw.t()).permute(0, 2, 3, 1)  # (n, H', W', c)


def resize_bicubic(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """NHWC bicubic resize, antialias off (torchvision tensor-mode default)."""
    return _resize_matmul(x, size, "bicubic")


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """NHWC bilinear resize, align_corners=False (the SR head's
    F.interpolate, model_ecamp.py:38)."""
    return _resize_matmul(x, size, "bilinear")


def upsample_align_corners(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Bilinear upsample with align_corners=True (the seg decoder's
    nn.Upsample, Segmentation/models_vit.py:77) of an NCHW tensor, in fp32
    and cast back to x's dtype, as `ecamp_tpu/ops/image_ops.py::
    upsample_align_corners` computes it (there on NHWC)."""
    y = F.interpolate(x.float(), scale_factor=scale, mode="bilinear",
                      align_corners=True)
    return y.to(x.dtype)


def upsample_nearest(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Nearest-neighbour upsample by an integer `scale` of an NCHW tensor
    (the YOLO head, detector_model.py:30-31): each pixel repeated `scale`
    times along H and W, as `ecamp_tpu/ops/image_ops.py::upsample_nearest`
    does on NHWC (`F.interpolate(mode="nearest")` gives the same values at
    an integer scale)."""
    return F.interpolate(x, scale_factor=scale, mode="nearest")


def device_normalize_image(x: torch.Tensor, mean: float,
                           std: float) -> torch.Tensor:
    """The device half of the u8 image pipe: quantized u8 gray
    (..., H, W, 1|3) -> normalized fp32 (..., H, W, 3) as
    (u8 / 255 - mean) / std, the host path's ops in its order, the single
    channel broadcast to the 3 identical ones. Other dtypes pass through."""
    if x.dtype != torch.uint8:
        return x
    y = (x.float() / 255.0 - mean) / std
    if y.shape[-1] == 1:
        y = y.expand(*y.shape[:-1], 3)
    return y
