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
nearest upsample (a `repeat` in JAX). `F.interpolate`'s bilinear backward
adds into the input's gradient atomically, so on the card two runs of a
step differ. The align-corners upsample's backward here is the transposed
resize as two dense fp32 products instead (as the JAX package's backward
is), which cuBLAS computes in a fixed order, so a seg or det fine-tune
repeats itself bit for bit, and so does its resume.
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


_MATRICES_ON_DEVICE = {}


def _resize_matrix_on(src: int, dst: int, method: str, device,
                      dtype) -> torch.Tensor:
    """`_resize_matrix(src, dst, method)` on `device` in `dtype`, made once
    a shape: a step copies nothing from the host, which a CUDA graph of it
    could not capture."""
    key = (src, dst, method, device, dtype)
    if key not in _MATRICES_ON_DEVICE:
        _MATRICES_ON_DEVICE[key] = torch.from_numpy(
            _resize_matrix(src, dst, method)).to(device, dtype)
    return _MATRICES_ON_DEVICE[key]


def _resize_matmul(x: torch.Tensor, size: Tuple[int, int],
                   method: str) -> torch.Tensor:
    """Separable resize of an NHWC tensor as two products over the h and w
    axes, in x's dtype (bf16 products accumulate in fp32)."""
    n, h, w, c = x.shape
    mh = _resize_matrix_on(h, size[0], method, x.device, x.dtype)
    mw = _resize_matrix_on(w, size[1], method, x.device, x.dtype)
    y = torch.matmul(mh, x.permute(0, 3, 1, 2))        # (n, c, H', w)
    return torch.matmul(y, mw.t()).permute(0, 2, 3, 1)  # (n, H', W', c)


def resize_bicubic(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """NHWC bicubic resize, antialias off (torchvision tensor-mode default)."""
    return _resize_matmul(x, size, "bicubic")


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """NHWC bilinear resize, align_corners=False (the SR head's
    F.interpolate, model_ecamp.py:38)."""
    return _resize_matmul(x, size, "bilinear")


@functools.lru_cache(maxsize=None)
def _align_corners_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) fp32 matrix of the align-corners bilinear resize src ->
    dst along one axis, with `F.interpolate`'s own fp32 weights: output o
    reads input i = int(s) and i + 1 (i itself at the last input) at s =
    o * float32((src - 1) / (dst - 1))."""
    scale = (np.float32(src - 1) / np.float32(dst - 1) if dst > 1
             else np.float32(0.0))
    m = np.zeros((dst, src), np.float32)
    for o in range(dst):
        s = scale * np.float32(o)
        i = int(s)
        lam1 = s - np.float32(i)
        m[o, i] += np.float32(1.0) - lam1
        m[o, i + (1 if i < src - 1 else 0)] += lam1
    return m


def _transposed_matrix(src: int, dst: int, device) -> torch.Tensor:
    """`_align_corners_matrix(src, dst)`ᵀ, (src, dst), on `device`, made
    once a shape."""
    key = (src, dst, device)
    if key not in _MATRICES_ON_DEVICE:
        _MATRICES_ON_DEVICE[key] = torch.from_numpy(
            np.ascontiguousarray(_align_corners_matrix(src, dst).T)
        ).to(device)
    return _MATRICES_ON_DEVICE[key]


class _UpsampleAlignCorners(torch.autograd.Function):
    """fp32 NCHW bilinear upsample, align_corners=True: `F.interpolate`
    forward; backward the transposed resize as two batched fp32 products
    on the NHWC view (channels_last memory), W then H (module docstring)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, scale: int) -> torch.Tensor:
        ctx.hw = x.shape[-2:]
        return F.interpolate(x, scale_factor=scale, mode="bilinear",
                             align_corners=True)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g: torch.Tensor):
        h, w = ctx.hw
        b, c, ho, wo = g.shape
        t = g.float().permute(0, 2, 3, 1).reshape(b * ho, wo, c)
        mw = _transposed_matrix(w, wo, g.device)  # (w, wo)
        t = torch.bmm(mw.expand(b * ho, w, wo), t)  # (b ho, w, c)
        mh = _transposed_matrix(h, ho, g.device)  # (h, ho)
        t = torch.bmm(mh.expand(b, h, ho), t.view(b, ho, w * c))
        return t.view(b, h, w, c).permute(0, 3, 1, 2), None


def upsample_align_corners(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Bilinear upsample with align_corners=True (the seg decoder's
    nn.Upsample, Segmentation/models_vit.py:77) of an NCHW tensor, in fp32
    and cast back to x's dtype, as `ecamp_tpu/ops/image_ops.py::
    upsample_align_corners` computes it (there on NHWC). Its backward is
    deterministic (module docstring)."""
    return _UpsampleAlignCorners.apply(x.float(), scale).to(x.dtype)


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
