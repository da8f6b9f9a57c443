"""int8-weight linear: the CUDA kernel `csrc/int8_linear.cu` and its plain
version, `y = x · bf16(float(q) · s)ᵀ + b`.

Replaces no Pallas kernel. The JAX package's `--quantize int8`
(`ecamp_tpu/serve/quantize.py:60-83`) keeps each chosen weight as int8 with
one fp32 scale an output channel and dequantises it inside the jitted
apply, where XLA fuses the convert into the consuming dot: the weights leave
device memory as int8. Done in torch ops, the same math would write a
dequantised bf16 copy of every weight and read it again on every forward,
more bytes than serving the fp32 weights. The kernel is that fusion: it
reads the int8 weight and widens it on chip (see the note in the source).

What bounds it on the H100: at serving's small M the weight read (N·K
bytes, half of bf16's), at large M the tensor cores (2·M·N·K operations).

`int8_linear` launches the kernel for CUDA tensors and runs the plain
version only for CPU tensors; it never falls back. The weights are frozen,
so there is no backward: a call that autograd would have to see raises, on
either device. On a CUDA tensor it also raises for another x than bf16, a
K that is not a multiple of 16, and a bias in another dtype than x's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

SOURCE = "ecamp_tpu_torch/csrc/int8_linear.cu"
K_MULTIPLE = 16  # the kernel's depth step (mma.sync m16n8k16)
MAX_ROWS = 65535 * 64  # the grid's y limit at the kernel's smallest row tile

launches = _build.LaunchCounter()


def dequantize_int8(q, s, dtype):
    """The weight `q · s` (scale per output channel, axis 0) in fp32, then
    in `dtype`: the JAX package's `dequantize` (`q.astype(f32) * s`)
    followed by the consuming layer's cast to its compute dtype."""
    return (q.float() * s.reshape((-1,) + (1,) * (q.ndim - 1))).to(dtype)


def _int8_linear_reference(x, q, s, b=None):
    """Plain PyTorch: F.linear with the dequantised weight in x's dtype."""
    return F.linear(x, dequantize_int8(q, s, x.dtype), b)


def _int8_linear_cuda(x, q, s, b):
    if x.dtype != torch.bfloat16:
        raise ValueError(f"int8-linear kernel takes a bf16 x, got {x.dtype}")
    if q.dtype != torch.int8 or q.ndim != 2:
        raise ValueError(f"int8-linear kernel takes an (N, K) int8 weight, "
                         f"got {tuple(q.shape)} {q.dtype}")
    n, k = q.shape
    if x.shape[-1] != k:
        raise ValueError(f"x's last dim {x.shape[-1]} != the weight's K {k}")
    if k == 0 or k % K_MULTIPLE:
        raise ValueError(f"int8-linear kernel takes K a multiple of "
                         f"{K_MULTIPLE}, got {k}")
    if s.shape != (n,) or s.dtype != torch.float32:
        raise ValueError(f"scales must be ({n},) fp32, got {tuple(s.shape)} "
                         f"{s.dtype}")
    if b is not None and (b.shape != (n,) or b.dtype != x.dtype):
        raise ValueError(f"bias must be ({n},) {x.dtype}, got "
                         f"{tuple(b.shape)} {b.dtype}")
    if any(t is not None and t.device != x.device for t in (q, s, b)):
        raise ValueError("x, q, s and b must be on one device")
    lead = x.shape[:-1]
    rows = x.numel() // k
    if rows > MAX_ROWS:
        raise ValueError(f"int8-linear kernel takes <= {MAX_ROWS} rows, "
                         f"got {rows}")
    if not _build.on_current_device(x):
        with torch.cuda.device(x.device):
            return _int8_linear_cuda(x, q, s, b)
    x2 = x.reshape(rows, k)
    if not x2.is_contiguous() or x2.data_ptr() % 16:
        x2 = x2.clone(memory_format=torch.contiguous_format)
    if not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError("int8-linear kernel takes a contiguous, 16-byte "
                         "aligned weight")
    s = s.contiguous()
    b = None if b is None else b.contiguous()
    y = torch.empty((rows, n), dtype=x.dtype, device=x.device)
    if rows == 0 or n == 0:
        return y.reshape(*lead, n)
    err = _build.library().ecamp_int8_linear(
        x2.data_ptr(), q.data_ptr(), s.data_ptr(),
        None if b is None else b.data_ptr(), y.data_ptr(), rows, n, k,
        _build.launch_stream(x))
    _build.check(err, "ecamp_int8_linear")
    launches.add()
    return y.reshape(*lead, n)


def int8_linear(x, q, s, b=None):
    """y = x · bf16(float(q) · s)ᵀ + b. x: (..., K); q: (N, K) int8;
    s: (N,) fp32; b: (N,) in x's dtype or None. Not differentiable."""
    if _build.needs_grad(x, b):
        raise RuntimeError("int8_linear has no backward (the quantized "
                           "weights are frozen): call it under "
                           "torch.no_grad() or torch.inference_mode()")
    if x.is_cuda:
        return _int8_linear_cuda(x, q, s, b)
    if x.device.type != "cpu":
        raise ValueError(f"no int8-linear kernel for device {x.device}")
    return _int8_linear_reference(x, q, s, b)
