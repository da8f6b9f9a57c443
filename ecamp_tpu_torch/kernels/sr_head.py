"""SR head conv stack: the CUDA kernel `csrc/sr_head.cu` and its plain
version.

Counterpart of `ecamp_tpu/kernels/sr_head.py`: relu(conv2(relu(conv1(x) +
b1)) + b2 + x), two 3x3 convs on C = 3 channels, zero padding,
channels-first (N, 3, H, W). Weights are the port's OIHW conv parameters.

`sr_conv_stack` launches a kernel for CUDA tensors and runs the plain
version only for CPU tensors; it never falls back. Of the two kernels,
`sr_path` picks by the input's layout alone: the TMA kernel where its
tensor map takes x (16-byte aligned data, rows a multiple of 16 bytes:
the model's 448^2 images), the generic kernel elsewhere. On a CUDA tensor it is
differentiable through `_SRConvStackFn`: the forward is the kernel, the
backward recomputes through the plain direct formulation (`F.conv2d`), as
the JAX package's `_sr_bwd` recomputes through `_xla_reference`. The
v5e-measured opt-in gate `sr_supported` is not carried over: every CUDA
tensor runs the kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

SOURCE = "ecamp_tpu_torch/csrc/sr_head.cu"
CHANNELS = 3
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = _build.LaunchCounter()      # either kernel
launches_tma = _build.LaunchCounter()  # the TMA kernel alone


def sr_path(x) -> str:
    """"tma" where the TMA kernel takes x (fp32 or bf16, data 16-byte
    aligned, W * itemsize a multiple of 16), else "generic"."""
    aligned = (x.data_ptr() % 16 == 0
               and x.shape[-1] * x.element_size() % 16 == 0)
    return "tma" if x.dtype in _DTYPE_CODES and aligned else "generic"


def _sr_reference(x, w1, b1, w2, b2):
    """Plain PyTorch SR conv stack (mirrors JAX `_xla_reference`): convs in
    x's dtype, each bias added after its conv."""
    dt = x.dtype
    y = F.conv2d(x, w1.to(dt), padding=1)
    y = torch.relu(y + b1.to(dt)[None, :, None, None])
    y = F.conv2d(y, w2.to(dt), padding=1)
    return torch.relu(y + b2.to(dt)[None, :, None, None] + x)


def _check(x, w1, b1, w2, b2) -> None:
    if x.ndim != 4 or x.shape[1] != CHANNELS:
        raise ValueError(f"SR kernel takes (N, {CHANNELS}, H, W), got "
                         f"{tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"SR kernel takes fp32 or bf16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("SR kernel takes a contiguous input")
    if not 0 < x.shape[0] <= 65535:
        raise ValueError(f"SR kernel takes 1..65535 images, got {x.shape[0]}")
    c = CHANNELS
    for w in (w1, w2):
        if tuple(w.shape) != (c, c, 3, 3):
            raise ValueError(f"SR weights must be ({c}, {c}, 3, 3) OIHW, got "
                             f"{tuple(w.shape)}")
    for b in (b1, b2):
        if tuple(b.shape) != (c,):
            raise ValueError(f"SR biases must be ({c},), got {tuple(b.shape)}")
    for t in (w1, b1, w2, b2):
        if t.device != x.device:
            raise ValueError("x, weights and biases must be on one device")


def _sr_cuda(x, w1, b1, w2, b2):
    _check(x, w1, b1, w2, b2)
    n, _, h, w = x.shape
    params = torch.cat([w1.reshape(-1), b1, w2.reshape(-1), b2]).float()
    out = torch.empty_like(x)
    tma = sr_path(x) == "tma"
    name = "ecamp_sr_conv_stack_fwd_tma" if tma else "ecamp_sr_conv_stack_fwd"
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(_build.library(), name)(
            x.data_ptr(), params.data_ptr(), out.data_ptr(), n, h, w,
            _DTYPE_CODES[x.dtype], stream)
    _build.check(err, name)
    launches.add()
    if tma:
        launches_tma.add()
    return out


def _sr_backward(x, w1, b1, w2, b2, g):
    """Gradients of `_sr_reference` at the saved inputs for the output
    gradient g, by recompute through the direct formulation."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_() for t in (x, w1, b1, w2, b2)]
        out = _sr_reference(*ins)
        return torch.autograd.grad(out, ins, g)


class _SRConvStackFn(torch.autograd.Function):
    """The SR kernel forward with the recompute backward."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        return _sr_cuda(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        return _sr_backward(*ctx.saved_tensors, g)


def sr_conv_stack(x, w1, b1, w2, b2):
    """relu(conv2(relu(conv1(x) + b1)) + b2 + x): x (N, 3, H, W), weights
    (3, 3, 3, 3) OIHW, biases (3,). Differentiable in every input."""
    if x.is_cuda:
        return _SRConvStackFn.apply(x, w1, b1, w2, b2)
    if x.device.type != "cpu":
        raise ValueError(f"no SR kernel for device {x.device}")
    return _sr_reference(x, w1, b1, w2, b2)
