"""Fused LayerNorm: the CUDA kernel `csrc/layer_norm.cu` and its plain
version.

Replaces the TPU kernel `ecamp_tpu/kernels/layer_norm.py::_ln_kernel`
(launched by `_ln_pallas`): LayerNorm over the last axis with fp32 mean and
variance, `rsqrt(var + eps)`, fp32 affine, output in the input dtype.

What bounds it on the H100: it is a row reduction plus an elementwise
affine with no matmul (a few flops per element read), so device-memory
bytes bound it: 7.5 us for (8192, 768) bf16. At that size the launch
matters as much: the pretraining step launches it 51 times, and a Triton
kernel's Python launcher took longer than the kernel ran. What the design
does about it: one ctypes call launches a kernel that gives each row a
warp, reads the row once with 16-byte loads, keeps it in registers for
the fp32 mean/var reduction and the affine, and writes it once; weight and
bias stay in registers across a warp's rows (see the note in the source).
The eps is a runtime argument, so 1e-6 (ViT) and 1e-12 (BERT) share one
kernel.

`fused_layer_norm` launches the kernel for CUDA tensors and runs the plain
version only for CPU tensors; it never falls back. On a CUDA tensor it is
differentiable through `_LayerNormFn`: the forward is the kernel, the
backward is `_ln_backward`, the closed-form LayerNorm gradient in fp32
torch ops. That is what the JAX package does outside Pallas (`_ln_bwd`
recomputes through `_ln_reference` in XLA); it is not a kernel there
either.
"""

from __future__ import annotations

import torch

from . import _build

SOURCE = "ecamp_tpu_torch/csrc/layer_norm.cu"
MAX_D = 8192  # the widest row taken; above 1024 the kernel strides
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = _build.LaunchCounter()


def _ln_reference(x, weight, bias, eps):
    """Plain PyTorch LayerNorm (mirrors JAX `_ln_reference`)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * weight.float() + bias.float()
    return y.to(x.dtype)


def _ln_cuda(x, weight, bias, eps: float):
    d = x.shape[-1]
    if not x.is_contiguous():
        raise ValueError("layer-norm kernel takes a contiguous input")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"layer-norm kernel takes fp32 or bf16, got "
                         f"{x.dtype}")
    if d > MAX_D:
        raise ValueError(f"layer-norm kernel takes d <= {MAX_D}, got {d}")
    if weight.shape != (d,) or bias.shape != (d,):
        raise ValueError(f"weight/bias must be ({d},)")
    if weight.device != x.device or bias.device != x.device:
        raise ValueError("x, weight and bias must be on one device")
    rows = x.numel() // d
    if rows >= 2 ** 31:
        raise ValueError(f"layer-norm kernel takes < 2**31 rows, got {rows}")
    if not _build.on_current_device(x):
        with torch.cuda.device(x.device):
            return _ln_cuda(x, weight, bias, eps)
    # the kernel reads fp32 weight and bias (the model's parameters are)
    if weight.dtype != torch.float32 or bias.dtype != torch.float32:
        weight, bias = weight.float(), bias.float()
    weight, bias = weight.contiguous(), bias.contiguous()
    y = torch.empty_like(x)
    if rows == 0:
        return y
    err = _build.library().ecamp_layer_norm_fwd(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(), rows, d,
        _DTYPE_CODES[x.dtype], eps, _build.launch_stream(x))
    _build.check(err, "ecamp_layer_norm_fwd")
    launches.add()
    return y


def _ln_backward(x, weight, eps: float, g):
    """Gradients of `_ln_reference` at (x, weight) for the output
    gradient g: dx in x's dtype, dweight and dbias in fp32 (summed over
    every row). Closed form, in fp32:
        dx = rstd * (g*w - mean(g*w) - xhat * mean(g*w * xhat))."""
    d = x.shape[-1]
    xf = x.float().reshape(-1, d)
    gf = g.float().reshape(-1, d)
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt(xc.square().mean(dim=-1, keepdim=True) + eps)
    xhat = xc * rstd
    dweight = (gf * xhat).sum(dim=0)
    dbias = gf.sum(dim=0)
    gw = gf * weight.float()
    dx = rstd * (gw - gw.mean(dim=-1, keepdim=True)
                 - xhat * (gw * xhat).mean(dim=-1, keepdim=True))
    return dx.reshape(x.shape).to(x.dtype), dweight, dbias


class _LayerNormFn(torch.autograd.Function):
    """The LayerNorm kernel forward with the `_ln_backward` gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float):
        ctx.eps = eps
        ctx.save_for_backward(x, weight)
        return _ln_cuda(x, weight, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dweight, dbias = _ln_backward(x, weight, ctx.eps, g)
        return (dx, dweight.to(weight.dtype), dbias.to(weight.dtype), None)


def fused_layer_norm(x, weight, bias, eps: float = 1e-6):
    """LayerNorm over the last axis. weight/bias: (d,). Differentiable in
    x, weight and bias."""
    if x.is_cuda:
        if _build.needs_grad(x, weight, bias):
            return _LayerNormFn.apply(x, weight, bias, float(eps))
        return _ln_cuda(x, weight, bias, float(eps))
    if x.device.type != "cpu":
        raise ValueError(f"no layer-norm kernel for device {x.device}")
    return _ln_reference(x, weight, bias, eps)
