"""Fused LayerNorm: a Triton kernel and its plain version.

Replaces the TPU kernel `ecamp_tpu/kernels/layer_norm.py::_ln_kernel`
(launched by `_ln_pallas`): LayerNorm over the last axis with fp32 mean and
variance, `rsqrt(var + eps)`, fp32 affine, output in the input dtype.

What bounds it on the H100: it is a row reduction plus an elementwise
affine with no matmul (a few flops per element read), so device-memory
bytes bound it. What the design does about it: one program
reads a block of whole rows once, keeps them in registers for the fp32
mean/var reduction and the affine, and writes each output once; weight and
bias are read once per program. The eps is a runtime argument, so 1e-6
(ViT) and 1e-12 (BERT) share one compiled kernel.

`fused_layer_norm` launches the kernel for CUDA tensors and runs the plain
version only for CPU tensors; it never falls back. On a CUDA tensor it is
differentiable through `_LayerNormFn`: the forward is the kernel, the
backward is `_ln_backward`, the closed-form LayerNorm gradient in fp32
torch ops. That is what the JAX package does outside Pallas (`_ln_bwd`
recomputes through `_ln_reference` in XLA); it is not a kernel there
either.
"""

from __future__ import annotations

import functools

import torch

from . import _build

SOURCE = "ecamp_tpu_torch/kernels/layer_norm.py"
MAX_D = 8192  # one program keeps whole rows in registers
_ROW_ELEMS = 4096  # elements per program: rows = max(1, 4096 // BLOCK_D)

launches = _build.LaunchCounter()


def _ln_reference(x, weight, bias, eps):
    """Plain PyTorch LayerNorm (mirrors JAX `_ln_reference`)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * weight.float() + bias.float()
    return y.to(x.dtype)


@functools.cache
def _triton_kernel():
    import triton  # noqa: PLC0415 — the card's machine only
    import triton.language as tl  # noqa: PLC0415

    @triton.jit
    def ln_fwd(x_ptr, w_ptr, b_ptr, y_ptr, rows, d, eps,
               BLOCK_D: tl.constexpr, ROWS: tl.constexpr):
        row = (tl.program_id(0) * ROWS + tl.arange(0, ROWS))[:, None]
        col = tl.arange(0, BLOCK_D)[None, :]
        cmask = col < d
        mask = (row < rows) & cmask
        offs = row.to(tl.int64) * d + col
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        mean = tl.sum(x, axis=1) / d
        xc = tl.where(mask, x - mean[:, None], 0.0)
        var = tl.sum(xc * xc, axis=1) / d
        rstd = 1.0 / tl.sqrt(var + eps)
        w = tl.load(w_ptr + col, mask=cmask, other=0.0).to(tl.float32)
        b = tl.load(b_ptr + col, mask=cmask, other=0.0).to(tl.float32)
        y = xc * rstd[:, None] * w + b
        tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)

    return triton, ln_fwd


def _ln_cuda(x, weight, bias, eps: float):
    d = x.shape[-1]
    if not x.is_contiguous():
        raise ValueError("layer-norm kernel takes a contiguous input")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"layer-norm kernel takes fp32 or bf16, got "
                         f"{x.dtype}")
    if d > MAX_D:
        raise ValueError(f"layer-norm kernel takes d <= {MAX_D}, got {d}")
    if weight.shape != (d,) or bias.shape != (d,):
        raise ValueError(f"weight/bias must be ({d},)")
    if weight.device != x.device or bias.device != x.device:
        raise ValueError("x, weight and bias must be on one device")
    weight, bias = weight.contiguous(), bias.contiguous()
    rows = x.numel() // d
    y = torch.empty_like(x)
    if rows == 0:
        return y
    triton, kernel = _triton_kernel()
    block_d = triton.next_power_of_2(d)
    block_rows = max(1, _ROW_ELEMS // block_d)
    grid = (triton.cdiv(rows, block_rows),)
    with torch.cuda.device(x.device):
        kernel[grid](x, weight, bias, y, rows, d, eps,
                     BLOCK_D=block_d, ROWS=block_rows, num_warps=4)
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
        return _LayerNormFn.apply(x, weight, bias, float(eps))
    if x.device.type != "cpu":
        raise ValueError(f"no layer-norm kernel for device {x.device}")
    return _ln_reference(x, weight, bias, eps)
