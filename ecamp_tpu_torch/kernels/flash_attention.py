"""Fused attention: the CUDA kernel `csrc/attention.cu` and its plain version.

Counterpart of `ecamp_tpu/kernels/flash_attention.py`; the kernel replaces
its `_attn_kernel`. The TPU kernel ran one fused softmax-attention per
(batch*head) grid step with the whole logits tile in VMEM; the Hopper
kernel works on (batch*head, 64-query tile) items and loops over 64-key
tiles with an online softmax, so the logits never reach device memory.
It has two paths, picked by the C entry point from the dtype: bf16 (the
model's) on TMA and `wgmma`, FlashAttention-3 style (a persistent grid;
a producer warp loads Q and rings of K and V tiles through 3-D tensor
maps and stores O; one consumer warpgroup runs Q K^T from shared memory
and P V with P in registers, the next tile's Q K^T issued before this
tile's softmax), and fp32 on the FMA pipe. At every shape of the
pretraining step and of 224-px serving (N <= 256) device-memory bytes
bound it; at N = 785 (448-px serving) the tensor cores do (see the note
in the source).

`flash_attention` launches the kernel for CUDA tensors and runs the plain
version only for CPU tensors. It never falls back: a shape, dtype or
layout the kernel does not take raises. On a CUDA tensor it is
differentiable through `_AttentionFn`: the forward is the kernel, the
backward is `_attention_backward`, which recomputes the fp32 logits and
softmax and takes the four gradient products with `torch.matmul`. That is
what the JAX package does outside Pallas (`_flash_bwd` recomputes through
`_xla_reference` in XLA); it is not a kernel there either.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

SOURCE = "ecamp_tpu_torch/csrc/attention.cu"
HEAD_DIMS = (32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

launches = _build.LaunchCounter()


def _attention_reference(q, k, v, bias=None, scale=None,
                         return_probs: bool = False):
    """Plain PyTorch attention (mirrors `_xla_reference`): fp32 logits and
    softmax, probabilities cast to the input dtype before the PV product,
    which accumulates in fp32. The kernels' test oracle."""
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    logits = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    probs = e / e.sum(dim=-1, keepdim=True)
    out = torch.einsum("...qk,...kd->...qd", probs.to(q.dtype).float(),
                       v.float()).to(q.dtype)
    if return_probs:
        return out, probs
    return out


def _kernel_args(q, k, v, bias) -> Tuple[int, Tuple[int, int, int, int]]:
    """Validate what the kernel takes; return its dtype code and the bias
    element strides (0 on a broadcast dim, all 0 without a bias)."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("attention kernel takes (B, H, N, D) q, k, v")
    b, h, nq, d = q.shape
    nk = k.shape[2]
    if k.shape != (b, h, nk, d) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if nq == 0 or nk == 0 or b * h == 0:
        raise ValueError("attention kernel takes non-empty q and k")
    if d not in HEAD_DIMS:
        raise ValueError(f"attention kernel takes head dim {HEAD_DIMS}, "
                         f"got {d}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"attention kernel takes fp32 or bf16 q/k/v of one "
                         f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("attention kernel takes contiguous q, k, v")
    strides = (0, 0, 0, 0)
    if bias is not None:
        if bias.dtype != torch.float32 or bias.ndim != 4:
            raise ValueError("attention bias must be a 4-D fp32 tensor")
        full = (b, h, nq, nk)
        for have, want in zip(bias.shape, full):
            if have not in (1, want):
                raise ValueError(f"bias {tuple(bias.shape)} does not "
                                 f"broadcast to {full}")
        strides = tuple(0 if bias.shape[i] == 1 else bias.stride(i)
                        for i in range(4))
    return _DTYPE_CODES[q.dtype], strides


def _attention_cuda(q, k, v, bias, scale: float):
    code, (sb_b, sb_h, sb_q, sb_k) = _kernel_args(q, k, v, bias)
    for t in (k, v) + (() if bias is None else (bias,)):
        if t.device != q.device:
            raise ValueError("q, k, v and bias must be on one device")
    if not _build.on_current_device(q):
        with torch.cuda.device(q.device):
            return _attention_cuda(q, k, v, bias, scale)
    b, h, nq, d = q.shape
    out = torch.empty_like(q)
    err = _build.library().ecamp_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if bias is None else bias.data_ptr(),
        sb_b, sb_h, sb_q, sb_k, out.data_ptr(),
        b, h, nq, k.shape[2], d, code, scale,
        _build.launch_stream(q))
    _build.check(err, "ecamp_attention_fwd")
    launches.add()
    return out


def _sum_to(t, shape):
    """Sum a gradient over the dims that broadcasting expanded."""
    dims = tuple(i for i, (a, b) in enumerate(zip(shape, t.shape)) if a != b)
    return t.sum(dim=dims, keepdim=True) if dims else t


def _attention_backward(q, k, v, bias, scale: float, g,
                        bias_grad: bool = False):
    """Gradients of `_attention_reference` (the JAX `_xla_reference`) at
    (q, k, v, bias) for the output gradient g, by recompute:
        P  = softmax(q k^T * scale + bias)   (fp32)
        dV = P^T g, with P rounded to the input dtype first, as the
             forward rounds it before the PV product
        dP = g V^T,  dS = P * (dP - rowsum(dP * P))
        dq = dS k * scale,  dk = dS^T q * scale
    Every product runs in fp32 (exact for bf16 inputs); dq, dk, dv are
    returned in the input dtype, dbias (None unless `bias_grad`) in fp32
    at the bias's broadcast shape."""
    qf, kf, vf, gf = q.float(), k.float(), v.float(), g.float()
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()
    p = torch.softmax(logits, dim=-1)
    dv = torch.matmul(p.to(q.dtype).float().transpose(-1, -2), gf)
    dp = torch.matmul(gf, vf.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dbias = _sum_to(ds, bias.shape) if bias_grad else None
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


class _AttentionFn(torch.autograd.Function):
    """The attention kernel forward with the `_attention_backward`
    gradient; the bias gets one only if it requires one."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale: float):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, bias)
        return _attention_cuda(q, k, v, bias, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        bias_grad = bias is not None and ctx.needs_input_grad[3]
        dq, dk, dv, dbias = _attention_backward(q, k, v, bias, ctx.scale, g,
                                                bias_grad)
        if dbias is not None:
            dbias = dbias.to(bias.dtype)
        return dq, dk, dv, dbias, None


def flash_attention(q, k, v, bias=None, scale: Optional[float] = None):
    """Fused attention. q, k, v: (B, H, N, D); bias additive fp32,
    broadcastable to (B, H, Nq, Nk). Differentiable in q, k, v and
    bias."""
    d = q.shape[-1]
    scale = float((d ** -0.5) if scale is None else scale)
    if q.is_cuda:
        if _build.needs_grad(q, k, v, bias):
            return _AttentionFn.apply(q, k, v, bias, scale)
        return _attention_cuda(q, k, v, bias, scale)
    if q.device.type != "cpu":
        raise ValueError(f"no attention kernel for device {q.device}")
    return _attention_reference(q, k, v, bias, scale)
