"""Fused attention: the CUDA kernel `csrc/attention.cu` and its plain version.

Counterpart of `ecamp_tpu/kernels/flash_attention.py`. The TPU kernel ran
one fused softmax-attention per (batch*head) grid step; the Hopper kernel
runs one thread block per (batch*head, 64-query tile) and loops over
64-key tiles with an online softmax (see the note in the source).

`flash_attention` launches the kernel for CUDA tensors and runs the plain
version only for CPU tensors. It never falls back: a shape, dtype or
layout the kernel does not take raises. There is no backward pass yet;
the port serves (ROADMAP Queue 2).
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
    b, h, nq, d = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _build.library().ecamp_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(),
            sb_b, sb_h, sb_q, sb_k, out.data_ptr(),
            b, h, nq, k.shape[2], d, code, scale, stream)
    _build.check(err, "ecamp_attention_fwd")
    launches.add()
    return out


def flash_attention(q, k, v, bias=None, scale: Optional[float] = None):
    """Fused attention. q, k, v: (B, H, N, D); bias additive fp32,
    broadcastable to (B, H, Nq, Nk). Forward only."""
    d = q.shape[-1]
    scale = float((d ** -0.5) if scale is None else scale)
    if q.is_cuda:
        return _attention_cuda(q, k, v, bias, scale)
    if q.device.type != "cpu":
        raise ValueError(f"no attention kernel for device {q.device}")
    return _attention_reference(q, k, v, bias, scale)
