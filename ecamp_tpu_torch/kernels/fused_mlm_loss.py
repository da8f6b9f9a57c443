"""Fused vocab projection + weighted cross-entropy: the CUDA kernels
`csrc/fused_mlm_loss.cu` and their plain versions.

Counterpart of `ecamp_tpu/kernels/fused_mlm_loss.py`. The MLM head's
30000-way projection feeds a per-position weighted CE; the kernels never
store the (N, V) logits:

  fwd  (`_fused_fwd`)        lse, gold per row, fp32
  dx   (`_fused_bwd_impl`)   dl = (softmax - onehot) * w * g; dx = dl' W
  dW   (`_fused_bwd_impl`)   dW = dl'^T x; db = colsum(dl) in fp32

with dl' = dl rounded to x's dtype, as the Pallas kernels round it. The
weight is the port's Linear layout, (V, D) row-major, where JAX's is
(D, V). bf16 inputs with D % 8 == 0 run the products on the tensor cores
(`mma.sync`), fp32 and other widths on the FMA pipe; the kernel picks.
`fused_mlm_loss_sum` returns sum_i weights_i * CE_i; the caller divides
by N for the reference's mean over every position.

On a CUDA tensor it always launches the kernels (three launches for a
forward and backward) and raises on what they do not take. On a CPU tensor,
or with `plain=True` (the on-card reference), the same autograd Function
runs `_fused_reference`'s forward and `_fused_backward_plain`, the plain
versions with the kernels' dtype rules. The v5e-measured opt-in gate
`fused_supported` (`ECAMP_FUSED_CE`) is not carried over: the caller asks
for the fused CE with `ECAMP(fused_mlm_ce=True)`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build

SOURCE = "ecamp_tpu_torch/csrc/fused_mlm_loss.cu"
MAX_D = 768  # the backward kernels hold a (32, D) accumulator in registers
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# one counter per kernel: the forward and the two backward launches
launches_fwd = _build.LaunchCounter()
launches_dx = _build.LaunchCounter()
launches_dw = _build.LaunchCounter()


def _logits(x, w, b):
    return x.float() @ w.float().T + b.float()


def _fused_reference(x, w, b, labels, weights):
    """The plain fp32 materialised formula (JAX `_xla_reference`):
    sum_i weights_i * (logsumexp(logits_i) - logits_i[label_i]), with
    logits = x w^T + b, w (V, D). Differentiable through autograd."""
    logits = _logits(x, w, b)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    return torch.sum((lse - gold) * weights.float())


def _forward_plain(x, w, b, labels) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lse, gold) of `_fused_reference`'s logits, fp32 (N,)."""
    logits = _logits(x, w, b)
    return (torch.logsumexp(logits, dim=-1),
            torch.gather(logits, -1, labels.long()[:, None])[:, 0])


def _fused_backward_plain(x, w, b, labels, lse, wg):
    """The backward kernels' math on materialised fp32 logits: dl in fp32,
    dx = dl' w and dW = dl'^T x from dl rounded to x's dtype, db = colsum
    of dl in fp32. Returns (dx in x's dtype, dW in w's dtype, db fp32)."""
    dl = torch.exp(_logits(x, w, b) - lse[:, None])
    dl[torch.arange(x.shape[0], device=x.device), labels.long()] -= 1.0
    dl *= wg[:, None]
    dlc = dl.to(x.dtype).float()
    return ((dlc @ w.float()).to(x.dtype), (dlc.T @ x.float()).to(w.dtype),
            dl.sum(dim=0))


def _check(x, w, b, labels) -> int:
    """Validate what the kernels take; return the dtype code."""
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"fused CE takes x (N, D) and w (V, D), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    n, d = x.shape
    v = w.shape[0]
    if not (0 < d <= MAX_D) or n == 0 or v == 0:
        raise ValueError(f"fused CE kernels take 0 < D <= {MAX_D} and "
                         f"non-empty x and w, got N {n}, D {d}, V {v}")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise ValueError(f"fused CE kernels take fp32 or bf16 x and w of one "
                         f"dtype, got {x.dtype} and {w.dtype}")
    if b.dtype != torch.float32 or tuple(b.shape) != (v,):
        raise ValueError(f"fused CE bias must be fp32 ({v},), got {b.dtype} "
                         f"{tuple(b.shape)}")
    if tuple(labels.shape) != (n,):
        raise ValueError(f"fused CE labels must be ({n},), got "
                         f"{tuple(labels.shape)}")
    for t in (x, w, b):
        if not t.is_contiguous():
            raise ValueError("fused CE kernels take contiguous x, w and b")
    for t in (w, b, labels):
        if t.device != x.device:
            raise ValueError("x, w, b and labels must be on one device")
    return _DTYPE_CODES[x.dtype]


def _forward_cuda(x, w, b, labels) -> Tuple[torch.Tensor, torch.Tensor]:
    code = _check(x, w, b, labels)
    n, d = x.shape
    labels = labels.to(torch.int64).contiguous()
    lse = torch.empty(n, dtype=torch.float32, device=x.device)
    gold = torch.empty_like(lse)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _build.library().ecamp_fused_ce_fwd(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), labels.data_ptr(),
            lse.data_ptr(), gold.data_ptr(), n, w.shape[0], d, code, stream)
    _build.check(err, "ecamp_fused_ce_fwd")
    launches_fwd.add()
    return lse, gold


def _backward_cuda(x, w, b, labels, lse, wg):
    code = _check(x, w, b, labels)
    n, d = x.shape
    v = w.shape[0]
    labels = labels.to(torch.int64).contiguous()
    lse = lse.float().contiguous()
    wg = wg.float().contiguous()
    dx = torch.empty_like(x)
    dw = torch.empty_like(w)
    db = torch.empty(v, dtype=torch.float32, device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ecamp_fused_ce_bwd_dx(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), labels.data_ptr(),
            lse.data_ptr(), wg.data_ptr(), dx.data_ptr(), n, v, d, code,
            stream)
        _build.check(err, "ecamp_fused_ce_bwd_dx")
        launches_dx.add()
        err = lib.ecamp_fused_ce_bwd_dw(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), labels.data_ptr(),
            lse.data_ptr(), wg.data_ptr(), dw.data_ptr(), db.data_ptr(), n,
            v, d, code, stream)
        _build.check(err, "ecamp_fused_ce_bwd_dw")
        launches_dw.add()
    return dx, dw, db


class _FusedMLMLossFn(torch.autograd.Function):
    """sum_i weights_i * CE_i: the forward and backward kernels on CUDA
    tensors, their plain versions on CPU tensors or with `plain`. The
    upstream gradient stays a device value (no host synchronisation)."""

    @staticmethod
    def forward(ctx, x, w, b, labels, weights, plain: bool):
        use_kernels = x.is_cuda and not plain
        fwd = _forward_cuda if use_kernels else _forward_plain
        lse, gold = fwd(x, w, b, labels)
        ctx.use_kernels = use_kernels
        ctx.save_for_backward(x, w, b, labels, weights, lse)
        return torch.sum((lse - gold) * weights.float())

    @staticmethod
    def backward(ctx, g):
        x, w, b, labels, weights, lse = ctx.saved_tensors
        wg = g * weights.float()
        bwd = _backward_cuda if ctx.use_kernels else _fused_backward_plain
        dx, dw, db = bwd(x, w, b, labels, lse, wg)
        return dx, dw, db.to(b.dtype), None, None, None


def fused_mlm_loss_sum(x, w, b, labels, weights, plain: bool = False):
    """sum_i weights_i * CE_i with the vocab projection fused in.
    x: (N, D), w: (V, D), b: (V,) fp32, labels and weights: (N,).
    Differentiable in x, w and b."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused CE kernel for device {x.device}")
    return _FusedMLMLossFn.apply(x, w, b, labels, weights, plain)
