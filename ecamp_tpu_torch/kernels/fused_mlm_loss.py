"""Fused vocab projection + weighted cross-entropy: the CUDA kernels
`csrc/fused_mlm_loss.cu` and their plain versions.

Counterpart of `ecamp_tpu/kernels/fused_mlm_loss.py`. The MLM head's
30000-way projection feeds a per-position weighted CE:

  fwd  (`_fused_fwd`)        lse, gold per row, fp32; logits never stored
  bwd  (`_fused_bwd_impl`)   dl = (softmax - onehot) * w * g;
                             dx = dl' W; dW = dl'^T x; db = colsum(dl) fp32

with dl' = dl rounded to x's dtype, as the Pallas kernels round it. The
weight is the port's Linear layout, (V, D) row-major, where JAX's is
(D, V).

bf16 inputs with D % 8 == 0 and 16-byte aligned x and w (the shape rule
`_tensor_core_path`) run TMA + `wgmma` GEMMs with different epilogues. The
forward is two kernels:

  tiles  S = x W^T in TILE_V-wide vocab tiles; each row's tile max and
         sum-exp into an fp32 (ceil(V / TILE_V), N, 2) buffer, and the gold
         logit from the tile that holds the label
  merge  each row's tiles folded in a fixed order into lse; gold 0 for a
         label outside [0, V)

(`_fwd_tiles_plain`, `_fwd_merge_plain`). The backward runs over vocab
chunks of CHUNK_V rows, three kernels a chunk:

  dl   S = x W_c^T; dl' of the chunk into an (N, CHUNK_V) scratch, and one
       fp32 column sum of dl per 128-row tile into a partials buffer
  dx   dx32 (+)= dl'_c W_c into an fp32 (N, D) scratch; the last chunk
       writes dx in x's dtype
  dW   dW_c = dl'_c^T x in w's dtype; db_c = the partials summed in order

so each logit is computed once a pass. The (N, V) logits never reach
device memory, but the scratch does: the forward's tile stats (15.4 MB at
N = 8192, V = 30000), dl' (N x CHUNK_V in x's dtype, 67 MB at N = 8192),
dx32 (N x D fp32, 25 MB) and the partials (1 MB). fp32, and bf16 of other
widths or alignments, run on the FMA pipe: one forward kernel, and one dx
and one dW + db kernel that each recompute the logits.

`fused_mlm_loss_sum` returns sum_i weights_i * CE_i; the caller divides
by N for the reference's mean over every position. On a CUDA tensor it
always launches the kernels and raises on what they do not take. On a CPU
tensor, or with `plain=True` (the on-card reference), the same autograd
Function runs `_fused_reference`'s forward and `_fused_backward_plain`.
`_backward_chunked_plain` composes the chunk kernels' plain versions
(`_dl_chunk_plain`, `_dx_chunk_plain`, `_dw_chunk_plain`); the tests and
`chip_smoke.py` hold the kernels to them. The v5e-measured opt-in gate
`fused_supported` (`ECAMP_FUSED_CE`) is not carried over: the caller asks
for the fused CE with `ECAMP(fused_mlm_ce=True)`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _build

SOURCE = "ecamp_tpu_torch/csrc/fused_mlm_loss.cu"
MAX_D = 768  # the FMA backward holds a (32, D) accumulator in registers
CHUNK_V = 4096  # vocab rows a chunk of the tensor-core backward; tests lower it
TILE_M = 128    # rows of x a partial column sum of dl covers (csrc's tc::kBM)
# vocab columns a tile of the tensor-core forward (csrc's tc::kDlBN; the
# kernel takes no other, the plain version's tests lower it)
TILE_V = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# one counter per kernel: the forward (the FMA kernel, or the tensor-core
# tile kernel) and the tensor-core forward's merge, and the backward's dl,
# dx and dW (the FMA backward launches dx and dW once a call, the
# tensor-core one each of the three once a chunk)
launches_fwd = _build.LaunchCounter()
launches_merge = _build.LaunchCounter()
launches_dl = _build.LaunchCounter()
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


def _fwd_tiles_plain(x, w, b, labels):
    """The forward tile kernel's outputs: for each TILE_V-wide vocab tile
    (the last one ragged) and each row, the max logit m of the tile and the
    sum of exp(logit - m) over it, fp32 (ceil(V / TILE_V), N, 2); and each
    row's gold logit, fp32 (N,), 0 for a label outside [0, V) (the kernel
    leaves those rows to the merge)."""
    logits = _logits(x, w, b)
    n, v = logits.shape
    tiles = torch.nn.functional.pad(logits, (0, -v % TILE_V),
                                    value=-float("inf")).view(n, -1, TILE_V)
    m = tiles.amax(dim=-1)
    stats = torch.stack((m, torch.exp(tiles - m[..., None]).sum(dim=-1)),
                        dim=-1)
    lab = labels.long()
    inside = (lab >= 0) & (lab < v)
    gold = torch.gather(logits, -1, lab.clamp(0, v - 1)[:, None])[:, 0]
    return stats.transpose(0, 1).contiguous(), torch.where(inside, gold, 0.0)


def _fwd_merge_plain(stats, labels, gold, v: int):
    """The merge kernel: each row's (m, l) pairs folded, m <- max(m, m_t),
    l <- l exp(m_old - m) + l_t exp(m_t - m), into lse = m + log(l); gold
    with 0 where the label lies outside [0, v). Returns (lse, gold), fp32
    (N,). Folded here in tile order; the kernel folds in another fixed
    order (eight interleaved shares of the tiles, then the shares), equal
    up to fp32 rounding."""
    m = torch.full_like(stats[0, :, 0], -float("inf"))
    l = torch.zeros_like(m)
    for t in range(stats.shape[0]):
        m_t, l_t = stats[t, :, 0], stats[t, :, 1]
        m_new = torch.maximum(m, m_t)
        l = l * torch.exp(m - m_new) + l_t * torch.exp(m_t - m_new)
        m = m_new
    lab = labels.long()
    inside = (lab >= 0) & (lab < v)
    return m + torch.log(l), torch.where(inside, gold, 0.0)


def _forward_tiled_plain(x, w, b, labels):
    """The tensor-core forward's math from its two kernels' plain
    versions: (lse, gold), fp32 (N,)."""
    stats, gold = _fwd_tiles_plain(x, w, b, labels)
    return _fwd_merge_plain(stats, labels, gold, w.shape[0])


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


def _chunks(v: int, chunk: int):
    """(v0, width) of each vocab chunk; the last one is ragged."""
    return [(v0, min(chunk, v - v0)) for v0 in range(0, v, chunk)]


def _dl_chunk_plain(x, w, b, labels, lse, wg, v0, width):
    """The dl kernel's outputs for vocab rows [v0, v0 + width): dl' (N,
    width) in x's dtype, and the fp32 column sums of dl over each TILE_M
    rows of x, (ceil(N / TILE_M), width)."""
    n = x.shape[0]
    z = x.float() @ w[v0:v0 + width].float().T + b[v0:v0 + width].float()
    dl = torch.exp(z - lse.float()[:, None])
    lab = labels.long() - v0
    rows = torch.nonzero((lab >= 0) & (lab < width))[:, 0]
    dl[rows, lab[rows]] -= 1.0
    dl *= wg.float()[:, None]
    pad = -n % TILE_M
    partials = torch.nn.functional.pad(dl, (0, 0, 0, pad)).view(
        -1, TILE_M, width).sum(dim=1)
    return dl.to(x.dtype), partials


def _dx_chunk_plain(dlc, w, v0, acc=None):
    """The dx kernel's product for one chunk: acc + dl'_c W_c in fp32
    (acc None on the first chunk)."""
    prod = dlc.float() @ w[v0:v0 + dlc.shape[1]].float()
    return prod if acc is None else acc + prod


def _dw_chunk_plain(dlc, x, partials):
    """The dW kernel's outputs for one chunk: dW_c = dl'_c^T x in x's dtype
    and db_c, the partial column sums added in tile order, fp32."""
    return (dlc.float().T @ x.float()).to(x.dtype), partials.sum(dim=0)


def _backward_chunked_plain(x, w, b, labels, lse, wg):
    """The tensor-core backward's math chunk by chunk (CHUNK_V rows), from
    the three kernels' plain versions: (dx in x's dtype, dW in w's, db
    fp32)."""
    dw = torch.empty_like(w)
    db = torch.empty(w.shape[0], dtype=torch.float32, device=x.device)
    acc = None
    for v0, width in _chunks(w.shape[0], CHUNK_V):
        dlc, partials = _dl_chunk_plain(x, w, b, labels, lse, wg, v0, width)
        acc = _dx_chunk_plain(dlc, w, v0, acc)
        dw[v0:v0 + width], db[v0:v0 + width] = _dw_chunk_plain(
            dlc, x, partials)
    return acc.to(x.dtype), dw, db


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
    v = w.shape[0]
    labels = labels.to(torch.int64).contiguous()
    lse = torch.empty(n, dtype=torch.float32, device=x.device)
    gold = torch.empty_like(lse)
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if not _tensor_core_path(x, w):
            err = lib.ecamp_fused_ce_fwd(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), labels.data_ptr(),
                lse.data_ptr(), gold.data_ptr(), n, v, d, code, stream)
            _build.check(err, "ecamp_fused_ce_fwd")
            launches_fwd.add()
            return lse, gold
        tiles = -(-v // TILE_V)
        stats = torch.empty(tiles, n, 2, dtype=torch.float32, device=x.device)
        err = lib.ecamp_fused_ce_fwd_tiles(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), labels.data_ptr(),
            stats.data_ptr(), gold.data_ptr(), n, v, d, tiles, stream)
        _build.check(err, "ecamp_fused_ce_fwd_tiles")
        launches_fwd.add()
        err = lib.ecamp_fused_ce_fwd_merge(
            stats.data_ptr(), labels.data_ptr(), lse.data_ptr(),
            gold.data_ptr(), n, v, tiles, stream)
        _build.check(err, "ecamp_fused_ce_fwd_merge")
        launches_merge.add()
    return lse, gold


def _tensor_core_path(x, w) -> bool:
    """The shape rule of both passes: bf16 with D % 8 == 0 and 16-byte
    aligned x and w (what TMA takes) runs the tensor-core kernels (the
    two-kernel forward, the chunked backward); anything else the FMA
    kernels."""
    return (x.dtype == torch.bfloat16 and x.shape[1] % 8 == 0
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)


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
        if not _tensor_core_path(x, w):
            err = lib.ecamp_fused_ce_bwd_dx(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), labels.data_ptr(),
                lse.data_ptr(), wg.data_ptr(), dx.data_ptr(), n, v, d, code,
                stream)
            _build.check(err, "ecamp_fused_ce_bwd_dx")
            launches_dx.add()
            err = lib.ecamp_fused_ce_bwd_dw(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), labels.data_ptr(),
                lse.data_ptr(), wg.data_ptr(), dw.data_ptr(), db.data_ptr(),
                n, v, d, code, stream)
            _build.check(err, "ecamp_fused_ce_bwd_dw")
            launches_dw.add()
            return dx, dw, db
        chunks = _chunks(v, CHUNK_V)
        # scratch rows padded to 8 elements: TMA takes 16-byte row strides
        ld = -(-chunks[0][1] // 8) * 8
        dl = torch.empty(n, ld, dtype=x.dtype, device=x.device)
        partials = torch.empty(-(-n // TILE_M), ld, dtype=torch.float32,
                               device=x.device)
        dx32 = (torch.empty(n, d, dtype=torch.float32, device=x.device)
                if len(chunks) > 1 else dx)  # one chunk writes dx at once
        for i, (v0, width) in enumerate(chunks):
            err = lib.ecamp_fused_ce_bwd_dl(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), labels.data_ptr(),
                lse.data_ptr(), wg.data_ptr(), dl.data_ptr(),
                partials.data_ptr(), n, v, d, v0, width, ld, stream)
            _build.check(err, "ecamp_fused_ce_bwd_dl")
            launches_dl.add()
            err = lib.ecamp_fused_ce_bwd_dx_chunk(
                dl.data_ptr(), w.data_ptr(), dx32.data_ptr(), dx.data_ptr(),
                n, v, d, v0, width, ld, int(i == 0),
                int(i == len(chunks) - 1), stream)
            _build.check(err, "ecamp_fused_ce_bwd_dx_chunk")
            launches_dx.add()
            err = lib.ecamp_fused_ce_bwd_dw_chunk(
                dl.data_ptr(), x.data_ptr(), partials.data_ptr(),
                dw.data_ptr(), db.data_ptr(), n, v, d, v0, width, ld, stream)
            _build.check(err, "ecamp_fused_ce_bwd_dw_chunk")
            launches_dw.add()
    return dx, dw, db


def wgmma_gemm(a, b, layout: int):
    """The tensor-core backward's GEMM mainloop alone, for the card tests:
    C = A B in fp32 from bf16 operands as the three kernels lay them out.
    layout 0: a (M, K), b (N, K), both K-major, C = a b^T (the dl product);
    1: a (M, K) K-major, b (K, N) N-major, C = a b (dx); 2: a (K, M) and b
    (K, N), both MN-major, C = a^T b (dW). Contiguous, 16-byte aligned, K
    and the contiguous extents multiples of 8."""
    if layout == 0:
        (m, k), n = a.shape, b.shape[0]
    elif layout == 1:
        (m, k), n = a.shape, b.shape[1]
    else:
        (k, m), n = a.shape, b.shape[1]
    c = torch.empty(m, n, dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _build.library().ecamp_wgmma_gemm(
            a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, layout, stream)
    _build.check(err, "ecamp_wgmma_gemm")
    return c


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
