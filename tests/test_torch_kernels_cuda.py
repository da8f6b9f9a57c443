"""The port's CUDA kernels against their plain PyTorch versions
on an NVIDIA card. Every test here needs the card (marker `cuda`) and skips
without one. The file imports only torch and the port, so it runs on a
machine without JAX:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ecamp_tpu_torch.kernels import flash_attention as fa_mod  # noqa: E402
from ecamp_tpu_torch.kernels import fused_adamw as adamw_mod  # noqa: E402
from ecamp_tpu_torch.kernels import fused_mlm_loss as mlm_mod  # noqa: E402
from ecamp_tpu_torch.kernels import int8_linear as i8_mod  # noqa: E402
from ecamp_tpu_torch.kernels import layer_norm as ln_mod  # noqa: E402
from ecamp_tpu_torch.kernels import sr_head as sr_mod  # noqa: E402

FP32_TOL = 1e-5
BF16_TOL = 1.6e-2  # about one bf16 ulp of the output, atol and rtol

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels are built and run "
                    "only on the card)")
    return torch.device("cuda")


def _close(got, want, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=FP32_TOL, rtol=0)
    else:
        torch.testing.assert_close(got.float(), want.float(), atol=BF16_TOL,
                                   rtol=BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,d,eps", [(8 * 197, 768, 1e-6),
                                        (37, 512, 1e-12), (5, 100, 1e-6),
                                        (1, 768, 1e-12), (1003, 512, 1e-6),
                                        (3, 2048, 1e-6), (9, 1024, 1e-6)])
def test_layer_norm_kernel_on_card(cuda, dtype, rows, d, eps):
    dtype = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(0)
    x = (torch.randn(rows, d, device=cuda, generator=g) * 2 + 0.5).to(dtype)
    w = 1 + 0.1 * torch.randn(d, device=cuda, generator=g)
    b = 0.1 * torch.randn(d, device=cuda, generator=g)
    before = ln_mod.launches.value
    got = ln_mod.fused_layer_norm(x, w, b, eps)
    torch.cuda.synchronize()
    assert ln_mod.launches.value == before + 1
    assert got.dtype == dtype
    _close(got, ln_mod._ln_reference(x, w, b, eps), dtype)


def _bias(kind, b, h, nq, nk, g, dev):
    if kind == "none":
        return None
    if kind == "blank_tile":  # finfo.min over the whole first 64-key tile
        keep = torch.arange(nk, device=dev) >= min(64, nk // 2)
        return torch.where(keep, 0.0, torch.finfo(torch.float32).min
                           ).reshape(1, 1, 1, nk).expand(b, 1, 1, nk)
    if kind == "key_padding":
        keep = torch.arange(nk, device=dev)[None, :] < torch.randint(
            nk // 2, nk + 1, (b, 1), device=dev, generator=g)
        return torch.where(keep, 0.0, torch.finfo(torch.float32).min
                           ).reshape(b, 1, 1, nk)
    return torch.randn(b, h, nq, nk, device=dev, generator=g)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias_kind", ["none", "key_padding", "full",
                                       "blank_tile"])
@pytest.mark.parametrize("b,h,nq,nk,d", [(4, 12, 197, 197, 64),
                                         (2, 3, 70, 29, 32),
                                         (2, 2, 130, 257, 128),
                                         (2, 12, 50, 50, 64),
                                         (2, 6, 256, 49, 128),
                                         (3, 2, 1, 5, 64)])
def test_attention_kernel_on_card(cuda, dtype, bias_kind, b, h, nq, nk, d):
    """bf16 runs the tensor-core kernel, fp32 the FMA one: ragged Nq (not a
    multiple of 16) and Nk (not a multiple of 64), the encoder and cross
    shapes, and a mask that blanks a whole key tile."""
    dtype = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(b, h, nq, d, device=cuda, generator=g).to(dtype)
    k, v = (torch.randn(b, h, nk, d, device=cuda, generator=g).to(dtype)
            for _ in range(2))
    bias = _bias(bias_kind, b, h, nq, nk, g, cuda)
    before = fa_mod.launches.value
    got = fa_mod.flash_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert fa_mod.launches.value == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (b, h, nq, d)
    _close(got, fa_mod._attention_reference(q, k, v, bias), dtype)


@pytest.mark.parametrize("bias_kind", ["none", "key_padding", "full"])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_attention_kernel_reads_no_row_of_the_next_head(cuda, bias_kind, d):
    """bf16 (the TMA + wgmma kernel) at Nq = Nk = 70, so the last key tile
    holds 6 keys and the last query tile 6 rows: every odd batch*head's K
    and V are NaN. A key tile read past an even head's Nk into the next
    head's rows would put NaN into the even head's output (a masked P of 0
    times NaN); the kernel's boxes stop at each head's Nk, and the even
    heads match the plain version."""
    g = torch.Generator(device=cuda).manual_seed(8)
    b, h, n = 2, 4, 70
    q, k, v = (torch.randn(b, h, n, d, device=cuda, generator=g).bfloat16()
               for _ in range(3))
    k[:, 1::2] = float("nan")
    v[:, 1::2] = float("nan")
    bias = _bias(bias_kind, b, h, n, n, g, cuda)
    got = fa_mod.flash_attention(q, k, v, bias)
    torch.cuda.synchronize()
    even = None if bias is None or bias.shape[1] == 1 else bias[:, ::2]
    want = fa_mod._attention_reference(q[:, ::2], k[:, ::2], v[:, ::2],
                                       bias if even is None else even)
    assert bool(torch.isfinite(got[:, ::2]).all())
    _close(got[:, ::2], want, torch.bfloat16)


def test_attention_kernel_on_card_unaligned_bf16(cuda):
    """bf16 q, k, v, o whose addresses are not 16-byte aligned take the FMA
    kernel and match the plain version as the tensor-core path does."""
    g = torch.Generator(device=cuda).manual_seed(6)
    shape = (2, 3, 77, 64)

    def unaligned():  # a contiguous view one element into its buffer
        t = torch.randn(1 + 2 * 3 * 77 * 64, device=cuda, generator=g)
        return t.to(torch.bfloat16)[1:].view(shape)

    q, k, v = unaligned(), unaligned(), unaligned()
    assert q.data_ptr() % 16 != 0
    got = fa_mod.flash_attention(q, k, v)
    _close(got, fa_mod._attention_reference(q, k, v), torch.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_outputs_carry_grad_fn_and_right_gradients(cuda, dtype):
    """Inputs that require grad give kernel outputs with a grad_fn, and the
    gradients through the kernels equal autograd through the plain
    versions (a detached output would leave every .grad None)."""
    dtype = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(2)

    def leaf(*shape, scale=1.0, dt=dtype):
        return (scale * torch.randn(*shape, device=cuda, generator=g)).to(
            dt).requires_grad_()

    x, w, b = leaf(64, 50, 768), leaf(768, dt=torch.float32), leaf(
        768, scale=0.1, dt=torch.float32)
    q, k, v = leaf(4, 6, 256, 128), leaf(4, 6, 49, 128), leaf(4, 6, 49, 128)
    bias = leaf(4, 6, 256, 49, dt=torch.float32)
    gy = torch.randn(64, 50, 768, device=cuda, generator=g).to(dtype)
    go = torch.randn(4, 6, 256, 128, device=cuda, generator=g).to(dtype)

    def grads(ln_fn, attn_fn):
        for t in (x, w, b, q, k, v, bias):
            t.grad = None
        y = ln_fn(x, w, b, 1e-6)
        o = attn_fn(q, k, v, bias)
        torch.autograd.backward([y, o], [gy, go])
        return y, o, [t.grad for t in (x, w, b, q, k, v, bias)]

    ln0, fa0 = ln_mod.launches.value, fa_mod.launches.value
    y, o, got = grads(ln_mod.fused_layer_norm, fa_mod.flash_attention)
    torch.cuda.synchronize()
    assert ln_mod.launches.value == ln0 + 1
    assert fa_mod.launches.value == fa0 + 1
    assert y.grad_fn is not None and o.grad_fn is not None
    _, _, want = grads(ln_mod._ln_reference, fa_mod._attention_reference)
    for name, a, e in zip(("dx", "dw", "db", "dq", "dk", "dv", "dbias"),
                          got, want):
        assert a is not None, name
        assert a.dtype == e.dtype, name
        # the same backward math on both sides; the forward outputs it
        # starts from agree to the kernels' tolerance
        scale = float(e.float().abs().max())
        tol = 1e-5 if dtype == torch.float32 else BF16_TOL
        torch.testing.assert_close(a.float(), e.float(), rtol=tol,
                                   atol=tol * scale, msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,offset", [
    ((2, 3, 448, 448), 0), ((1, 3, 37, 70), 0), ((3, 3, 16, 64), 0),
    ((2, 3, 33, 136), 0),  # ragged last row and column tiles (TMA kernel)
    ((1, 3, 8, 8), 0),     # an image smaller than a tile (TMA kernel)
    ((2, 3, 33, 129), 0),  # rows not a multiple of 16 bytes (generic)
    ((2, 3, 33, 136), 1),  # data one element past 16 bytes (generic)
])
def test_sr_kernel_on_card(cuda, dtype, shape, offset):
    """The SR kernel against the plain direct convs (TF32 off), forward
    and, through `_SRConvStackFn`, backward, on the kernel `sr_path`
    picks."""
    torch.backends.cudnn.allow_tf32 = False
    dtype = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(3)
    n = torch.Size(shape).numel()
    x = torch.randn(n + 1, device=cuda, generator=g).to(dtype)
    x = x[offset:offset + n].view(shape)
    tma = sr_mod.sr_path(x) == "tma"
    assert tma == (offset == 0 and shape[-1] * x.element_size() % 16 == 0)
    before_tma = sr_mod.launches_tma.value
    w1, w2 = (0.2 * torch.randn(3, 3, 3, 3, device=cuda, generator=g)
              for _ in range(2))
    b1, b2 = (0.1 * torch.randn(3, device=cuda, generator=g)
              for _ in range(2))
    before = sr_mod.launches.value
    got = sr_mod.sr_conv_stack(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert sr_mod.launches.value == before + 1
    assert sr_mod.launches_tma.value == before_tma + tma
    assert got.dtype == dtype and got.shape == x.shape
    if dtype == torch.float32:
        _close(got, sr_mod._sr_reference(x, w1, b1, w2, b2), dtype)
    else:  # the kernel keeps conv1's output in fp32; the plain convs round
        _close(got, sr_mod._sr_reference(x.float(), w1, b1, w2, b2).to(
            dtype), dtype)
    ins = [t.clone().requires_grad_() for t in (x, w1, b1, w2, b2)]
    out = sr_mod.sr_conv_stack(*ins)
    assert out.grad_fn is not None
    gout = torch.randn(*shape, device=cuda, generator=g).to(dtype)
    out.backward(gout)
    ref = [t.detach().clone().requires_grad_() for t in (x, w1, b1, w2, b2)]
    sr_mod._sr_reference(*ref).backward(gout)
    for a, r in zip(ins, ref):
        # the backward is the plain recompute; a weight gradient sums
        # N*H*W products and cuDNN picks its summation order per call, so
        # the two agree to fp32 rounding relative to the gradient's scale
        scale = float(r.grad.abs().max())
        torch.testing.assert_close(a.grad, r.grad, rtol=1e-4,
                                   atol=1e-5 * scale)


def test_adamw_kernel_on_card(cuda):
    """One launch updates leaves of every kind (ragged, aligned, one whose
    addresses are not 16-byte aligned) as the per-leaf formula does, with
    the clip active, in place."""
    g = torch.Generator(device=cuda).manual_seed(4)
    shapes = [(768, 3072), (30000, 768 // 16), (3,), (1, 1, 768), (7, 13)]

    def tensors(scale=1.0, positive=False):
        out = [scale * torch.randn(s, device=cuda, generator=g)
               for s in shapes]
        # a leaf at an odd offset inside a larger buffer: not 16-byte aligned
        base = scale * torch.randn(1001, device=cuda, generator=g)
        out.append(base[1:])
        return [t.abs() if positive else t for t in out]

    ps, gs = tensors(), tensors()
    ms, vs = tensors(0.1), tensors(0.01, positive=True)
    params = {str(i): p for i, p in enumerate(ps)}
    grads = {str(i): t for i, t in enumerate(gs)}
    tx = adamw_mod.FusedAdamW(lambda c: 1e-3 * (1 + c.float()), 0.9, 0.95,
                              1e-8, 0.05,
                              mask_fn=lambda p: {k: v.ndim > 1
                                                 for k, v in p.items()},
                              grad_clip=1.0)
    count = torch.full((), 2, dtype=torch.int32, device=cuda)

    def state(m, v):
        return adamw_mod.AdamWState(
            count=count, mu={k: t.clone() for k, t in zip(params, m)},
            nu={k: t.clone() for k, t in zip(params, v)})

    k_params = {k: p.clone() for k, p in params.items()}
    k_params["5"] = ps[5]._base.clone()[1:]  # keep the odd offset
    k_state = state(ms, vs)
    ptr = k_params["0"].data_ptr()
    before = adamw_mod.launches.value
    new = tx.apply(k_params, grads, k_state)
    torch.cuda.synchronize()
    assert adamw_mod.launches.value == before + 1
    assert int(new.count) == 3 and k_params["0"].data_ptr() == ptr
    tx.plain = True
    p_params = {k: p.clone() for k, p in params.items()}
    p_state = state(ms, vs)
    tx.apply(p_params, grads, p_state)
    for k in params:
        # the kernel rounds every op as the per-leaf formula does
        torch.testing.assert_close(k_params[k], p_params[k], rtol=1e-6,
                                   atol=1e-7)
        torch.testing.assert_close(k_state.mu[k], p_state.mu[k], rtol=1e-6,
                                   atol=1e-7)
        torch.testing.assert_close(k_state.nu[k], p_state.nu[k], rtol=1e-6,
                                   atol=1e-9)


@pytest.mark.parametrize("fused", [False, True], ids=["logits", "fused_ce"])
def test_pretrain_step_on_card_matches_plain(cuda, fused):
    """A tiny PretrainTask step launches every kernel the step has and
    matches the same step through the plain versions; with `fused_mlm_ce`
    the MLM loss goes through the fused-CE kernels, once each."""
    from ecamp_tpu_torch.core import config as c
    from ecamp_tpu_torch.train.pretrain import PretrainTask

    cfg = c.PretrainConfig(
        vit=c.ViTConfig(img_size=64, patch_size=16, embed_dim=128, depth=2,
                        num_heads=2),
        decoder=c.MAEDecoderConfig(embed_dim=64, depth=1, num_heads=2),
        bert=c.BertConfig(vocab_size=300, hidden_size=256,
                          num_hidden_layers=2, num_attention_heads=2,
                          intermediate_size=512, max_position_embeddings=32),
        optimizer=c.OptimizerConfig(schedule="constant", lr=1e-3),
        data=c.DataConfig(img_size=128), max_caption_length=32, sr_window=2,
        fused_mlm_ce=fused)
    task = PretrainTask(cfg, device=cuda)
    init = {k: v.clone() for k, v in task.model.state_dict().items()}
    batch = task.fake_batch(4)
    batch["image"] = torch.randn(4, 128, 128, 3, device=cuda)
    batch["ids"] = torch.randint(0, 300, (4, 32), device=cuda)
    batch["labels"] = batch["ids"]
    batch["attention_mask"][:, 20:] = 0
    noise = torch.rand(4, 16, device=cuda)
    losses = {}
    counters = (ln_mod.launches, fa_mod.launches, sr_mod.launches,
                adamw_mod.launches, mlm_mod.launches_fwd,
                mlm_mod.launches_merge, mlm_mod.launches_dl,
                mlm_mod.launches_dx, mlm_mod.launches_dw)
    for plain in (False, True):
        task.model.load_state_dict(init)
        task.set_plain(plain)
        state = task.init_state()
        for ctr in counters:
            ctr.reset()
        state, m = task.train_step(state, batch, noise=noise,
                                   deterministic=True)
        torch.cuda.synchronize()
        n = [ctr.value for ctr in counters]
        # LayerNorm: encoder 2*2 + 1, decoder 2 + 1, BERT embeddings 1 +
        # fusion 3 + layers 2*2 + MLM head 1; attention: encoder 2,
        # decoder 1, fusion self + cross 2, layers 2; the fused CE's bf16
        # forward (tiles, merge) and backward in one vocab chunk (dl, dx,
        # dW)
        assert n == ([0] * 9 if plain else [5 + 3 + 9, 2 + 1 + 2 + 2, 1, 1]
                     + [int(fused)] * 5)
        losses[plain] = {k: float(v) for k, v in m.items()}
    for k in ("mim_loss", "res_loss", "mlm_loss"):
        assert abs(losses[False][k] - losses[True][k]) <= 2e-2 * abs(
            losses[True][k]), k


@pytest.mark.parametrize("layout", [0, 1, 2], ids=["dl", "dx", "dw"])
@pytest.mark.parametrize("m,n,k", [(200, 136, 72), (1000, 776, 520),
                                   (8, 8, 8), (264, 200, 4104)])
def test_wgmma_gemm_on_card(cuda, layout, m, n, k):
    """The tensor-core backward's TMA + wgmma mainloop alone, in each of
    its three operand layouts, at ragged shapes (edges past the 128-row,
    128/192-column and 64-deep tiles), against `torch.matmul` of the same
    bf16 values in fp32 (TF32 off): both sum exact bf16 products in fp32,
    in other orders."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(7)
    a = torch.randn(m, k, device=cuda, generator=g).bfloat16()
    b = torch.randn(k, n, device=cuda, generator=g).bfloat16()
    want = a.float() @ b.float()
    if layout == 0:
        got = mlm_mod.wgmma_gemm(a, b.T.contiguous(), 0)
    elif layout == 1:
        got = mlm_mod.wgmma_gemm(a, b, 1)
    else:
        got = mlm_mod.wgmma_gemm(a.T.contiguous(), b, 2)
    torch.cuda.synchronize()
    assert got.shape == (m, n) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))


def _fused_ce_inputs(cuda, n, d, v, dtype, seed=5):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = (0.5 * torch.randn(n, d, device=cuda, generator=g)).to(dtype)
    w = (0.1 * torch.randn(v, d, device=cuda, generator=g)).to(dtype)
    b = 0.1 * torch.randn(v, device=cuda, generator=g)
    labels = torch.randint(0, v, (n,), device=cuda, generator=g)
    weights = torch.rand(n, device=cuda, generator=g)
    return x, w, b, labels, weights


def _close_scaled(got, want, tol):
    scale = float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol * scale)


def _lib(name, *args):
    with torch.cuda.device(args[0].device):
        err = getattr(mlm_mod._build.library(), name)(
            *(a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args), torch.cuda.current_stream().cuda_stream)
    assert err == 0, name


@pytest.mark.parametrize("n,d,v", [(1000, 96, 3001), (129, 40, 257),
                                   (70, 768, 300)])
def test_fused_ce_forward_kernels_on_card(cuda, n, d, v):
    """The tensor-core forward's two kernels, each alone against its plain
    version on the same inputs, at N not a multiple of 128: the tile
    kernel's (max, sum-exp) of every 128-wide vocab tile (V = 3001: the
    last tile is 57 wide and holds a label) and the gold logits of the rows
    whose label is in range (the others untouched); then the merge, fed the
    plain stats, with labels out of range (gold 0); then both through the
    wrapper, two launches. fp32 math on bf16 inputs: 1e-5 of each output's
    scale."""
    x, w, b, labels, _ = _fused_ce_inputs(cuda, n, d, v, torch.bfloat16)
    labels[0] = v - 1   # in the last, ragged tile
    labels[1] = v + 7   # out of range
    labels[2] = -100
    inside = (labels >= 0) & (labels < v)
    tiles = -(-v // mlm_mod.TILE_V)
    want_stats, want_gold = mlm_mod._fwd_tiles_plain(x, w, b, labels)
    stats = torch.empty(tiles, n, 2, device=cuda)
    gold = torch.full((n,), 123.0, device=cuda)
    _lib("ecamp_fused_ce_fwd_tiles", x, w, b, labels, stats, gold, n, v, d,
         tiles)
    torch.cuda.synchronize()
    assert want_stats.shape == stats.shape
    _close_scaled(stats[..., 0], want_stats[..., 0], FP32_TOL)
    _close_scaled(stats[..., 1], want_stats[..., 1], FP32_TOL)
    _close_scaled(gold[inside], want_gold[inside], FP32_TOL)
    assert bool((gold[~inside] == 123.0).all())

    lse = torch.empty(n, device=cuda)
    want_lse, want_gold = mlm_mod._fwd_merge_plain(want_stats, labels,
                                                   gold.clone(), v)
    _lib("ecamp_fused_ce_fwd_merge", want_stats, labels, lse, gold, n, v,
         tiles)
    torch.cuda.synchronize()
    _close_scaled(lse, want_lse, FP32_TOL)
    assert torch.equal(gold, want_gold)
    assert bool((gold[~inside] == 0).all())

    counters = (mlm_mod.launches_fwd, mlm_mod.launches_merge)
    before = [c.value for c in counters]
    lse, gold = mlm_mod._forward_cuda(x, w, b, labels)
    want_lse, want_gold = mlm_mod._forward_tiled_plain(x, w, b, labels)
    torch.cuda.synchronize()
    assert [c.value - v0 for c, v0 in zip(counters, before)] == [1, 1]
    _close_scaled(lse, want_lse, FP32_TOL)
    _close_scaled(gold, want_gold, FP32_TOL)
    with pytest.raises(RuntimeError, match="ecamp_fused_ce_fwd_tiles"):
        mlm_mod._build.check(mlm_mod._build.library().ecamp_fused_ce_fwd_tiles(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), labels.data_ptr(),
            stats.data_ptr(), gold.data_ptr(), n, v, d, tiles + 1,
            torch.cuda.current_stream().cuda_stream),
            "ecamp_fused_ce_fwd_tiles")


@pytest.mark.parametrize("n,d,v,chunk", [(1000, 96, 3001, 1024),
                                         (70, 768, 300, 128),
                                         (129, 40, 257, 64),
                                         (300, 768, 9000, 4096)])
def test_fused_ce_chunk_kernels_on_card(cuda, n, d, v, chunk, monkeypatch):
    """The three tensor-core backward kernels, each against its plain
    version on the same inputs (bf16: atol = rtol = 1.6e-2 of the output's
    scale), over vocab chunks with a ragged last chunk and a label in every
    chunk: dl' and the partial column sums of the first chunk, then the
    whole chunked backward (dx, dW, db), 3 launches a chunk."""
    monkeypatch.setattr(mlm_mod, "CHUNK_V", chunk)
    x, w, b, labels, weights = _fused_ce_inputs(cuda, n, d, v, torch.bfloat16)
    chunks = mlm_mod._chunks(v, chunk)
    assert len(chunks) > 1 and chunks[-1][1] < chunk
    for i, (v0, width) in enumerate(chunks):
        labels[i] = v0 + width - 1
    lse, _ = mlm_mod._forward_plain(x, w, b, labels)
    wg = 0.3 * weights
    assert mlm_mod._tensor_core_path(x, w)

    # the dl kernel alone on the first chunk
    width = chunks[0][1]
    dl = torch.empty(n, width, dtype=x.dtype, device=cuda)
    partials = torch.empty(-(-n // mlm_mod.TILE_M), width, device=cuda)
    lab = labels.contiguous()
    with torch.cuda.device(cuda):
        err = mlm_mod._build.library().ecamp_fused_ce_bwd_dl(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), lab.data_ptr(),
            lse.data_ptr(), wg.data_ptr(), dl.data_ptr(), partials.data_ptr(),
            n, v, d, 0, width, width,
            torch.cuda.current_stream(cuda).cuda_stream)
    assert err == 0
    want_dl, want_partials = mlm_mod._dl_chunk_plain(x, w, b, labels, lse,
                                                     wg, 0, width)
    torch.cuda.synchronize()
    _close_scaled(dl, want_dl, BF16_TOL)
    _close_scaled(partials, want_partials, BF16_TOL)

    counters = (mlm_mod.launches_dl, mlm_mod.launches_dx,
                mlm_mod.launches_dw)
    before = [c.value for c in counters]
    got = mlm_mod._backward_cuda(x, w, b, labels, lse, wg)
    want = mlm_mod._backward_chunked_plain(x, w, b, labels, lse, wg)
    torch.cuda.synchronize()
    assert [c.value - v0 for c, v0 in zip(counters, before)] == \
        [len(chunks)] * 3
    for a, e in zip(got, want):
        assert a.dtype == e.dtype and a.shape == e.shape
        _close_scaled(a, e, BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,v", [(1000, 96, 3001), (70, 768, 300),
                                   (129, 40, 257), (33, 36, 100),
                                   (300, 64, 9000)])
def test_fused_ce_kernels_on_card(cuda, dtype, n, d, v):
    """The fused-CE kernels against their plain versions on the same
    inputs (the plain math in fp32 on the bf16 inputs): lse and gold, then
    dx, dW and db from the same lse and wg, then the autograd Function,
    whose loss carries a grad_fn. bf16 at D % 8 == 0 runs the tensor-core
    forward (tiles, merge) and backward (dl, dx, dW a vocab chunk; V = 9000
    is three chunks), fp32 and D = 36 the FMA ones (fwd; dx, dW)."""
    dtype = getattr(torch, dtype)
    x, w, b, labels, weights = _fused_ce_inputs(cuda, n, d, v, dtype)
    tol = FP32_TOL if dtype == torch.float32 else BF16_TOL

    def close(got, want):
        _close_scaled(got, want, tol)

    tensor_cores = mlm_mod._tensor_core_path(x, w)
    assert tensor_cores == (dtype == torch.bfloat16 and d % 8 == 0)
    chunks = len(mlm_mod._chunks(v, mlm_mod.CHUNK_V)) if tensor_cores else 0
    # fwd, merge, dl, dx, dW
    per_call = [1, int(tensor_cores), chunks] + [chunks or 1] * 2
    counters = (mlm_mod.launches_fwd, mlm_mod.launches_merge,
                mlm_mod.launches_dl, mlm_mod.launches_dx, mlm_mod.launches_dw)
    before = [c.value for c in counters]
    lse, gold = mlm_mod._forward_cuda(x, w, b, labels)
    want_lse, want_gold = mlm_mod._forward_plain(x, w, b, labels)
    close(lse, want_lse)
    close(gold, want_gold)
    wg = 0.3 * weights
    got = mlm_mod._backward_cuda(x, w, b, labels, want_lse, wg)
    want = mlm_mod._fused_backward_plain(x, w, b, labels, want_lse, wg)
    for a, e in zip(got, want):
        assert a.dtype == e.dtype and a.shape == e.shape
        close(a, e)
    torch.cuda.synchronize()
    assert [c.value - v0 for c, v0 in zip(counters, before)] == per_call

    def run(plain):
        leaves = [t.clone().requires_grad_() for t in (x, w, b)]
        loss = mlm_mod.fused_mlm_loss_sum(*leaves, labels.int(), weights,
                                          plain=plain)
        assert loss.grad_fn is not None
        loss.backward(torch.full((), 0.3, device=cuda))
        return loss.detach(), [t.grad for t in leaves]

    loss_k, grads_k = run(False)
    loss_p, grads_p = run(True)
    torch.cuda.synchronize()
    assert [c.value - v0 for c, v0 in zip(counters, before)] == [
        2 * k for k in per_call]
    assert abs(float(loss_k) - float(loss_p)) <= (
        1e-5 if dtype == torch.float32 else 1e-3) * abs(float(loss_p))
    for a, e in zip(grads_k, grads_p):
        assert a.dtype == e.dtype
        close(a, e)


def test_kernels_refuse_what_they_do_not_take(cuda):
    z = torch.zeros(2, 3, 5, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa_mod.flash_attention(z, z, z)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        ln_mod.fused_layer_norm(torch.zeros(4, 8, device=cuda).half(),
                                torch.ones(8, device=cuda),
                                torch.zeros(8, device=cuda))
    with pytest.raises(ValueError, match="D <= 768"):
        mlm_mod.fused_mlm_loss_sum(
            torch.zeros(4, 1024, device=cuda), torch.zeros(9, 1024, device=cuda),
            torch.zeros(9, device=cuda), torch.zeros(4, dtype=torch.long,
                                                     device=cuda),
            torch.ones(4, device=cuda))


def _int8_operands(m, n, k, dev, bias=True, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(m, k, device=dev, generator=g).to(torch.bfloat16)
    q = torch.randint(-127, 128, (n, k), device=dev, generator=g,
                      dtype=torch.int32).to(torch.int8)
    s = 0.02 * torch.rand(n, device=dev, generator=g) + 1e-3
    b = (torch.randn(n, device=dev, generator=g).to(torch.bfloat16)
         if bias else None)
    return x, q, s, b


@pytest.mark.parametrize("m,n,k", [(197, 2304, 768), (197, 768, 3072),
                                   (1576, 3072, 768), (12608, 768, 768),
                                   (37, 200, 64), (5, 7, 48), (1, 14, 16),
                                   (130, 129, 784)])
@pytest.mark.parametrize("bias", [True, False])
def test_int8_linear_kernel_on_card(cuda, m, n, k, bias):
    """The int8-weight linear kernel against its plain version (F.linear
    with the dequantised bf16 weight) run in fp32 on the same bf16 values
    and rounded once, the function the kernel computes: cuBLAS's bf16
    product can round partial sums to bf16 (split-K), a bf16 ulp of the
    pre-bias sum off at (130, 129, 784). Both tile shapes, ragged M and N,
    an odd N (scalar stores), K = 48 (a half stage), with and without
    bias; one launch a call; leading dims kept."""
    x, q, s, b = _int8_operands(m, n, k, cuda, bias)
    before = i8_mod.launches.value
    got = i8_mod.int8_linear(x.reshape(1, m, k), q, s, b)
    torch.cuda.synchronize()
    assert i8_mod.launches.value == before + 1
    assert got.shape == (1, m, n) and got.dtype == torch.bfloat16
    w = i8_mod.dequantize_int8(q, s, torch.bfloat16).float()
    want = torch.nn.functional.linear(
        x.float(), w, None if b is None else b.float()).to(torch.bfloat16)
    _close(got[0], want, torch.bfloat16)


def test_int8_linear_kernel_refuses_what_it_does_not_take(cuda):
    x, q, s, b = _int8_operands(8, 32, 64, cuda)
    with pytest.raises(ValueError, match="bf16 x"):
        i8_mod.int8_linear(x.float(), q, s, b)
    with pytest.raises(ValueError, match="multiple of 16"):
        i8_mod.int8_linear(x[:, :40], q[:, :40].contiguous(), s, b)
    with pytest.raises(ValueError, match="bias"):
        i8_mod.int8_linear(x, q, s, b.float())
    with pytest.raises(RuntimeError, match="no backward"):
        i8_mod.int8_linear(x.requires_grad_(), q, s, b)
    before = i8_mod.launches.value
    i8_mod.int8_linear(x.detach()[:, 16:], q[:, 16:].contiguous(), s, b)
    assert i8_mod.launches.value == before + 1  # a strided x is copied


def test_served_classifier_matches_plain_forward(cuda):
    """A tiny classifier engine on the card launches both kernels per
    bucket call and matches the model run through the plain versions."""
    from ecamp_tpu_torch.core import ViTConfig
    from ecamp_tpu_torch.nn import set_plain
    from ecamp_tpu_torch.serve import classifier_engine

    eng = classifier_engine(num_classes=3, img_size=32, buckets=(4,),
                            vit=ViTConfig(img_size=32, patch_size=8,
                                          embed_dim=64, depth=2, num_heads=2),
                            device=cuda)
    with torch.no_grad():  # spread the logits past the tiny head init
        eng.model.head.weight.copy_(0.3 * torch.randn(
            eng.model.head.weight.shape, generator=torch.Generator()
            .manual_seed(0)))
    x = np.random.default_rng(0).normal(size=(3, 32, 32, 3)).astype(
        np.float32)
    ln0, fa0 = ln_mod.launches.value, fa_mod.launches.value
    got = eng(x)
    assert ln_mod.launches.value - ln0 == 5 and fa_mod.launches.value - fa0 == 2
    set_plain(eng.model, True)
    with torch.inference_mode():
        logits = eng.model(torch.as_tensor(x, device=cuda).to(torch.bfloat16))
    want = torch.sigmoid(logits.float()).cpu().numpy()
    np.testing.assert_allclose(got, want, atol=2e-2)


@pytest.mark.parametrize("probe", [False, True], ids=["finetune", "probe"])
def test_classification_step_on_card_matches_plain(cuda, probe):
    """A width-768, depth-2 classifier step (bf16, drop-path 0.1, SGD with
    clip) through the kernels against the same step through the plain
    versions: LayerNorm 2 * 2 + 1 and attention 2 launches a step, loss
    within 2e-2 and grad norm within 5%; the linear probe's trunk records
    no graph (the kernels launch outside their autograd Functions) and
    keeps its weights bit for bit."""
    from ecamp_tpu_torch.core import config as c
    from ecamp_tpu_torch.train.classification import ClassificationTask

    cfg = c.ClassificationConfig(
        vit=c.ViTConfig(depth=2, drop_path_rate=0.1), linear_probe=probe,
        optimizer=c.OptimizerConfig(name="sgd", lr=3e-2, weight_decay=0.0,
                                    schedule="warmup_cosine_step",
                                    warmup_steps=0, total_steps=50,
                                    grad_clip=1.0))
    task = ClassificationTask(cfg, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    with torch.no_grad():  # spread the logits past the tiny head init
        task.model.head.weight.normal_(0.0, 0.05, generator=gen)
    init = {k: v.clone() for k, v in task.model.state_dict().items()}
    x = torch.randint(0, 256, (8, 224, 224, 1), dtype=torch.uint8,
                      device=cuda, generator=gen)
    y = (torch.rand(8, 14, device=cuda, generator=gen) < 0.3).float()
    out = {}
    for plain in (False, True):
        task.model.load_state_dict(init)
        task.set_plain(plain)
        state = task.init_state()
        ln_mod.launches.reset()
        fa_mod.launches.reset()
        state, m = task.train_step(state, x, y)
        torch.cuda.synchronize()
        assert (ln_mod.launches.value, fa_mod.launches.value) == (
            (0, 0) if plain else (5, 2))
        grads = [p.grad for p in task.model.parameters()
                 if p.grad is not None]
        if probe:
            assert len(grads) == 4  # fc_norm and head
        out[plain] = (float(m["loss"]), float(adamw_mod.global_norm(grads)))
        after = task.model.state_dict()
        for k, v in after.items():
            same = torch.equal(v, init[k])
            assert same == (probe and not k.startswith("head.")), k
    (lk, gk), (lp, gp) = out[False], out[True]
    assert abs(lk - lp) <= 2e-2 * abs(lp)
    assert abs(gk - gp) <= 5e-2 * gp


@pytest.mark.parametrize("dual", [False, True], ids=["siim", "riga"])
def test_segmentation_step_on_card_matches_plain(cuda, dual):
    """A width-768, depth-2 SegViT (SegViTDual for RIGA) step with the
    encoder frozen (bf16, masked AdamW with clip) through the kernels
    against the same step through the plain versions: LayerNorm 2 * 2,
    attention 2 and AdamW 1 launches a step, loss within 2e-2, grad norm
    within 5%, BatchNorm running statistics within 2e-2; the trunk keeps
    its weights bit for bit, the rest moves."""
    from ecamp_tpu_torch.core import config as c
    from ecamp_tpu_torch.train.segmentation import SegmentationTask

    cfg = c.SegmentationConfig(
        vit=c.ViTConfig(depth=2), task="RIGA" if dual else "SIIM",
        optimizer=c.OptimizerConfig(name="adamw", lr=5e-4, weight_decay=0.05,
                                    betas=(0.9, 0.999),
                                    schedule="warmup_cosine_step",
                                    warmup_steps=0, total_steps=50,
                                    grad_clip=1.0))
    task = SegmentationTask(cfg, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    init = {k: v.clone() for k, v in task.model.state_dict().items()}
    x = torch.randint(0, 256, (8, 224, 224, 1), dtype=torch.uint8,
                      device=cuda, generator=gen)
    y = (torch.rand(8, 224, 224, 2 if dual else 1, device=cuda,
                    generator=gen) < 0.2).float()
    out = {}
    for plain in (False, True):
        task.model.load_state_dict(init)
        task.set_plain(plain)
        state = task.init_state()
        for ctr in (ln_mod.launches, fa_mod.launches, adamw_mod.launches):
            ctr.reset()
        state, m = task.train_step(state, x, y)
        torch.cuda.synchronize()
        assert (ln_mod.launches.value, fa_mod.launches.value,
                adamw_mod.launches.value) == ((0, 0, 0) if plain
                                              else (4, 2, 1))
        mask = task.freeze_mask()
        grads = [p.grad for k, p in task.model.named_parameters() if mask[k]]
        stats = torch.cat([t.float().flatten() for k, t in
                           task.model.state_dict().items()
                           if "running_" in k])
        out[plain] = (float(m["loss"]), float(adamw_mod.global_norm(grads)),
                      stats)
        for k, v in task.model.state_dict().items():
            trunk = k.startswith("encoder.") and not k.startswith(
                "encoder.seg_head.")
            assert torch.equal(v, init[k]) == trunk, k
    (lk, gk, sk), (lp, gp, sp) = out[False], out[True]
    assert abs(lk - lp) <= 2e-2 * abs(lp)
    assert abs(gk - gp) <= 5e-2 * gp
    assert float((sk - sp).abs().max()) <= 2e-2 * max(1.0,
                                                      float(sp.abs().max()))


@pytest.mark.parametrize("expansion", [4, 8])
def test_detection_step_on_card_matches_plain(cuda, expansion):
    """A width-768, depth-2 ViT detector step (neck expansion 4 or 8, the
    YOLOv3 head at full width) with the encoder frozen (bf16, masked
    AdamW with clip, on a u8 batch with 1-3 boxes an image) through the
    kernels against the same step through the plain versions: LayerNorm
    2 * 2, attention 2 and AdamW 1 launches a step, loss within 2e-2,
    grad norm within 5%, BatchNorm running statistics within 2e-2; the
    trunk keeps its weights bit for bit, the rest moves; the eval step's
    decoded candidates (before the step) agree, the boxes within 2e-2 of
    their scale and objectness and class scores within 2e-2."""
    from ecamp_tpu_torch.core import config as c
    from ecamp_tpu_torch.train.detection import DetectionTask

    cfg = c.DetectionConfig(
        vit=c.ViTConfig(depth=2), expansion=expansion,
        optimizer=c.OptimizerConfig(name="adamw", lr=5e-4, weight_decay=0.05,
                                    betas=(0.9, 0.999),
                                    schedule="warmup_cosine_step",
                                    warmup_steps=0, total_steps=50,
                                    grad_clip=1.0))
    task = DetectionTask(cfg, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    init = {k: v.clone() for k, v in task.model.state_dict().items()}
    x = torch.randint(0, 256, (8, 224, 224, 1), dtype=torch.uint8,
                      device=cuda, generator=gen)
    y = torch.zeros(8, cfg.max_objects, 5, device=cuda)
    y[:, :3, 1:3] = 0.2 + 0.6 * torch.rand(8, 3, 2, device=cuda,
                                           generator=gen)
    y[:, :3, 3:] = 0.05 + 0.3 * torch.rand(8, 3, 2, device=cuda,
                                           generator=gen)
    y[::2, 1:] = 0  # 1 box on even images, 3 on odd ones
    out = {}
    for plain in (False, True):
        task.model.load_state_dict(init)
        task.set_plain(plain)
        state = task.init_state()
        decoded = task.eval_step(state, x[:4])
        for ctr in (ln_mod.launches, fa_mod.launches, adamw_mod.launches):
            ctr.reset()
        state, m = task.train_step(state, x, y)
        torch.cuda.synchronize()
        assert (ln_mod.launches.value, fa_mod.launches.value,
                adamw_mod.launches.value) == ((0, 0, 0) if plain
                                              else (4, 2, 1))
        mask = task.freeze_mask()
        grads = [p.grad for k, p in task.model.named_parameters() if mask[k]]
        stats = torch.cat([t.float().flatten() for k, t in
                           task.model.state_dict().items()
                           if "running_" in k])
        out[plain] = (float(m["loss"]), float(adamw_mod.global_norm(grads)),
                      stats, decoded)
        for k, v in task.model.state_dict().items():
            trunk = k.startswith("backbone.encoder.") and not k.startswith(
                "backbone.encoder.det_head.")
            assert torch.equal(v, init[k]) == trunk, k
    (lk, gk, sk, ek), (lp, gp, sp, ep) = out[False], out[True]
    assert np.isfinite(lk) and np.isfinite(gk)
    assert abs(lk - lp) <= 2e-2 * abs(lp)
    assert abs(gk - gp) <= 5e-2 * gp
    assert float((sk - sp).abs().max()) <= 2e-2 * max(1.0,
                                                      float(sp.abs().max()))
    assert ek.shape == (4, 3 * (7 * 7 + 14 * 14 + 28 * 28), 6)
    box_scale = max(1.0, float(ep[..., :4].abs().max()))
    assert float((ek[..., :4] - ep[..., :4]).abs().max()) <= 2e-2 * box_scale
    assert float((ek[..., 4:] - ep[..., 4:]).abs().max()) <= 2e-2
