"""The port's CUDA and Triton kernels against their plain PyTorch versions
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
                                        (37, 512, 1e-12), (5, 100, 1e-6)])
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
    if kind == "key_padding":
        keep = torch.arange(nk, device=dev)[None, :] < torch.randint(
            nk // 2, nk + 1, (b, 1), device=dev, generator=g)
        return torch.where(keep, 0.0, torch.finfo(torch.float32).min
                           ).reshape(b, 1, 1, nk)
    return torch.randn(b, h, nq, nk, device=dev, generator=g)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bias_kind", ["none", "key_padding", "full"])
@pytest.mark.parametrize("b,h,nq,nk,d", [(4, 12, 197, 197, 64),
                                         (2, 3, 70, 29, 32),
                                         (2, 2, 130, 257, 128)])
def test_attention_kernel_on_card(cuda, dtype, bias_kind, b, h, nq, nk, d):
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
@pytest.mark.parametrize("shape", [(2, 3, 448, 448), (1, 3, 37, 70),
                                   (3, 3, 16, 64)])
def test_sr_kernel_on_card(cuda, dtype, shape):
    """The SR kernel against the plain direct convs (TF32 off), forward
    and, through `_SRConvStackFn`, backward."""
    torch.backends.cudnn.allow_tf32 = False
    dtype = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(*shape, device=cuda, generator=g).to(dtype)
    w1, w2 = (0.2 * torch.randn(3, 3, 3, 3, device=cuda, generator=g)
              for _ in range(2))
    b1, b2 = (0.1 * torch.randn(3, device=cuda, generator=g)
              for _ in range(2))
    before = sr_mod.launches.value
    got = sr_mod.sr_conv_stack(x, w1, b1, w2, b2)
    torch.cuda.synchronize()
    assert sr_mod.launches.value == before + 1
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
                adamw_mod.launches, mlm_mod.launches_fwd, mlm_mod.launches_dx,
                mlm_mod.launches_dw)
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
        # decoder 1, fusion self + cross 2, layers 2
        assert n == ([0] * 7 if plain else [5 + 3 + 9, 2 + 1 + 2 + 2, 1, 1]
                     + [int(fused)] * 3)
        losses[plain] = {k: float(v) for k, v in m.items()}
    for k in ("mim_loss", "res_loss", "mlm_loss"):
        assert abs(losses[False][k] - losses[True][k]) <= 2e-2 * abs(
            losses[True][k]), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,v", [(1000, 96, 3001), (70, 768, 300),
                                   (129, 40, 257), (33, 36, 100)])
def test_fused_ce_kernels_on_card(cuda, dtype, n, d, v):
    """The three fused-CE kernels against their plain versions on the same
    inputs (the plain math in fp32 on the bf16 inputs): lse and gold, then
    dx, dW and db from the same lse and wg, then the autograd Function,
    whose loss carries a grad_fn and whose backward launches dx and dW.
    bf16 at D % 8 == 0 runs the tensor-core path, D = 36 the FMA one."""
    dtype = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(5)
    x = (0.5 * torch.randn(n, d, device=cuda, generator=g)).to(dtype)
    w = (0.1 * torch.randn(v, d, device=cuda, generator=g)).to(dtype)
    b = 0.1 * torch.randn(v, device=cuda, generator=g)
    labels = torch.randint(0, v, (n,), device=cuda, generator=g)
    weights = torch.rand(n, device=cuda, generator=g)
    tol = FP32_TOL if dtype == torch.float32 else BF16_TOL

    def close(got, want, scaled=True):
        scale = float(want.float().abs().max()) if scaled else 1.0
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol * scale)

    counters = (mlm_mod.launches_fwd, mlm_mod.launches_dx,
                mlm_mod.launches_dw)
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
    assert [c.value - v0 for c, v0 in zip(counters, before)] == [1, 1, 1]

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
    assert [c.value - v0 for c, v0 in zip(counters, before)] == [2, 2, 2]
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
