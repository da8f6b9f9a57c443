"""The port's kernels modules (ecamp_tpu_torch.kernels) against the JAX
package's Pallas kernels, run in Pallas interpret mode on the CPU, as
tests/test_sr_kernel.py runs them.

On the CPU the port's wrappers run their plain PyTorch versions (the
kernels' oracles on the card), so these tests pin the plain versions to the
TPU kernels' semantics; tests/test_torch_kernels_cuda.py holds the CUDA
kernels to the plain versions on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from ecamp_tpu.kernels import sr_head as jax_sr  # noqa: E402
from ecamp_tpu.kernels.flash_attention import _flash_attention_ad  # noqa: E402
from ecamp_tpu.kernels.fused_adamw import _leaf_update_pallas  # noqa: E402
from ecamp_tpu.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from ecamp_tpu.kernels.layer_norm import _ln_ad  # noqa: E402
from ecamp_tpu.kernels.layer_norm import fused_layer_norm as jax_ln  # noqa: E402
from ecamp_tpu_torch.kernels import (dot_product_attention,  # noqa: E402
                                     fused_layer_norm)
from ecamp_tpu_torch.kernels import flash_attention as fa_mod  # noqa: E402
from ecamp_tpu_torch.kernels import fused_adamw as adamw_mod  # noqa: E402
from ecamp_tpu_torch.kernels import sr_head as sr_mod  # noqa: E402
from ecamp_tpu_torch.kernels import layer_norm as ln_mod  # noqa: E402
from ecamp_tpu_torch.kernels.flash_attention import flash_attention  # noqa: E402

FP32_TOL = 1e-5


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


# -- LayerNorm -------------------------------------------------------------

@pytest.mark.parametrize("shape,eps", [((5, 7, 64), 1e-6), ((300, 768), 1e-12),
                                       ((3, 96), 1e-6)])
def test_layer_norm_matches_pallas_kernel(shape, eps):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.normal(size=shape[-1:])).astype(np.float32)
    b = (0.1 * rng.normal(size=shape[-1:])).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_ln(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b), eps, use_pallas=True))
    got = fused_layer_norm(_t(x), _t(w), _t(b), eps)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FP32_TOL)
    np.testing.assert_allclose(ln_mod._ln_reference(_t(x), _t(w), _t(b),
                                                    eps).numpy(),
                               want, rtol=0, atol=FP32_TOL)


def test_layer_norm_keeps_input_dtype():
    rng = np.random.default_rng(1)
    x = _t(rng.normal(size=(4, 32)), torch.bfloat16)
    w, b = torch.ones(32), torch.zeros(32)
    y = fused_layer_norm(x, w, b)
    assert y.dtype == torch.bfloat16
    want = ln_mod._ln_reference(x.float(), w, b, 1e-6)
    # one bf16 rounding of the fp32 result
    np.testing.assert_allclose(y.float().numpy(), want.numpy(),
                               rtol=8e-3, atol=8e-3)
    assert ln_mod.launches.value == 0  # CPU tensors never launch


def test_layer_norm_kernel_validation():
    with pytest.raises(ValueError, match="contiguous"):
        ln_mod._ln_cuda(torch.zeros(8, 4).t(), torch.ones(8),
                        torch.zeros(8), 1e-6)
    with pytest.raises(ValueError, match=r"weight/bias"):
        ln_mod._ln_cuda(torch.zeros(4, 8), torch.ones(7), torch.zeros(8),
                        1e-6)
    with pytest.raises(ValueError, match="d <="):
        ln_mod._ln_cuda(torch.zeros(1, ln_mod.MAX_D + 1),
                        torch.ones(ln_mod.MAX_D + 1),
                        torch.zeros(ln_mod.MAX_D + 1), 1e-6)


# -- attention -------------------------------------------------------------

def _qkv(rng, b, h, nq, nk, d):
    q = rng.normal(size=(b, h, nq, d)).astype(np.float32)
    k = rng.normal(size=(b, h, nk, d)).astype(np.float32)
    v = rng.normal(size=(b, h, nk, d)).astype(np.float32)
    return q, k, v


def _bias(rng, kind, b, h, nq, nk):
    if kind == "none":
        return None
    if kind == "key_padding":
        keep = np.arange(nk)[None, :] < rng.integers(nk // 2, nk + 1,
                                                     size=(b, 1))
        return np.where(keep, 0.0, np.finfo(np.float32).min).astype(
            np.float32).reshape(b, 1, 1, nk)
    return rng.normal(size=(b, h, nq, nk)).astype(np.float32)


@pytest.mark.parametrize("b,h,nq,nk,d", [(2, 3, 197, 197, 32),
                                         (1, 2, 13, 29, 64),
                                         (2, 1, 50, 7, 128)])
@pytest.mark.parametrize("bias_kind", ["none", "key_padding", "full"])
def test_attention_matches_pallas_kernel(b, h, nq, nk, d, bias_kind):
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, b, h, nq, nk, d)
    bias = _bias(rng, bias_kind, b, h, nq, nk)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_flash(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            None if bias is None else jnp.asarray(bias)))
    tb = None if bias is None else _t(bias)
    got = flash_attention(_t(q), _t(k), _t(v), tb)
    assert tuple(got.shape) == (b, h, nq, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FP32_TOL)
    # the dispatch sends every self-attention to flash_attention
    np.testing.assert_allclose(
        dot_product_attention(_t(q), _t(k), _t(v), tb).numpy(), want,
        rtol=0, atol=FP32_TOL)


def test_attention_return_probs():
    rng = np.random.default_rng(3)
    q, k, v = (_t(a) for a in _qkv(rng, 1, 2, 9, 11, 32))
    out, probs = dot_product_attention(q, k, v, return_probs=True)
    assert tuple(probs.shape) == (1, 2, 9, 11) and probs.dtype == torch.float32
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(out.numpy(), (probs @ v).numpy(), atol=1e-6)
    assert fa_mod.launches.value == 0  # CPU tensors never launch


def test_attention_bf16_plain_version_tracks_fp32():
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, 2, 2, 33, 33, 64)
    got = flash_attention(*(_t(a, torch.bfloat16) for a in (q, k, v)))
    want = flash_attention(*(_t(a) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               atol=3e-2, rtol=3e-2)


def test_attention_kernel_args():
    z = torch.zeros(2, 3, 5, 64)
    assert fa_mod._kernel_args(z, z, z, None) == (0, (0, 0, 0, 0))
    zb = z.to(torch.bfloat16)
    assert fa_mod._kernel_args(zb, zb, zb, None)[0] == 1
    kp = torch.zeros(2, 1, 1, 5)
    assert fa_mod._kernel_args(z, z, z, kp)[1] == (5, 0, 0, 1)
    full = torch.zeros(2, 3, 5, 5)
    assert fa_mod._kernel_args(z, z, z, full)[1] == (75, 25, 5, 1)
    kv = torch.zeros(2, 3, 9, 64)
    assert fa_mod._kernel_args(z, kv, kv, torch.zeros(2, 3, 5, 9))[1] == (
        135, 45, 9, 1)
    bad = [
        ((torch.zeros(2, 3, 5, 48),) * 3, None, "head dim"),
        ((z, z, z.to(torch.bfloat16)), None, "one dtype"),
        ((z.half(),) * 3, None, "fp32 or bf16"),
        ((z.transpose(2, 3).contiguous().transpose(2, 3), z, z), None,
         "contiguous"),
        ((z, kv, z), None, "shape mismatch"),
        ((z, z, z), torch.zeros(2, 3, 4, 5), "broadcast"),
        ((z, z, z), torch.zeros(2, 1, 1, 5, dtype=torch.float64), "fp32"),
        ((z[:, :, :0], z, z), None, "non-empty"),
    ]
    for (q, k, v), bias, msg in bad:
        with pytest.raises(ValueError, match=msg):
            fa_mod._kernel_args(q, k, v, bias)


# -- backward passes -------------------------------------------------------
# The JAX package differentiates its two Pallas kernels with custom VJPs
# whose backward recomputes through the reference formula in XLA. The
# port's backward functions are held to jax.vjp of those custom VJPs (the
# forward in interpret mode) and to torch autograd of the plain versions.

@pytest.mark.parametrize("shape,eps", [((5, 7, 64), 1e-6), ((40, 768), 1e-12)])
def test_layer_norm_backward_matches_jax_vjp(shape, eps):
    rng = np.random.default_rng(5)
    x = (rng.normal(size=shape) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.normal(size=shape[-1:])).astype(np.float32)
    b = (0.1 * rng.normal(size=shape[-1:])).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(lambda x_, w_, b_: _ln_ad(x_, w_, b_, eps),
                         jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
        want = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    got = ln_mod._ln_backward(_t(x), _t(w), eps, _t(g))
    assert [t.dtype for t in got] == [torch.float32] * 3
    # fp32 sums over up to 40 rows of O(1) terms: 1e-5 relative to scale
    for name, a, e in zip(("dx", "dweight", "dbias"), got, want):
        np.testing.assert_allclose(a.numpy(), e, rtol=1e-5,
                                   atol=1e-5 * np.abs(e).max(), err_msg=name)
    xt, wt, bt = (_t(a).requires_grad_() for a in (x, w, b))
    ln_mod._ln_reference(xt, wt, bt, eps).backward(_t(g))
    for name, a, e in zip(("dx", "dweight", "dbias"), got,
                          (xt.grad, wt.grad, bt.grad)):
        np.testing.assert_allclose(a.numpy(), e.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(e.abs().max()),
                                   err_msg=name)


def test_layer_norm_backward_bf16_dtypes():
    rng = np.random.default_rng(6)
    x = _t(rng.normal(size=(6, 32)), torch.bfloat16)
    g = _t(rng.normal(size=(6, 32)), torch.bfloat16)
    dx, dw, db = ln_mod._ln_backward(x, torch.ones(32), 1e-6, g)
    assert (dx.dtype, dw.dtype, db.dtype) == (torch.bfloat16, torch.float32,
                                              torch.float32)
    want = ln_mod._ln_backward(x.float(), torch.ones(32), 1e-6, g.float())[0]
    # one bf16 rounding of the fp32 gradient
    np.testing.assert_allclose(dx.float().numpy(), want.numpy(), rtol=8e-3,
                               atol=8e-3 * float(want.abs().max()))


@pytest.mark.parametrize("b,h,nq,nk,d", [(2, 3, 17, 17, 32),
                                         (2, 2, 13, 29, 64),
                                         (1, 2, 40, 7, 128)])
@pytest.mark.parametrize("bias_kind", ["none", "key_padding", "full"])
def test_attention_backward_matches_jax_vjp(b, h, nq, nk, d, bias_kind):
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, b, h, nq, nk, d)
    bias = _bias(rng, bias_kind, b, h, nq, nk)
    g = rng.normal(size=(b, h, nq, d)).astype(np.float32)
    scale = d ** -0.5
    jargs = [jnp.asarray(a) for a in (q, k, v)]
    with pltpu.force_tpu_interpret_mode():
        if bias is None:
            _, vjp = jax.vjp(lambda q_, k_, v_: _flash_attention_ad(
                q_, k_, v_, None, scale), *jargs)
        else:
            _, vjp = jax.vjp(lambda q_, k_, v_, b_: _flash_attention_ad(
                q_, k_, v_, b_, scale), *jargs, jnp.asarray(bias))
        want = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    tb = None if bias is None else _t(bias)
    got = fa_mod._attention_backward(_t(q), _t(k), _t(v), tb, scale, _t(g),
                                     bias_grad=bias is not None)
    names = ("dq", "dk", "dv", "dbias")
    for name, a, e in zip(names, got, want):
        # fp32 products of O(1) inputs: 1e-5 relative to the largest term
        np.testing.assert_allclose(a.numpy(), e, rtol=1e-5,
                                   atol=1e-5 * np.abs(e).max(), err_msg=name)
    if bias is not None:
        assert tuple(got[3].shape) == bias.shape
        # a bias that needs no gradient (the key-padding mask) gets none
        assert fa_mod._attention_backward(_t(q), _t(k), _t(v), tb, scale,
                                          _t(g))[3] is None
    # the same gradients from torch autograd of the plain version
    ts = [_t(a).requires_grad_() for a in (q, k, v)]
    tb = None if bias is None else _t(bias).requires_grad_(
        bias_kind == "full")
    fa_mod._attention_reference(*ts, tb, scale).backward(_t(g))
    for name, a, t in zip(names, got, ts + [tb]):
        if t is None or t.grad is None:
            continue
        np.testing.assert_allclose(a.numpy(), t.grad.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(t.grad.abs().max()),
                                   err_msg=name)


def test_autograd_functions_backward_equals_plain_autograd(monkeypatch):
    """`_LayerNormFn` and `_AttentionFn` (what a CUDA tensor goes through)
    with their kernel forwards swapped for the plain versions: the
    Functions' outputs carry a grad_fn and their backward gives the
    gradients of autograd through the plain versions, for every input
    that requires one."""
    monkeypatch.setattr(ln_mod, "_ln_cuda", ln_mod._ln_reference)
    monkeypatch.setattr(fa_mod, "_attention_cuda",
                        lambda q, k, v, bias, scale:
                        fa_mod._attention_reference(q, k, v, bias, scale))
    rng = np.random.default_rng(8)
    x, w, b = (rng.normal(size=s).astype(np.float32)
               for s in ((3, 5, 48), (48,), (48,)))
    q, k, v = _qkv(rng, 2, 2, 9, 12, 32)
    bias = _bias(rng, "full", 2, 2, 9, 12)
    gy = rng.normal(size=(3, 5, 48)).astype(np.float32)
    go = rng.normal(size=(2, 2, 9, 32)).astype(np.float32)

    def run(ln_fn, attn_fn):
        ins = [_t(a).requires_grad_() for a in (x, w, b, q, k, v, bias)]
        y = ln_fn(*ins[:3], 1e-6)
        o = attn_fn(*ins[3:], 32 ** -0.5)
        assert y.grad_fn is not None and o.grad_fn is not None
        torch.autograd.backward([y, o], [_t(gy), _t(go)])
        return [t.grad for t in ins]

    got = run(ln_mod._LayerNormFn.apply, fa_mod._AttentionFn.apply)
    want = run(ln_mod._ln_reference, fa_mod._attention_reference)
    for a, e in zip(got, want):
        np.testing.assert_allclose(a.numpy(), e.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(e.abs().max()))


# -- SR conv stack ---------------------------------------------------------

def _sr_weights(rng, scale=0.2):
    """HWIO weights for JAX, the same as OIHW for the port, and biases."""
    w1, w2 = (rng.normal(size=(3, 3, 3, 3)).astype(np.float32) * scale
              for _ in range(2))
    b1, b2 = (rng.normal(size=(3,)).astype(np.float32) * 0.1
              for _ in range(2))
    return (w1, b1, w2, b2), (_t(w1.transpose(3, 2, 0, 1)), _t(b1),
                              _t(w2.transpose(3, 2, 0, 1)), _t(b2))


@pytest.mark.parametrize("shape", [(2, 3, 32, 64), (1, 3, 24, 24),
                                   (1, 3, 70, 20), (1, 3, 33, 129),
                                   (1, 3, 8, 8)])
def test_sr_conv_stack_matches_pallas_kernel(shape):
    rng = np.random.default_rng(9)
    x = rng.normal(size=shape).astype(np.float32)
    jw, pw = _sr_weights(rng)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_sr._sr_conv_stack_impl(
            jnp.asarray(x), *(jnp.asarray(a) for a in jw)))
    got = sr_mod.sr_conv_stack(_t(x), *pw)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    # two 27-term fp32 sums of O(1) values
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert sr_mod.launches.value == 0  # CPU tensors never launch


def test_sr_backward_matches_jax_vjp(monkeypatch):
    """`_SRConvStackFn` (the CUDA route) with its kernel forward swapped
    for the plain version: gradients equal jax.vjp of the JAX custom VJP
    (Pallas forward in interpret mode, XLA-recompute backward)."""
    monkeypatch.setattr(sr_mod, "_sr_cuda", sr_mod._sr_reference)
    rng = np.random.default_rng(10)
    x = rng.normal(size=(1, 3, 16, 20)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    jw, pw = _sr_weights(rng)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(jax_sr.sr_conv_stack, jnp.asarray(x),
                         *(jnp.asarray(a) for a in jw))
        want = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    want[1] = want[1].transpose(3, 2, 0, 1)  # HWIO -> OIHW
    want[3] = want[3].transpose(3, 2, 0, 1)
    ins = [_t(x).requires_grad_()] + [t.clone().requires_grad_() for t in pw]
    out = sr_mod._SRConvStackFn.apply(*ins)
    assert out.grad_fn is not None
    out.backward(_t(g))
    for name, t, e in zip(("dx", "dw1", "db1", "dw2", "db2"), ins, want):
        np.testing.assert_allclose(t.grad.numpy(), e, rtol=1e-4,
                                   atol=1e-5 * np.abs(e).max(), err_msg=name)


@pytest.mark.parametrize("dtype,width,offset,path", [
    (torch.bfloat16, 448, 0, "tma"),      # the model's images
    (torch.bfloat16, 136, 0, "tma"),      # 272-byte rows
    (torch.bfloat16, 8, 0, "tma"),        # one 16-byte row
    (torch.bfloat16, 129, 0, "generic"),  # rows not a multiple of 16 bytes
    (torch.bfloat16, 132, 0, "generic"),
    (torch.bfloat16, 136, 1, "generic"),  # data 2 bytes past a boundary
    (torch.bfloat16, 136, 8, "tma"),      # 16 bytes past one
    (torch.float32, 132, 0, "tma"),
    (torch.float32, 130, 0, "generic"),
    (torch.float32, 136, 1, "generic"),   # 4 bytes past a boundary
    (torch.float32, 136, 4, "tma"),
])
def test_sr_path_picks_the_kernel_by_layout(dtype, width, offset, path):
    """`sr_path` on CPU tensors: the TMA kernel exactly where its tensor
    map takes x (16-byte aligned data, rows a multiple of 16 bytes)."""
    shape = (2, 3, 5, width)
    n = torch.Size(shape).numel()
    base = torch.zeros(n + 16, dtype=dtype)
    assert base.data_ptr() % 16 == 0
    x = base[offset:offset + n].view(shape)
    assert x.is_contiguous() and x.storage_offset() == offset
    assert sr_mod.sr_path(x) == path


def test_sr_kernel_validation():
    z = torch.zeros(3, 3, 3, 3)
    b = torch.zeros(3)
    with pytest.raises(ValueError, match=r"\(N, 3, H, W\)"):
        sr_mod._check(torch.zeros(1, 4, 8, 8), z, b, z, b)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        sr_mod._check(torch.zeros(1, 3, 8, 8).half(), z, b, z, b)
    with pytest.raises(ValueError, match="contiguous"):
        sr_mod._check(torch.zeros(1, 8, 8, 3).permute(0, 3, 1, 2), z, b, z, b)
    with pytest.raises(ValueError, match="OIHW"):
        sr_mod._check(torch.zeros(1, 3, 8, 8), torch.zeros(3, 3, 3, 2), b,
                      z, b)


# -- AdamW -----------------------------------------------------------------

@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("wd", [0.0, 0.05])
def test_adamw_leaf_update_matches_pallas_kernel(clip, wd):
    """The per-leaf plain update against `_leaf_update_pallas` in
    interpret mode, on a ragged leaf (not a multiple of 128), with the
    clip scalars active or not and weight decay on or off."""
    rng = np.random.default_rng(11)
    shape = (171, 133)
    g = rng.normal(size=shape).astype(np.float32)
    m = (rng.normal(size=shape) * 0.1).astype(np.float32)
    v = (np.abs(rng.normal(size=shape)) * 0.01).astype(np.float32)
    p = rng.normal(size=shape).astype(np.float32)
    b1, b2, eps = 0.9, 0.95, 1e-8
    scal = np.array([1e-3, 1 - b1 ** 3, 1 - b2 ** 3, 2.7 if clip else 1.0,
                     1.0], np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = _leaf_update_pallas(*(jnp.asarray(a) for a in (g, m, v, p)),
                                   jnp.asarray(scal), b1, b2, eps, wd)
    got = adamw_mod._leaf_update_plain(
        _t(g), _t(m), _t(v), _t(p), *(_t(s) for s in scal), b1, b2, eps, wd)
    for name, a, e in zip(("p", "m", "v"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


# -- build and launch bookkeeping ------------------------------------------

def test_launch_counter_counts_every_add_across_threads():
    import sys
    import threading

    from ecamp_tpu_torch.kernels._build import LaunchCounter

    counter = LaunchCounter()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [counter.add() for _ in range(2000)])
            for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert counter.value == 16 * 2000
    counter.reset()
    assert counter.value == 0


def test_build_reports_launch_errors_and_a_missing_nvcc():
    import os
    import shutil

    from ecamp_tpu_torch.kernels import _build

    _build.check(0, "ok")
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        _build.check(1, "launch")
    # the library's name changes with the sources and flags
    assert len(_build._digest()) == 16
    assert sorted(p.name for p in _build.CSRC.glob("*.cu")) == [
        "adamw.cu", "attention.cu", "fused_mlm_loss.cu", "layer_norm.cu",
        "sr_head.cu"]
    # every C entry point of the sources has its ctypes signature
    import re
    entries = {m for src in _build.CSRC.glob("*.cu")
               for m in re.findall(r'extern "C" int (\w+)\(',
                                   src.read_text())}
    assert entries == set(_build.SIGNATURES)
    lib_exists = any(_build.BUILD_DIR.glob(
        f"libecamp_kernels_{_build._digest()}.so"))
    if (shutil.which("nvcc") is None
            and not os.path.exists("/usr/local/cuda/bin/nvcc")
            and not lib_exists):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build()


def test_build_compiles_each_source_then_links(tmp_path, monkeypatch):
    """build() runs one `nvcc -c` per source, all started before any is
    waited on, then one link, and keeps every command's output in the log;
    a stand-in nvcc records its calls here, where there is no CUDA
    toolkit."""
    import stat

    from ecamp_tpu_torch.kernels import _build

    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo \"$@\" >> {calls}\n"
        "while [ $# -gt 0 ]; do\n"
        "  if [ \"$1\" = -o ]; then touch \"$2\"; fi; shift\n"
        "done\n"
        "echo 'ptxas info    : Used 32 registers'\n")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    lib = _build.build()
    assert lib.exists() and lib.name.startswith("libecamp_kernels_")
    lines = calls.read_text().splitlines()
    sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    assert len(lines) == len(sources) + 1
    assert sorted(line.split()[-1].rsplit("/", 1)[-1]
                  for line in lines[:-1]) == sources
    assert all(" -c " in line for line in lines[:-1])
    assert "-shared" in lines[-1] and " -c " not in lines[-1]
    log = lib.with_suffix(".log").read_text()
    assert log.count("Used 32 registers") == len(sources) + 1
    assert not list((tmp_path / "build").glob("*.o"))  # objects removed
    assert _build.build() == lib  # built once
    assert len(calls.read_text().splitlines()) == len(sources) + 1
