"""The port's kernels modules (ecamp_tpu_torch.kernels) against the JAX
package's Pallas kernels, run in Pallas interpret mode on the CPU, as
tests/test_sr_kernel.py runs them.

On the CPU the port's wrappers run their plain PyTorch versions (the
kernels' oracles on the card), so these tests pin the plain versions to the
TPU kernels' semantics; tests/test_torch_kernels_cuda.py holds the CUDA and
Triton kernels to the plain versions on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

torch = pytest.importorskip("torch")

from ecamp_tpu.kernels.flash_attention import flash_attention as jax_flash  # noqa: E402
from ecamp_tpu.kernels.layer_norm import fused_layer_norm as jax_ln  # noqa: E402
from ecamp_tpu_torch.kernels import (dot_product_attention,  # noqa: E402
                                     fused_layer_norm)
from ecamp_tpu_torch.kernels import flash_attention as fa_mod  # noqa: E402
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
        "attention.cu"]
    lib_exists = any(_build.BUILD_DIR.glob(
        f"libecamp_kernels_{_build._digest()}.so"))
    if (shutil.which("nvcc") is None
            and not os.path.exists("/usr/local/cuda/bin/nvcc")
            and not lib_exists):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.build()
