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
from ecamp_tpu_torch.kernels import layer_norm as ln_mod  # noqa: E402

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


def test_kernels_refuse_what_they_do_not_take(cuda):
    z = torch.zeros(2, 3, 5, 48, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa_mod.flash_attention(z, z, z)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        ln_mod.fused_layer_norm(torch.zeros(4, 8, device=cuda).half(),
                                torch.ones(8, device=cuda),
                                torch.zeros(8, device=cuda))


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
