"""The port's weight-only int8 serving (ecamp_tpu_torch.serve.quantize, the
int8 paths of nn/layers.py and kernels/int8_linear.py's plain version, and
`quantize="int8"` on the engines) against the JAX package's
`serve/quantize.py` and `*_engine(..., quantize="int8")`, on the CPU, at
tiny sizes (ViT img 32, dim 32-64, depth 2; the detector's neck and head
at their fixed widths), fp32.

Weights go JAX init -> `state_dict_from_flax` -> strict `load_state_dict`,
or a port model's `.pth` read by both packages' engines. The size floor
`min_elems` is 256 on both sides (the default 65536 picks nothing of a
tiny trunk); the detector is also served at the default floor, which its
full-width neck and head pass.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ecamp_tpu.core import config as jcfg  # noqa: E402
from ecamp_tpu.core.mesh import make_mesh  # noqa: E402
from ecamp_tpu.serve import quantize as jq  # noqa: E402
from ecamp_tpu_torch.ckpt import state_dict_from_flax  # noqa: E402
from ecamp_tpu_torch.ckpt.convert import _key, _value  # noqa: E402
from ecamp_tpu_torch.core import config as pcfg  # noqa: E402
from ecamp_tpu_torch.kernels import int8_linear as i8  # noqa: E402
from ecamp_tpu_torch.nn.layers import Conv2d, Dense, PatchProj  # noqa: E402
from ecamp_tpu_torch.serve import quantize as pq  # noqa: E402

IMG = 32
MIN_ELEMS = 256  # the JAX package's own test floor


def _vit(lib, dim=64, patch=8):
    return lib.ViTConfig(img_size=IMG, patch_size=patch, embed_dim=dim,
                         depth=2, num_heads=2)


def _ecamp_cfgs(lib):
    return (lib.ViTConfig(img_size=IMG, patch_size=16, embed_dim=64, depth=2,
                          num_heads=2),
            lib.MAEDecoderConfig(embed_dim=32, depth=1, num_heads=2),
            lib.BertConfig(vocab_size=128, hidden_size=64,
                           num_hidden_layers=2, num_attention_heads=2,
                           intermediate_size=128, max_position_embeddings=16))


def _models(kind):
    """(JAX module, its init args, port model) of one served family."""
    from ecamp_tpu import nn as jnn
    from ecamp_tpu_torch import nn as pnn
    from ecamp_tpu_torch.nn.mae import ECAMP

    x = jnp.zeros((2, IMG, IMG, 3))
    if kind == "classifier":
        return (jnn.ViTClassifier(_vit(jcfg), 3), (x,), {},
                pnn.ViTClassifier(_vit(pcfg), 3))
    if kind == "segmenter":
        return (jnn.SegViT(_vit(jcfg, 32, 16)), (x,), {"train": False},
                pnn.SegViT(_vit(pcfg, 32, 16)))
    if kind == "detector":
        return (jnn.DetectionModel(_vit(jcfg, 32, 16)), (x,),
                {"train": False}, pnn.DetectionModel(_vit(pcfg, 32, 16)))
    batch = {"image": jnp.zeros((2, 64, 64, 3)),
             "ids": jnp.zeros((2, 16), jnp.int32),
             "labels": jnp.zeros((2, 16), jnp.int32),
             "weights": jnp.ones((2, 16), jnp.float32),
             "column": jnp.zeros((2,), jnp.int32),
             "row": jnp.zeros((2,), jnp.int32)}
    return (jnn.ECAMP(*_ecamp_cfgs(jcfg)), (batch,),
            {"mask_ratio": 0.75, "deterministic": True},
            ECAMP(*_ecamp_cfgs(pcfg)))


def _init(kind):
    jm, args, kw, port = _models(kind)
    key = jax.random.PRNGKey(7)
    v = jax.jit(lambda r: jm.init({"params": r, "masking": r}, *args, **kw))(
        key)
    v = jax.tree_util.tree_map(np.asarray, v)
    port.load_state_dict(state_dict_from_flax(v["params"],
                                              v.get("batch_stats")),
                         strict=True)
    return v, port.eval()


def _get(tree, key):
    for part in key.split("/"):
        tree = tree[part]
    return np.asarray(tree)


@pytest.mark.parametrize("kind,floor", [
    ("classifier", MIN_ELEMS), ("segmenter", MIN_ELEMS),
    ("detector", MIN_ELEMS), ("ecamp", MIN_ELEMS), ("ecamp", 1)])
def test_quantized_set_q_and_scales_match_jax(kind, floor):
    """At the same floor the port quantizes exactly the weights whose flax
    `kernel` JAX's `quantize_params_int8` quantizes (its `scales` keys,
    mapped by the port's key rule; at a floor of 1 the SR head's 81-element
    convs too); q is bit-equal after the layout transpose, the scales are
    bit-equal, every other tensor is unchanged, the fp32 parameters are
    gone, and `quantization_error` agrees within 1e-6 (both in fp32,
    summed in another order)."""
    v, port = _init(kind)
    before = {k: t.clone() for k, t in port.state_dict().items()}
    qp = jq.quantize_params_int8(v["params"], min_elems=floor)
    names = pq.quantize_module_int8(port, floor)
    assert names == pq.quantized_modules(port)
    want = {_key(tuple(k.split("/"))): k for k in qp["scales"]}
    assert {f"{n}.weight" for n in names} == set(want)
    assert len(names) > 3
    modules = dict(port.named_modules())
    for name in names:
        m, jkey = modules[name], want[f"{name}.weight"]
        assert m.weight_q.dtype == torch.int8
        assert m.weight_scale.dtype == torch.float32
        q_j = _value("kernel", _get(qp["weights"], jkey))
        np.testing.assert_array_equal(m.weight_q.float().numpy(), q_j)
        np.testing.assert_array_equal(m.weight_scale.numpy(),
                                      qp["scales"][jkey])
        assert "weight" not in m._parameters
    after = port.state_dict()
    for k, t in after.items():
        if not k.endswith(("weight_q", "weight_scale")):
            assert torch.equal(t, before[k]), k
    assert set(before) - set(after) == set(want)
    assert ("super_res.conv1" in names) == (floor < 81)
    err = pq.quantization_error(before, port)
    assert 0 < err < 0.01
    assert abs(err - jq.quantization_error(v["params"], qp)) <= 1e-6


def test_quantize_weight_rounds_and_clamps_as_numpy():
    """Half-way values round to even, an all-zero channel gets scale 1, a
    4-D weight reduces over every axis but the first."""
    w = torch.zeros(3, 2, 1, 2)
    w[0] = torch.tensor([127.0, 0.5, 1.5, -2.5]).reshape(2, 1, 2)
    w[2] = torch.tensor([-0.3, 0.1, 0.2, 0.0]).reshape(2, 1, 2)
    q, s = pq.quantize_weight_int8(w)
    assert s.tolist()[1] == 1.0 and s.dtype == torch.float32
    assert q[0].flatten().tolist() == [127, 0, 2, -2]
    assert q[1].abs().sum() == 0
    assert q[2].flatten().tolist() == [-127, 42, 85, 0]


def test_int8_linear_plain_version_and_refusals():
    """The plain version against the scale-factoring identity
    (x·qᵀ)·s + b = x·(q·s)ᵀ + b (fp32, 1e-5 of the scale); the wrapper
    raises for an input autograd would have to see and for a device with
    no kernel."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 5, 48)).astype(np.float32))
    q = torch.from_numpy(rng.integers(-127, 128, (24, 48)).astype(np.int8))
    s = torch.from_numpy(rng.uniform(1e-3, 2e-2, 24).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=24).astype(np.float32))
    got = i8.int8_linear(x, q, s, b)
    want = (x.double() @ q.double().T) * s.double() + b.double()
    assert got.shape == (2, 5, 24) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    np.testing.assert_allclose(i8.int8_linear(x, q, s).numpy(),
                               (want - b.double()).numpy(), rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    with pytest.raises(RuntimeError, match="no backward"):
        i8.int8_linear(x.clone().requires_grad_(), q, s, b)
    with pytest.raises(RuntimeError, match="no backward"):
        i8.int8_linear(x, q, s, b.clone().requires_grad_())
    with torch.no_grad():  # nothing to record: the call goes through
        i8.int8_linear(x.clone().requires_grad_(), q, s, b)
    with pytest.raises(ValueError, match="no int8-linear kernel"):
        i8.int8_linear(x.to("meta"), q.to("meta"), s.to("meta"))


def test_quantized_layers_compute_with_the_dequantised_weight():
    """A quantized Dense, PatchProj (its (C, p, p) order), Conv2d and the
    SR head's Conv3x3s equal the same modules with their weight replaced
    by the dequantised one, in fp32 and bf16; a quantized Dense or
    PatchProj has no backward, and `set_plain` routes them to the plain
    version (the same numbers on the CPU)."""
    from ecamp_tpu_torch.nn.layers import set_plain
    from ecamp_tpu_torch.nn.mae import SuperResolutionHead

    g = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        mods = (Dense(32, 48, dtype=dtype), PatchProj(3, 32, 4, dtype=dtype),
                Conv2d(8, 16, 3, dtype=dtype), SuperResolutionHead())
        inputs = (torch.randn(2, 5, 32, generator=g),
                  torch.randn(2, 8, 8, 3, generator=g),
                  torch.randn(2, 8, 6, 6, generator=g),
                  torch.randn(2, 6, 5, 3, generator=g))
        for m, x in zip(mods, inputs):
            for sub in m.modules():
                if hasattr(sub, "weight"):
                    sub.reset_parameters(g)
                    with torch.no_grad():
                        sub.bias.normal_(generator=g)
            ref = copy.deepcopy(m)
            names = pq.quantize_module_int8(m, 1)
            assert names == (["conv1", "conv2"] if names[0] else [""])
            with torch.no_grad():
                for key, w in pq.dequantized_state(m).items():
                    ref.get_parameter(key).copy_(w)
                got, want = m(x), ref(x)
                set_plain(m, True)
                plain = m(x)
                set_plain(m, False)
            assert got.dtype == (x.dtype if isinstance(
                m, SuperResolutionHead) else dtype)
            assert torch.equal(got, want) and torch.equal(plain, got)
            if isinstance(m, (Dense, PatchProj)):
                with pytest.raises(RuntimeError, match="no backward"):
                    m(x)


def _mesh():
    return make_mesh(jcfg.MeshConfig(data=1), devices=jax.devices()[:1])


def _images(seed, n=3):
    return np.random.default_rng(seed).normal(size=(n, IMG, IMG, 3)).astype(
        np.float32)


@pytest.fixture
def floor_256(monkeypatch):
    """Both packages' engines quantize at the floor of 256 elements."""
    monkeypatch.setattr(jq.quantize_params_int8, "__defaults__", (MIN_ELEMS,))
    monkeypatch.setattr(pq, "MIN_ELEMS", MIN_ELEMS)


def _close(got, want, rtol, atol, what=""):
    """max |got - want| <= rtol times the reference's scale (at least 1)
    plus atol."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = rtol * max(1.0, float(np.abs(want).max())) + atol
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: max|err| {err:.3e} > {bound:.3e}"


def test_int8_classifier_engine_matches_jax(tmp_path, floor_256):
    """`classifier_engine(quantize="int8", bf16=False)` on a `.pth` against
    the JAX engine with `quantize="int8"` on the same file: probabilities
    within the unquantized parity's rtol 1e-4, atol 1e-5
    (`tests/test_torch_serve.py`); 9 weights int8 (patch projection, 4 a
    block; the 64 x 3 head is under the floor)."""
    from ecamp_tpu.serve.loaders import classifier_engine as jax_engine
    from ecamp_tpu_torch.cli.finetune_cls import save_best
    from ecamp_tpu_torch.nn import ViTClassifier
    from ecamp_tpu_torch.serve import classifier_engine

    model = ViTClassifier(_vit(pcfg), 3,
                          generator=torch.Generator().manual_seed(1))
    with torch.no_grad():  # spread the logits past the tiny head init
        model.head.weight.normal_(0, 0.3, generator=torch.Generator()
                                  .manual_seed(2))
    path = str(tmp_path / "cls.pth")
    save_best(path, model)
    got_e = classifier_engine(path, num_classes=3, img_size=IMG,
                              vit=_vit(pcfg), buckets=(4,), bf16=False,
                              device="cpu", quantize="int8")
    assert len(pq.quantized_modules(got_e.model)) == 9
    want_e = jax_engine(path, num_classes=3, img_size=IMG, vit=_vit(jcfg),
                        buckets=(4,), bf16=False, mesh=_mesh(),
                        quantize="int8")
    x = _images(3)
    got, want = got_e(x), np.asarray(want_e(x))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    fp = classifier_engine(path, num_classes=3, img_size=IMG, vit=_vit(pcfg),
                           buckets=(4,), bf16=False, device="cpu")
    assert 0 < float(np.abs(fp(x) - got).max()) < 2e-2


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
def test_int8_segmenter_engine_matches_jax(tmp_path, floor_256, dual):
    """`segmenter_engine(quantize="int8", bf16=False)` against JAX's on the
    same `.pth`: masks within the unquantized parity's 1e-5
    (`tests/test_torch_segmentation.py`); the decoder's convs are int8 and
    widened before `F.conv2d`."""
    from ecamp_tpu.serve.loaders import segmenter_engine as jax_engine
    from ecamp_tpu_torch.cli.finetune_cls import save_best
    from ecamp_tpu_torch.nn import SegViT, SegViTDual
    from ecamp_tpu_torch.serve import segmenter_engine

    cls = SegViTDual if dual else SegViT
    model = cls(_vit(pcfg, 32, 16), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():  # a bias that puts part of the mask over 0.5
        for name in cls.DECODERS:
            getattr(model, name).final_out.bias.fill_(0.3)
    model(torch.from_numpy(_images(4, 4)), train=True)  # move the stats
    path = str(tmp_path / "seg.pth")
    save_best(path, model)
    got_e = segmenter_engine(path, img_size=IMG, dual=dual,
                             vit=_vit(pcfg, 32, 16), buckets=(4,), bf16=False,
                             device="cpu", quantize="int8")
    names = pq.quantized_modules(got_e.model)
    assert any("decoder_1.0" in n for n in names)
    want_e = jax_engine(path, img_size=IMG, dual=dual, vit=_vit(jcfg, 32, 16),
                        buckets=(4,), mesh=_mesh(), bf16=False,
                        quantize="int8")
    x = _images(5)
    got = got_e(x)
    assert got.shape == (3, IMG, IMG, 2 if dual else 1)
    _close(got, np.asarray(want_e(x)), 1e-5, 0.0, "served masks")


@pytest.mark.parametrize("floor", ["256", "default"])
def test_int8_detector_engine_matches_jax(tmp_path, monkeypatch, floor):
    """`detector_engine(quantize="int8", bf16=False)` against JAX's on the
    same `.pth`, compared on the decoded candidates before NMS: within the
    unquantized parity's 1e-4 of the scale plus 1e-5
    (`tests/test_torch_detection.py`); at the floor of 256 and at the
    default, where the neck's and the head's convs are int8 and the tiny
    trunk stays in float."""
    from ecamp_tpu.serve import loaders as jax_loaders
    from ecamp_tpu_torch.cli.finetune_det import save_best
    from ecamp_tpu_torch.nn import DetectionModel
    from ecamp_tpu_torch.serve import detector_engine

    if floor == "256":
        monkeypatch.setattr(jq.quantize_params_int8, "__defaults__",
                            (MIN_ELEMS,))
        monkeypatch.setattr(pq, "MIN_ELEMS", MIN_ELEMS)
    model = DetectionModel(_vit(pcfg, 32, 16),
                           generator=torch.Generator().manual_seed(4))
    with torch.no_grad():  # objectness over 0.5 for some candidates
        for i in range(3):
            getattr(model, f"embedding{i}").conv_out.bias[4::6].fill_(0.5)
    model(torch.from_numpy(_images(6, 4)), train=True)
    path = str(tmp_path / "det.pth")
    save_best(path, model, 1)
    engine = detector_engine(path, img_size=IMG, vit=_vit(pcfg, 32, 16),
                             buckets=(4,), bf16=False, device="cpu",
                             quantize="int8")
    names = pq.quantized_modules(engine.model)
    assert any(n.startswith("embedding0") for n in names)
    assert any(n.startswith("backbone.encoder.blocks")
               for n in names) == (floor == "256")
    tiny = _vit(jcfg, 32, 16)  # JAX's engine builds cfg.ViTConfig(img_size)
    monkeypatch.setattr(jax_loaders.cfg, "ViTConfig", lambda img_size: tiny)
    jax_engine = jax_loaders.detector_engine(path, img_size=IMG, buckets=(4,),
                                             mesh=_mesh(), bf16=False,
                                             quantize="int8")
    padded = np.concatenate([_images(7), _images(7)[-1:]])
    with torch.inference_mode():
        cand = engine._fn(torch.from_numpy(padded)).numpy()
    cand_j = np.asarray(jax_engine._fn(jax_engine.params,
                                       jnp.asarray(padded)))
    _close(cand, cand_j, 1e-4, 1e-5, "candidates")
