"""The port's ViT classifier (ecamp_tpu_torch.nn, .ckpt) against the JAX
`ViTClassifier` with the same weights, at a tiny size (img 32, patch 8,
dim 64, depth 2, 4 heads).

Inputs come from numpy seeds; weights go JAX init -> `state_dict_from_flax`
-> strict `load_state_dict`. The JAX forward runs its Pallas kernels in
interpret mode, as tests/test_sr_kernel.py does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

torch = pytest.importorskip("torch")

from ecamp_tpu.core import config as jcfg  # noqa: E402
from ecamp_tpu.nn import ViTClassifier as JaxViTClassifier  # noqa: E402
from ecamp_tpu_torch.ckpt import (load_classifier_state,  # noqa: E402
                                  load_reference_pth, state_dict_from_flax)
from ecamp_tpu_torch.core import ViTConfig  # noqa: E402
from ecamp_tpu_torch.nn import ViTClassifier, interpolate_pos_embed  # noqa: E402

KW = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4)
N_CLASSES = 5


def _jax_model(global_pool=True, seed=0, dtype=jnp.float32):
    model = JaxViTClassifier(jcfg.ViTConfig(**KW), N_CLASSES,
                             global_pool=global_pool, dtype=dtype)
    variables = model.init(jax.random.PRNGKey(seed),
                           jnp.zeros((2, 32, 32, 3)))
    # the JAX head init (std 2e-5) leaves logits near 0; widen it so the
    # comparisons see the trunk
    head = variables["params"]["head"]
    rng = np.random.default_rng(seed + 100)
    head["kernel"] = jnp.asarray(
        rng.normal(0, 0.2, head["kernel"].shape), jnp.float32)
    head["bias"] = jnp.asarray(rng.normal(0, 0.1, head["bias"].shape),
                               jnp.float32)
    return model, variables["params"]


def _port_model(params, global_pool=True, dtype=torch.float32):
    model = ViTClassifier(ViTConfig(**KW), N_CLASSES, global_pool=global_pool,
                          dtype=dtype)
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    return model.eval()


def _images(seed, n=3):
    return np.random.default_rng(seed).normal(size=(n, 32, 32, 3)).astype(
        np.float32)


def _jax_apply(model, params, x, **kw):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(model.apply({"params": params}, jnp.asarray(x),
                                      **kw), np.float32)


def _port_apply(model, x, **kw):
    with torch.inference_mode():
        return model(torch.from_numpy(x), **kw).float().numpy()


def test_config_fields_match_jax():
    import dataclasses

    port = {f.name: f.default for f in dataclasses.fields(ViTConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(jcfg.ViTConfig)}
    assert port == ref
    assert ViTConfig().num_patches == jcfg.ViTConfig().num_patches == 196


def test_state_dict_from_flax_matches_jax_exporter():
    """The bridge gives the keys and values the JAX package's own .pth
    exporter writes, and they are exactly the port model's state dict."""
    from ecamp_tpu.ckpt.torch_export import state_dict_from_variables

    _, params = _jax_model()
    sd = state_dict_from_flax(params)
    ref = state_dict_from_variables(
        {"params": params},
        lambda k: k[len("trunk."):] if k.startswith("trunk.") else k)
    assert set(sd) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    port = ViTClassifier(ViTConfig(**KW), N_CLASSES).state_dict()
    assert set(sd) == set(port)
    assert all(tuple(sd[k].shape) == tuple(port[k].shape) for k in port)
    assert "patch_embed.proj.weight" in sd and sd[
        "patch_embed.proj.weight"].shape == (64, 3, 8, 8)  # OIHW
    assert sd["blocks.1.mlp.fc1.weight"].shape == (256, 64)  # (out, in)


@pytest.mark.parametrize("global_pool", [True, False])
def test_logits_match_jax_fp32(global_pool):
    jm, params = _jax_model(global_pool, seed=1)
    pm = _port_model(params, global_pool)
    x = _images(2)
    np.testing.assert_allclose(_port_apply(pm, x), _jax_apply(jm, params, x),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        _port_apply(pm, x, features_only=True),
        _jax_apply(jm, params, x, features_only=True), rtol=1e-4, atol=1e-4)


def test_bf16_port_tracks_fp32_jax():
    jm, params = _jax_model(seed=3)
    pm = _port_model(params, dtype=torch.bfloat16)
    x = _images(4, n=4)
    got = _port_apply(pm, x)
    want = _jax_apply(jm, params, x)
    assert got.dtype == np.float32  # the head runs in fp32
    sig = lambda a: 1.0 / (1.0 + np.exp(-a))  # noqa: E731
    np.testing.assert_allclose(sig(got), sig(want), atol=5e-2)
    # and the bf16 port against the bf16 JAX model on the same weights
    jb = JaxViTClassifier(jcfg.ViTConfig(**KW), N_CLASSES, dtype=jnp.bfloat16)
    np.testing.assert_allclose(sig(got), sig(_jax_apply(jb, params, x)),
                               atol=5e-2)


def test_reference_pth_strict_load(tmp_path):
    """A reference-layout .pth (the JAX exporter's output, and the same
    dict wrapped as {'model': {'module.' + k}}) loads strictly."""
    from ecamp_tpu.ckpt.torch_export import export_vit_classifier

    jm, params = _jax_model(seed=5)
    flat = tmp_path / "cls.pth"
    export_vit_classifier({"params": params}, str(flat))
    wrapped = tmp_path / "wrapped.pth"
    torch.save({"model": {f"module.{k}": v for k, v in
                          load_reference_pth(str(flat)).items()},
                "epoch": 3}, wrapped)
    x = _images(6)
    want = _jax_apply(jm, params, x)
    for path in (flat, wrapped):
        model = ViTClassifier(ViTConfig(**KW), N_CLASSES).eval()
        load_classifier_state(model, load_reference_pth(str(path)))
        np.testing.assert_allclose(_port_apply(model, x), want,
                                   rtol=1e-4, atol=1e-4)
    bad = dict(load_reference_pth(str(flat)))
    bad.pop("head.bias")
    with pytest.raises(RuntimeError, match="head.bias"):
        load_classifier_state(ViTClassifier(ViTConfig(**KW), N_CLASSES), bad)


def test_state_dict_round_trips_through_jax_importer(tmp_path):
    """flax params -> port state dict -> torch.save -> the JAX package's
    own .pth importer gives back the same flax params."""
    from ecamp_tpu.ckpt.torch_import import flatten, import_vit_classifier

    jm, params = _jax_model(seed=10)
    path = tmp_path / "port.pth"
    torch.save(_port_model(params).state_dict(), path)
    fresh = jm.init(jax.random.PRNGKey(99), jnp.zeros((2, 32, 32, 3)))
    got, loaded, missing = import_vit_classifier(fresh, str(path))
    assert not missing and len(loaded) == len(flatten(params))
    want = flatten(params)
    for key, v in flatten(got["params"]).items():
        np.testing.assert_array_equal(np.asarray(v), np.asarray(want[key]),
                                      err_msg="/".join(key))


@pytest.mark.parametrize("old,new", [(4, 6), (6, 4)])
def test_interpolate_pos_embed_matches_jax(old, new):
    from ecamp_tpu.nn.pos_embed import interpolate_pos_embed as jax_interp

    pe = np.random.default_rng(7).normal(size=(1, 1 + old * old, 16)).astype(
        np.float32)
    got = interpolate_pos_embed(torch.from_numpy(pe), new)
    assert tuple(got.shape) == (1, 1 + new * new, 16)
    np.testing.assert_allclose(got.numpy(), jax_interp(pe, new),
                               rtol=1e-5, atol=1e-5)
    # 2-D input and an unchanged grid pass through
    same = interpolate_pos_embed(torch.from_numpy(pe[0]), old)
    np.testing.assert_array_equal(same.numpy(), pe[0])


def test_checkpoint_from_another_grid_is_resized():
    _, params = _jax_model(seed=8)
    sd = state_dict_from_flax(params)
    grid = KW["img_size"] // KW["patch_size"]
    sd["pos_embed"] = interpolate_pos_embed(sd["pos_embed"], grid + 2)
    model = ViTClassifier(ViTConfig(**KW), N_CLASSES)
    load_classifier_state(model, sd)
    assert tuple(model.pos_embed.shape) == (1, 1 + grid * grid, 64)


def test_init_is_seeded_and_follows_jax_rules():
    cfg = ViTConfig(**KW)
    a = ViTClassifier(cfg, N_CLASSES, generator=torch.Generator().manual_seed(0))
    b = ViTClassifier(cfg, N_CLASSES, generator=torch.Generator().manual_seed(0))
    c = ViTClassifier(cfg, N_CLASSES, generator=torch.Generator().manual_seed(1))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["blocks.0.attn.qkv.weight"],
                           sc["blocks.0.attn.qkv.weight"])
    # xavier-uniform Linear, zero biases, unit LayerNorm, tiny head
    w = sa["blocks.0.mlp.fc1.weight"]
    assert float(w.abs().max()) <= (6.0 / (64 + 256)) ** 0.5
    assert float(sa["blocks.0.mlp.fc1.bias"].abs().max()) == 0.0
    assert torch.equal(sa["fc_norm.weight"], torch.ones(64))
    assert float(sa["head.weight"].abs().max()) <= 4e-5
    assert all(v.dtype == torch.float32 for v in sa.values())


def test_eval_transform_matches_jax_package():
    from PIL import Image

    from ecamp_tpu.data.transforms import EvalTransform as JaxEvalTransform
    from ecamp_tpu_torch.data.transforms import EvalTransform

    rng = np.random.default_rng(9)
    for h, w in ((40, 60), (70, 33)):
        img = Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8))
        np.testing.assert_array_equal(EvalTransform(32, 0.47, 0.3)(img),
                                      JaxEvalTransform(32, 0.47, 0.3)(img))


def test_dropout_is_inference_identity():
    from ecamp_tpu_torch.nn import Dropout

    x = torch.randn(3, 4)
    d = Dropout(0.1)
    assert d.eval()(x) is x
    # training mode draws only from an explicit generator
    with pytest.raises(RuntimeError, match="generator"):
        d.train()(x)
    d.generator = torch.Generator().manual_seed(0)
    y = d(x)
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] * (65536 / (65536 - 6554)))
