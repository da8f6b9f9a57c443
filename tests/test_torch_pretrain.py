"""The port's pretraining slice (ecamp_tpu_torch: ops, nn.bert, nn.mae,
train) against the JAX package at a tiny size: ViT 32 px / dim 32 /
depth 2, decoder 16 / depth 1, BERT vocab 64 / hidden 32 / 2 layers,
L = 8, data 64 px, fp32, dropout 0 (the config of
tests/test_train_steps.py:146-157).

Inputs and the MAE masking noise come from numpy seeds; the noise reaches
the JAX model by replacing `jax.random.uniform` for the draw of that shape
while the JAX forward is traced (the JAX package is not edited). Weights
go JAX init -> `state_dict_from_flax` -> strict `load_state_dict`. On the
CPU the JAX package runs its kernels' plain references, and the port runs
its kernels' plain versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ecamp_tpu.core import config as jcfg  # noqa: E402
from ecamp_tpu.core.mesh import make_mesh  # noqa: E402
from ecamp_tpu.train.pretrain import PretrainTask as JaxPretrainTask  # noqa: E402
from ecamp_tpu.train.state import TrainState as JaxTrainState  # noqa: E402
from ecamp_tpu_torch.ckpt import state_dict_from_flax  # noqa: E402
from ecamp_tpu_torch.core import config as pcfg  # noqa: E402
from ecamp_tpu_torch.nn.mae import ECAMP  # noqa: E402
from ecamp_tpu_torch.train.pretrain import (PretrainTask,  # noqa: E402
                                            device_normalize)

B, L, IMG, GRID = 2, 8, 64, 4


def _tiny(lib):
    return lib.PretrainConfig(
        vit=lib.ViTConfig(img_size=32, patch_size=16, embed_dim=32, depth=2,
                          num_heads=2),
        decoder=lib.MAEDecoderConfig(embed_dim=16, depth=1, num_heads=2),
        bert=lib.BertConfig(vocab_size=64, hidden_size=32,
                            num_hidden_layers=2, num_attention_heads=2,
                            intermediate_size=64, max_position_embeddings=L,
                            hidden_dropout_prob=0.0,
                            attention_probs_dropout_prob=0.0),
        optimizer=lib.OptimizerConfig(schedule="constant", lr=1e-3),
        data=lib.DataConfig(img_size=IMG), sr_window=1,
        max_caption_length=L, bf16=False,
        **({"mesh": lib.MeshConfig(data=1)} if lib is jcfg else {}))


def _batch(seed=5):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, L), np.int32)
    mask[1, 5:] = 0  # padding on one caption
    return {
        "image": rng.normal(size=(B, IMG, IMG, 3)).astype(np.float32),
        "ids": rng.integers(0, 64, (B, L)).astype(np.int32),
        "labels": rng.integers(0, 64, (B, L)).astype(np.int32),
        "attention_mask": mask,
        "type_ids": rng.integers(0, 2, (B, L)).astype(np.int32),
        "weights": rng.uniform(0.5, 2.0, (B, L)).astype(np.float32),
        "column": np.array([0, 1], np.int32),
        "row": np.array([1, 0], np.int32)}


NOISE = np.random.default_rng(11).uniform(size=(B, GRID)).astype(np.float32)


@pytest.fixture
def jax_noise(monkeypatch):
    """While active, JAX's masking draw (shape (B, grid**2)) returns NOISE."""
    uniform = jax.random.uniform

    def fake(key, shape=(), *args, **kwargs):
        if tuple(shape) == NOISE.shape:
            return jnp.asarray(NOISE)
        return uniform(key, shape, *args, **kwargs)

    monkeypatch.setattr(jax.random, "uniform", fake)


@pytest.fixture(scope="module")
def jax_task():
    """The JAX task and its initial params (init jitted: the eager init
    of the tiny model costs several times more)."""
    cfg = _tiny(jcfg)
    task = JaxPretrainTask(cfg, mesh=make_mesh(cfg.mesh,
                                               devices=jax.devices()[:1]))
    fb = task.fake_batch(2)
    params = jax.jit(lambda r: task.model.init(
        {"params": r, "masking": jax.random.fold_in(r, 1)}, fb,
        mask_ratio=cfg.mask_ratio, deterministic=True))(
            jax.random.PRNGKey(0))["params"]
    return task, jax.tree_util.tree_map(np.asarray, params)


def _port_task(params):
    task = PretrainTask(_tiny(pcfg), device="cpu")
    task.model.load_state_dict(state_dict_from_flax(params), strict=True)
    return task


def _rel(a, b):
    a = float(a.detach()) if torch.is_tensor(a) else float(a)
    return abs(a - float(b)) / abs(float(b))


def test_config_fields_match_jax():
    for name in ("BertConfig", "MAEDecoderConfig", "OptimizerConfig",
                 "DataConfig", "MeshConfig", "PretrainConfig"):
        port = dataclasses.asdict(getattr(pcfg, name)())
        ref = dataclasses.asdict(getattr(jcfg, name)())
        if name == "PretrainConfig":
            # the port's switch for what JAX reads from ECAMP_FUSED_CE
            assert port.pop("fused_mlm_ce") is False
        assert port == ref, name


def test_state_dict_from_flax_matches_jax_exporter(jax_task):
    """The bridge gives the keys and values that the JAX package's
    export_ecamp_pretrain writes, and they are exactly the port ECAMP's
    state dict (the two sin-cos tables are buffers on both sides)."""
    from ecamp_tpu.ckpt.torch_export import state_dict_from_variables

    def pm(key):  # export_ecamp_pretrain's namespace map
        if key.startswith("bert.cls."):
            return "bert_encoder.model." + key[len("bert."):]
        if key.startswith("bert."):
            return "bert_encoder.model.bert." + key[len("bert."):]
        return key

    _, params = jax_task
    sd = state_dict_from_flax(params)
    ref = state_dict_from_variables({"params": params}, pm)
    assert set(sd) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    c = _tiny(pcfg)
    port = ECAMP(c.vit, c.decoder, c.bert, c.sr_window, c.sr_scale)
    assert set(port.state_dict()) == set(sd)
    assert all(port.state_dict()[k].shape == sd[k].shape for k in sd)
    assert "pos_embed" not in sd and "decoder_pos_embed" not in sd
    assert sd["super_res.conv1.weight"].shape == (3, 3, 3, 3)  # OIHW
    assert sd["bert_encoder.model.cls.predictions.decoder.weight"].shape == (
        64, 32)  # (vocab, hidden)


# -- ops -------------------------------------------------------------------

def test_resize_and_normalize_match_jax():
    from ecamp_tpu.ops import image_ops as jops
    from ecamp_tpu_torch.ops import image_ops as pops

    x = np.random.default_rng(1).normal(size=(2, 64, 48, 3)).astype(
        np.float32)
    for fn, size in (("resize_bicubic", (32, 24)),
                     ("resize_bilinear", (128, 96))):
        want = np.asarray(getattr(jops, fn)(jnp.asarray(x), size))
        got = getattr(pops, fn)(torch.from_numpy(x), size).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=fn)
    u8 = np.random.default_rng(2).integers(0, 256, (2, 8, 8, 1), np.uint8)
    want = np.asarray(jops.device_normalize_image(jnp.asarray(u8), 0.47, 0.3))
    got = pops.device_normalize_image(torch.from_numpy(u8), 0.47, 0.3)
    assert tuple(got.shape) == (2, 8, 8, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    f = torch.zeros(2, 3)
    assert pops.device_normalize_image(f, 0.47, 0.3) is f


def test_masking_matches_jax():
    from ecamp_tpu.ops import masking as jm
    from ecamp_tpu_torch.ops import masking as pm

    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 16, 5)).astype(np.float32)
    noise = rng.uniform(size=(3, 16)).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", lambda key, shape: jnp.asarray(noise))
        want = jm.random_masking(jax.random.PRNGKey(0), jnp.asarray(x), 0.75)
    got = pm.random_masking(torch.from_numpy(x), 0.75, torch.from_numpy(noise))
    for name, a, e in zip(("x_kept", "mask", "ids_restore", "ids_keep"),
                          got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(e), err_msg=name)

    mask = got[1]
    column, row = np.array([0, 1, 2]), np.array([2, 0, 1])
    want = jm.mask_to_pixel(jnp.asarray(mask.numpy()), jnp.asarray(column),
                            jnp.asarray(row), 4, 2, 2)
    got = pm.mask_to_pixel(mask, torch.from_numpy(column),
                           torch.from_numpy(row), 4, 2, 2)
    for a, e in zip(got, want):
        assert tuple(a.shape) == e.shape
        np.testing.assert_array_equal(a.numpy(), np.asarray(e))

    imgs = rng.normal(size=(2, 8, 12, 3)).astype(np.float32)
    p = pm.patchify(torch.from_numpy(imgs), 4)
    np.testing.assert_array_equal(p.numpy(), np.asarray(
        jm.patchify(jnp.asarray(imgs), 4)))
    sq = rng.normal(size=(2, 9, 48)).astype(np.float32)
    np.testing.assert_array_equal(
        pm.unpatchify(torch.from_numpy(sq), 4).numpy(),
        np.asarray(jm.unpatchify(jnp.asarray(sq), 4)))


def test_losses_match_jax():
    from ecamp_tpu.ops import losses as jl
    from ecamp_tpu_torch.ops import losses as pl

    rng = np.random.default_rng(4)
    logits = rng.normal(size=(2, 8, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (2, 8)).astype(np.int32)
    weights = rng.uniform(0, 2, (2, 8)).astype(np.float32)
    want = float(jl.weighted_mlm_loss(jnp.asarray(logits), jnp.asarray(labels),
                                      jnp.asarray(weights)))
    got = pl.weighted_mlm_loss(torch.from_numpy(logits),
                               torch.from_numpy(labels),
                               torch.from_numpy(weights))
    assert _rel(got, want) < 1e-6
    arrs = [rng.normal(size=s).astype(np.float32) for s in
            ((2, 8, 8, 3), (2, 8, 8, 3), (2, 16, 16, 3), (2, 16, 16, 3))]
    masks = [(rng.uniform(size=s) > 0.5).astype(np.float32)
             for s in ((2, 8, 8, 1), (2, 16, 16, 1))]
    want = jl.masked_pixel_losses(*(jnp.asarray(a) for a in arrs + masks))
    got = pl.masked_pixel_losses(*(torch.from_numpy(a) for a in arrs + masks))
    for a, e in zip(got, want):
        assert a.dtype == torch.float32 and _rel(a, e) < 1e-6


# -- the model and the step --------------------------------------------------

def test_ecamp_losses_and_grads_match_jax(jax_task, jax_noise):
    """The whole tiny ECAMP forward from JAX weights: losses within 1e-5
    relative, and every parameter's gradient of mim + res + mlm within
    rtol 1e-4 / atol 1e-6."""
    task, params = jax_task
    jb = {k: jnp.asarray(v) for k, v in _batch().items()}

    def loss_fn(p):
        out = task.model.apply({"params": p}, jb, mask_ratio=0.75,
                               deterministic=True,
                               rngs={"masking": jax.random.PRNGKey(1)})
        return (out["mim_loss"] + out["res_loss"] + out["mlm_loss"],
                out)

    (_, jout), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params))

    port = _port_task(params)
    model = port.model.eval()
    out = model(port.put_batch(_batch()), noise=torch.from_numpy(NOISE))
    (out["mim_loss"] + out["res_loss"] + out["mlm_loss"]).backward()
    for k in ("mim_loss", "res_loss", "mlm_loss"):
        assert _rel(out[k], jout[k]) < 1e-5, k
    want = state_dict_from_flax(jgrads)
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(want)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_pretrain_task_three_steps_match_jax(jax_task, jax_noise):
    """Three PretrainTask steps (AdamW, constant lr 1e-3, wd 0.05) from the
    same weights, batch and noise: every loss within 1e-4 relative, the
    applied lr exact; the port's AdamW moments read back through the JAX
    package's reference-checkpoint importer."""
    from ecamp_tpu.ckpt.torch_import import import_ecamp_adamw_state

    task, params = jax_task
    jstate = task.place_state(JaxTrainState.create(
        jax.tree_util.tree_map(jnp.asarray, params), task.tx))
    jbatch = task.shard_batch(_batch())
    want = []
    for _ in range(3):
        jstate, m = task.train_step(jstate, jbatch, jax.random.PRNGKey(7))
        want.append({k: float(v) for k, v in m.items()})

    port = _port_task(params)
    state = port.init_state()
    batch = port.put_batch(_batch())
    for i in range(3):
        state, m = port.train_step(state, batch,
                                   noise=torch.from_numpy(NOISE))
        for k in ("loss", "mim_loss", "res_loss", "mlm_loss"):
            assert _rel(m[k], want[i][k]) < 1e-4, (i, k)
        assert float(m["lr"]) == pytest.approx(want[i]["lr"], rel=1e-7)
    assert int(state.step) == 3

    model_sd = {k: v.detach().numpy() for k, v in
                port.model.state_dict().items()}
    opt_state, n, step = import_ecamp_adamw_state(
        task.tx.init(jax.tree_util.tree_map(jnp.asarray, params)), params,
        {"model": model_sd, "optimizer": state.optimizer_state_dict(0.05)})
    assert (n, step) == (len(model_sd), 3)
    adam = opt_state[0][0]
    for tree, moments in ((adam.mu, state.opt_state.mu),
                          (adam.nu, state.opt_state.nu)):
        got = state_dict_from_flax(tree)
        for k, v in moments.items():
            np.testing.assert_array_equal(got[k].numpy(), v.numpy(),
                                          err_msg=k)
    again = state.load_optimizer_state_dict(state.optimizer_state_dict())
    assert int(again.opt_state.count) == 3
    assert all(torch.equal(again.opt_state.nu[k], state.opt_state.nu[k])
               for k in state.params)


def test_pretrain_task_guards_and_features():
    c = _tiny(pcfg)
    with pytest.raises(ValueError, match="img_size"):
        PretrainTask(dataclasses.replace(c, data=pcfg.DataConfig(
            img_size=48)), device="cpu")
    task = PretrainTask(c, device="cpu")
    batch = task.fake_batch(2)
    u8 = dict(batch, image=torch.full((2, IMG, IMG, 1), 128, dtype=torch.uint8))
    out = task.model(device_normalize(u8, 0.5, 0.25), features_only=True,
                     noise=torch.from_numpy(NOISE))
    assert tuple(out["gap_feature"].shape) == (2, 32)
    assert tuple(out["patch_latent"].shape) == (2, 1, 32)  # 25% kept
    assert "mlm_logits" not in out and "mim_loss" in out


def test_dropout_and_drop_path_in_training():
    from ecamp_tpu_torch.nn import Dropout, DropPath, set_generator

    x = torch.ones(400, 500)
    d = set_generator(Dropout(0.1), torch.Generator().manual_seed(0))
    y = d.train()(x)
    thresh = round(0.1 * 65536)
    kept = y != 0
    # the JAX package's uint16 quantization of the rate and its rescale
    torch.testing.assert_close(y[kept], torch.full_like(
        y[kept], 65536 / (65536 - thresh)))
    assert abs(1 - float(kept.float().mean()) - thresh / 65536) < 3e-3
    assert abs(float(y.mean()) - 1.0) < 4e-3  # unbiased
    p = set_generator(DropPath(0.25), torch.Generator().manual_seed(1))
    z = p.train()(x)
    rows = z[:, 0]
    assert bool(((z == 0) | (z == 1 / 0.75)).all())
    assert bool((z == rows[:, None]).all())  # whole samples dropped
    assert abs(float((rows == 0).float().mean()) - 0.25) < 0.07
    assert p.eval()(x) is x and d.eval()(x) is x


def test_bert_attention_dropout_placements():
    """Default: dropout on the context output, the attention still through
    `dot_product_attention`; exact_attn_dropout: HF's dropout of the
    probabilities. Both are the plain attention when dropout is off."""
    from ecamp_tpu_torch.nn.bert import BertSelfAttention, extend_attention_mask
    from ecamp_tpu_torch.nn.layers import set_generator

    cfg = pcfg.BertConfig(hidden_size=32, num_attention_heads=2,
                          attention_probs_dropout_prob=0.3)
    x = torch.randn(2, 8, 32, generator=torch.Generator().manual_seed(0))
    bias = extend_attention_mask(torch.tensor([[1] * 8, [1] * 5 + [0] * 3]))
    outs = {}
    for exact in (False, True):
        m = BertSelfAttention(dataclasses.replace(
            cfg, exact_attn_dropout=exact))
        for mod in m.modules():
            if hasattr(mod, "reset_parameters"):
                mod.reset_parameters(torch.Generator().manual_seed(1))
        set_generator(m, torch.Generator().manual_seed(2))
        outs[exact, "eval"] = m.eval()(x, bias)
        outs[exact, "train"] = m.train()(x, bias)
    torch.testing.assert_close(outs[True, "eval"], outs[False, "eval"])
    for exact in (False, True):
        t = outs[exact, "train"]
        assert bool(torch.isfinite(t).all())
        assert not torch.allclose(t, outs[exact, "eval"])
    # the default drops whole context elements; the exact one drops
    # probabilities, so its output is rarely exactly zero
    assert float((outs[False, "train"] == 0).float().mean()) > 0.2
    assert float((outs[True, "train"] == 0).float().mean()) < 0.05


def test_pretrain_step_with_dropout_is_seeded():
    """Dropout and masking draw from the task's generators: two tasks from
    one seed take the same steps; dropout changes the losses."""
    from ecamp_tpu_torch.train.pretrain import synthetic_batch

    cfg = dataclasses.replace(_tiny(pcfg), bert=dataclasses.replace(
        _tiny(pcfg).bert, hidden_dropout_prob=0.1,
        attention_probs_dropout_prob=0.1))
    batch = synthetic_batch(cfg, 2, torch.Generator().manual_seed(3))
    assert tuple(batch["image"].shape) == (2, IMG, IMG, 3)
    assert int(batch["column"].max()) <= GRID ** 0.5 - cfg.sr_window
    assert abs(float(batch["weights"].mean()) - 1.0) < 1e-6
    runs = []
    for deterministic in (False, False, True):
        task = PretrainTask(cfg, device="cpu")
        state = task.init_state()
        losses = []
        for _ in range(2):
            state, m = task.train_step(state, batch,
                                       deterministic=deterministic)
            losses.append(float(m["loss"]))
        runs.append(losses)
    assert runs[0] == runs[1]
    assert runs[0][0] != runs[2][0]
