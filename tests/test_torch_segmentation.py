"""The port's segmentation fine-tune (ecamp_tpu_torch.nn.seg,
train.segmentation, cli.finetune_seg, the SIIM/RSNA/RIGA datasets and the
segmenter engine) against the JAX package, on the CPU, at a tiny size:
ViT img 32, patch 16, dim 32, depth 2, 2 heads, decoder (16, 8, 8, 4),
B = 4, fp32.

Weights go JAX init (BatchNorm scales, biases and statistics perturbed so
they are not the identity) -> `state_dict_from_flax` -> strict
`load_state_dict`. Inputs come from numpy seeds. The JAX functions are
jitted once per configuration and shared by the module; the JAX package
runs its kernels' plain references on the CPU, the port its kernels'
plain versions.
"""

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ecamp_tpu.core import config as jcfg  # noqa: E402
from ecamp_tpu.core.mesh import make_mesh  # noqa: E402
from ecamp_tpu.nn.seg import SegViT as JaxSegViT  # noqa: E402
from ecamp_tpu.nn.seg import SegViTDual as JaxSegViTDual  # noqa: E402
from ecamp_tpu.train.segmentation import \
    SegmentationTask as JaxTask  # noqa: E402
from ecamp_tpu_torch.ckpt import (load_reference_pth,  # noqa: E402
                                  load_reference_state,
                                  state_dict_from_flax)
from ecamp_tpu_torch.core import config as pcfg  # noqa: E402
from ecamp_tpu_torch.nn.seg import SegViT, SegViTDual  # noqa: E402
from ecamp_tpu_torch.train.segmentation import \
    SegmentationTask  # noqa: E402

B, IMG, FEATURES = 4, 32, (16, 8, 8, 4)
SAMPLE_RATES = (4, 3)  # 3: sub = 2, seg_head 4 * dim wide, a 64-px output


def _vit(lib, img=IMG):
    return lib.ViTConfig(img_size=img, patch_size=16, embed_dim=32, depth=2,
                         num_heads=2)


def _mesh():
    return make_mesh(jcfg.MeshConfig(data=1), devices=jax.devices()[:1])


def _jax_model(dual, sample_rate=4, img=IMG, features=FEATURES):
    cls = JaxSegViTDual if dual else JaxSegViT
    return cls(_vit(jcfg, img), sample_rate=sample_rate, features=features)


def _port_model(dual, sample_rate=4, img=IMG, features=FEATURES, seed=0):
    cls = SegViTDual if dual else SegViT
    return cls(_vit(pcfg, img), sample_rate=sample_rate, features=features,
               generator=torch.Generator().manual_seed(seed))


def _perturb(variables, seed):
    """Non-trivial BatchNorm scales, biases and running statistics."""
    rng = np.random.default_rng(seed)
    v = jax.tree_util.tree_map(np.asarray, variables)

    def walk(p, s):
        for k in p:
            if k.endswith("_bn"):
                n = p[k]["scale"].shape
                p[k]["scale"] = (1 + 0.2 * rng.normal(size=n)).astype(
                    np.float32)
                p[k]["bias"] = (0.1 * rng.normal(size=n)).astype(np.float32)
                s[k]["mean"] = (0.1 * rng.normal(size=n)).astype(np.float32)
                s[k]["var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
            elif isinstance(p[k], dict) and k in s:
                walk(p[k], s[k])

    walk(v["params"], v["batch_stats"])
    return v


@pytest.fixture(scope="module")
def jax_vars():
    """(dual, sample_rate) -> perturbed JAX variables, numpy leaves."""
    out = {}
    for dual in (False, True):
        for sr in SAMPLE_RATES:
            model = _jax_model(dual, sr)
            v = jax.jit(lambda r: model.init(
                r, jnp.zeros((2, IMG, IMG, 3)), train=False))(
                    jax.random.PRNGKey(sr + 10 * dual))
            out[dual, sr] = _perturb(v, seed=sr + 10 * dual)
    return out


def _port_from(variables, dual, sample_rate=4):
    m = _port_model(dual, sample_rate)
    m.load_state_dict(state_dict_from_flax(variables["params"],
                                           variables["batch_stats"]),
                      strict=True)
    return m.eval()


def _images(seed, n=B, img=IMG):
    return np.random.default_rng(seed).normal(
        size=(n, img, img, 3)).astype(np.float32)


def _masks(seed, dual, n=B, img=IMG):
    rng = np.random.default_rng(seed)
    return (rng.random((n, img, img, 2 if dual else 1)) < 0.3).astype(
        np.float32)


def _close(got, want, tol, what=""):
    """max |got - want| <= tol times the reference's scale (at least 1)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max|err| {err:.3e} > {tol * scale:.3e}"


def _stats_of(model):
    return {k: v for k, v in model.state_dict().items()
            if "running_" in k}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("sample_rate", SAMPLE_RATES)
@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
def test_forward_matches_jax(jax_vars, dual, sample_rate, train):
    """SegViT / SegViTDual logits from the same weights within 1e-5 of the
    output's scale; in training mode the batch statistics normalise and
    the updated running statistics agree within 1e-6 (flax momentum 0.9,
    biased fast variance)."""
    v = jax_vars[dual, sample_rate]
    model = _jax_model(dual, sample_rate)
    x = _images(1)
    apply = jax.jit(functools.partial(
        model.apply, train=train,
        mutable=["batch_stats"] if train else False))
    out = apply(v, jnp.asarray(x))
    if train:
        out, mutated = out
    port = _port_from(v, dual, sample_rate)
    with torch.no_grad():
        got = port(torch.from_numpy(x), train=train)
    want = out if dual else (out,)
    got = got if dual else (got,)
    side = IMG * 2 ** (4 - sample_rate)
    for g, w in zip(got, want):
        assert g.shape == (B, side, side, 1) and g.dtype == torch.float32
        _close(g.numpy(), w, 1e-5, "logits")
    stats = _stats_of(port)
    if train:
        want_stats = state_dict_from_flax(v["params"], mutated["batch_stats"])
        for k, t in stats.items():
            _close(t.numpy(), want_stats[k].numpy(), 1e-6, k)
        assert all(int(t) == 1 for k, t in port.state_dict().items()
                   if k.endswith("num_batches_tracked"))
    else:
        want_stats = state_dict_from_flax(v["params"], v["batch_stats"])
        for k, t in stats.items():
            assert torch.equal(t, want_stats[k]), k


def test_batch_norm_is_flax_not_torch():
    """The port's BatchNorm against flax's on a bf16 input: fp32 stats, the
    biased variance into the running statistic, the output cast last; and
    unlike `F.batch_norm`, whose running variance takes the unbiased one."""
    import flax.linen as fnn

    from ecamp_tpu_torch.nn.layers import BatchNorm

    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 5, 4, 6)) * 3 + 1).astype(np.float32)  # NHWC
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5, dtype=jnp.bfloat16)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    v = bn.init(jax.random.PRNGKey(0), xj)
    yj, mut = bn.apply(v, xj, mutable=["batch_stats"])
    port = BatchNorm(6, dtype=torch.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2)
    yt = port(xt, train=True).permute(0, 2, 3, 1)
    assert yt.dtype == torch.bfloat16
    np.testing.assert_array_equal(yt.detach().float().numpy(),
                                  np.asarray(yj.astype(jnp.float32)))
    for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(getattr(port, ours).numpy(),
                                   np.asarray(mut["batch_stats"][theirs]),
                                   rtol=1e-6, atol=1e-7)
    torch_var = torch.ones(6)
    torch.nn.functional.batch_norm(xt.float(), torch.zeros(6), torch_var,
                                   training=True, momentum=0.1)
    assert not torch.allclose(torch_var, port.running_var, rtol=1e-4)


@pytest.mark.parametrize("shape,scale", [((2, 5, 7, 3), 2), ((1, 3, 4, 2), 3),
                                         ((2, 1, 6, 4), 2)])
def test_upsample_matches_jax(shape, scale):
    """`F.interpolate(align_corners=True)` on NCHW against the JAX
    package's two dense products on NHWC, forward and gradient: 1e-6."""
    from ecamp_tpu.ops.image_ops import upsample_align_corners as jax_up
    from ecamp_tpu_torch.ops.image_ops import upsample_align_corners

    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=shape).astype(np.float32)
    n, h, w, c = shape
    g = rng.normal(size=(n, h * scale, w * scale, c)).astype(np.float32)
    want, vjp = jax.vjp(lambda t: jax_up(t, scale), jnp.asarray(x))
    (gx_want,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    got = upsample_align_corners(xt, scale).permute(0, 2, 3, 1)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(gx_want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["focal_loss", "dice_coefficient",
                                  "mixed_loss"])
def test_seg_losses_match_jax(name):
    """The losses and their gradients in the logits, in fp32; the dice is
    one over the whole batch, as the reference flattens it."""
    from ecamp_tpu.ops import losses as jl
    from ecamp_tpu_torch.ops import losses as pl

    rng = np.random.default_rng(3)
    logits = (2 * rng.normal(size=(B, 16, 16))).astype(np.float32)
    t = (rng.random((B, 16, 16)) < 0.3).astype(np.float32)
    want, grad = jax.value_and_grad(getattr(jl, name))(jnp.asarray(logits),
                                                       jnp.asarray(t))
    lt = torch.from_numpy(logits).requires_grad_(True)
    got = getattr(pl, name)(lt, torch.from_numpy(t))
    got.backward()
    assert got.dtype == torch.float32
    got = float(got.detach())
    assert abs(got - float(want)) <= 1e-6 * max(1.0, abs(float(want)))
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(grad), rtol=1e-5,
                               atol=1e-8)
    per_sample = np.mean([float(getattr(pl, name)(
        torch.from_numpy(logits[i:i + 1]), torch.from_numpy(t[i:i + 1])))
        for i in range(B)])
    if name == "dice_coefficient":
        assert abs(per_sample - got) > 1e-4  # not a per-sample mean


TASKS = {  # name -> (dual, freeze_encoder)
    "single_frozen": (False, True), "single_full": (False, False),
    "dual_frozen": (True, True), "dual_full": (True, False)}


def _cfg(lib, dual, freeze=True, accum=1):
    kw = {"mesh": lib.MeshConfig(data=1)} if lib is jcfg else {}
    return lib.SegmentationConfig(
        vit=_vit(lib),
        optimizer=lib.OptimizerConfig(
            name="adamw", lr=1e-2, weight_decay=0.05, betas=(0.9, 0.999),
            schedule="warmup_cosine_step", warmup_steps=2, total_steps=8,
            grad_clip=1.0, accum_steps=accum),
        task="RIGA" if dual else "SIIM", decode_features=FEATURES,
        freeze_encoder=freeze, bf16=False, seed=5,
        data=lib.DataConfig(img_size=IMG, mean=0.4722, std=0.3028), **kw)


def _port_task(variables, dual, freeze=True, accum=1):
    task = SegmentationTask(_cfg(pcfg, dual, freeze, accum), device="cpu")
    task.model.load_state_dict(state_dict_from_flax(
        variables["params"], variables["batch_stats"]), strict=True)
    return task


@pytest.mark.parametrize("name", sorted(TASKS))
def test_loss_and_grads_match_jax(name, jax_vars):
    """`SegmentationTask`'s mixed loss (RIGA: the mean of disc and cup),
    its gradients (rtol 1e-4, atol 1e-6) and the BatchNorm statistics it
    leaves, against the JAX task's `_loss`. With the encoder frozen the
    trunk records no graph: no gradient at all, JAX's zero."""
    dual, freeze = TASKS[name]
    v = jax_vars[dual, 4]
    task_j = JaxTask(_cfg(jcfg, dual, freeze), mesh=_mesh())
    x, m = _images(2), _masks(3, dual)
    (loss_j, stats_j), g_j = jax.jit(jax.value_and_grad(
        task_j._loss, has_aux=True))(v["params"], v["batch_stats"],
                                     jnp.asarray(x), jnp.asarray(m),
                                     jax.random.PRNGKey(0))
    task = _port_task(v, dual, freeze)
    task.model.eval()
    loss = task.loss(torch.from_numpy(x), torch.from_numpy(m))
    loss.backward()
    assert abs(float(loss.detach()) - float(loss_j)) <= 1e-5 * abs(
        float(loss_j))
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, g_j))
    for k, p in task.model.named_parameters():
        trunk = k.startswith("encoder.") and not k.startswith(
            "encoder.seg_head.")
        if freeze and trunk:
            assert p.grad is None, k
            assert not np.asarray(want[k]).any(), k
            continue
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    want_stats = state_dict_from_flax(v["params"], stats_j)
    for k, t in _stats_of(task.model).items():
        _close(t.numpy(), want_stats[k].numpy(), 1e-6, k)


STEPS = {  # name -> (dual, accum)
    "single": (False, 1), "single_accum2": (False, 2), "dual": (True, 1)}


_PRE_BN_BIAS = re.compile(r"decoder\w*\.decoder_\d+\.0\.bias$")


@pytest.mark.parametrize("name", sorted(STEPS))
def test_adamw_steps_match_jax(name, jax_vars):
    """3 masked AdamW updates (6 micro-steps of 2 with accumulation),
    warmup-cosine, clip 1.0, weight decay 0.05 on the >= 2-D leaves, the
    encoder frozen: the parameters and the BatchNorm running statistics
    (updated every micro-step) within 1e-4 of the JAX task's, which runs
    optax.adamw under the mask; the trunk stays bit-unchanged.

    The bias of each conv that feeds a BatchNorm has a zero gradient in
    exact arithmetic (the norm subtracts the channel mean), so both sides
    hand AdamW rounding noise, which it scales to lr-sized steps of any
    sign. Those biases are held to a gradient at the noise floor instead,
    and the running means, which take the bias in, to JAX's plus the
    running average of the two sides' bias difference."""
    dual, accum = STEPS[name]
    v = jax_vars[dual, 4]
    task_j = JaxTask(_cfg(jcfg, dual, True, accum), mesh=_mesh())
    state_j = task_j.init_state(jax.random.PRNGKey(0))
    state_j = state_j.replace(
        params=jax.tree_util.tree_map(jnp.asarray, v["params"]),
        batch_stats=jax.tree_util.tree_map(jnp.asarray, v["batch_stats"]))
    task = _port_task(v, dual, True, accum)
    state = task.init_state()
    before = {k: t.clone() for k, t in task.model.state_dict().items()}
    drift = {}  # running-mean name -> running average of the bias gap

    def jax_state():
        return state_dict_from_flax(
            jax.tree_util.tree_map(np.asarray, state_j.params),
            jax.tree_util.tree_map(np.asarray, state_j.batch_stats))

    for i in range(3 * accum):
        x, m = _images(10 + i), _masks(20 + i, dual)
        want = jax_state()
        for k, t in task.model.state_dict().items():
            if _PRE_BN_BIAS.search(k):
                rm = k[:-len("0.bias")] + "1.running_mean"
                drift[rm] = 0.9 * drift.get(rm, 0.0) + 0.1 * (
                    t.numpy() - want[k].numpy())
        state_j, m_j = task_j.train_step(state_j, jnp.asarray(x),
                                         jnp.asarray(m))
        state, mt = task.train_step(state, torch.from_numpy(x),
                                    torch.from_numpy(m))
        assert abs(float(mt["loss"]) - float(m_j["loss"])) <= 1e-4
        np.testing.assert_allclose(float(mt["lr"]), float(m_j["lr"]),
                                   rtol=1e-6)
        want = jax_state()
        for k, t in task.model.state_dict().items():
            if k.endswith("num_batches_tracked"):
                assert int(t) == i + 1, k
                continue
            if _PRE_BN_BIAS.search(k):
                w = dict(task.model.named_parameters())[k[:-4] + "weight"]
                assert float(w.grad.abs().max()) > 1e3 * float(
                    task.model.get_parameter(k).grad.abs().max()), k
                continue
            got = t.numpy() - drift.get(k, 0.0)
            np.testing.assert_allclose(got, want[k].numpy(), rtol=0,
                                       atol=1e-4, err_msg=f"{k} step {i}")
    assert int(state.step) == int(state_j.step) == 3 * accum
    for k, t in task.model.state_dict().items():
        trunk = k.startswith("encoder.") and not k.startswith(
            "encoder.seg_head.")
        assert torch.equal(t, before[k]) == trunk, k


def test_dice_scores_match_jax():
    from ecamp_tpu.train.eval_metrics import dice_scores as jax_dice
    from ecamp_tpu_torch.train.eval_metrics import dice_scores

    rng = np.random.default_rng(6)
    probs = rng.random((8, 16, 16)).astype(np.float32)
    truth = (rng.random((8, 16, 16)) < 0.2).astype(np.float32)
    truth[:3] = 0          # empty truths: 1 iff the prediction is empty too
    probs[0] = 0.1
    probs[7] = 0.0
    got, want = dice_scores(probs, truth), jax_dice(probs, truth)
    np.testing.assert_array_equal(got, want)
    assert got[0] == 1.0 and got[1] == 0.0


def _trained_port(dual, seed):
    """A port model with seeded weights and moved running statistics."""
    model = _port_model(dual, seed=seed)
    model(torch.from_numpy(_images(seed)), train=True)
    return model.eval()


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
def test_saved_pth_loads_into_jax(tmp_path, dual):
    """The `.pth` the port's CLI writes (`{"model": state_dict}`, the
    reference namespace, BatchNorm `num_batches_tracked` included) loads
    through JAX's `import_seg_vit(from_pretrain=False)` whole, to the same
    eval outputs (1e-5)."""
    from ecamp_tpu.ckpt import import_seg_vit as jax_import
    from ecamp_tpu_torch.cli.finetune_cls import save_best

    model = _trained_port(dual, seed=3)
    path = str(tmp_path / "best.pth")
    save_best(path, model)
    jm = _jax_model(dual)
    template = jax.jit(lambda r: jm.init(
        r, jnp.zeros((2, IMG, IMG, 3)), train=False))(jax.random.PRNGKey(9))
    variables, loaded, missing = jax_import(template, path,
                                            from_pretrain=False)
    assert missing == []
    assert len(loaded) == len([k for k in model.state_dict()
                               if not k.endswith("num_batches_tracked")])
    x = _images(4)
    want = jax.jit(functools.partial(jm.apply, train=False))(
        variables, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for g, w in zip(got if dual else (got,), want if dual else (want,)):
        _close(g.numpy(), w, 1e-5, "eval logits")


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
def test_jax_export_loads_into_port(tmp_path, jax_vars, dual):
    """JAX's `export_seg_vit` file (flat, no `num_batches_tracked`)
    strict-loads into the port (`load_reference_state`) with every tensor equal
    to the converter's, and serves the same eval outputs."""
    from ecamp_tpu.ckpt import export_seg_vit

    v = jax_vars[dual, 4]
    path = str(tmp_path / "jax.pth")
    export_seg_vit(v, path)
    model = load_reference_state(_port_model(dual, seed=1),
                           load_reference_pth(path)).eval()
    want = state_dict_from_flax(v["params"], v["batch_stats"])
    for k, t in model.state_dict().items():
        assert torch.equal(t, want[k].to(t.dtype)), k
    x = _images(5)
    out_j = jax.jit(functools.partial(_jax_model(dual).apply, train=False))(
        v, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for g, w in zip(got if dual else (got,), out_j if dual else (out_j,)):
        _close(g.numpy(), w, 1e-5, "eval logits")


@pytest.mark.parametrize("flavor", ["ecamp", "gloria"])
def test_import_from_pretrain_matches_jax(tmp_path, flavor):
    """`import_seg_vit(from_pretrain=True)` on the port's pretraining
    checkpoint (`ckpt.save_checkpoint` of a `PretrainTask` with the same
    trunk), given a `pos_embed` of a 4x4 grid: the trunk loads, the
    `pos_embed` is resized to the 2x2 grid, `seg_head` and the decoder
    keep their init; the same names and values as JAX's importer. The
    gloria flavor reads the keys under `state_dict` with the
    `gloria.img_encoder.model.` prefix."""
    from ecamp_tpu.ckpt import import_seg_vit as jax_import
    from ecamp_tpu_torch.ckpt import import_seg_vit, save_checkpoint
    from ecamp_tpu_torch.train.pretrain import PretrainTask

    pre = PretrainTask(pcfg.PretrainConfig(
        vit=_vit(pcfg),
        decoder=pcfg.MAEDecoderConfig(embed_dim=16, depth=1, num_heads=2),
        bert=pcfg.BertConfig(vocab_size=32, hidden_size=32,
                             num_hidden_layers=1, num_attention_heads=2,
                             intermediate_size=64,
                             max_position_embeddings=16),
        data=pcfg.DataConfig(img_size=2 * IMG), sr_window=1,
        max_caption_length=16), device="cpu")
    state = pre.init_state(torch.Generator().manual_seed(4))
    path = save_checkpoint(str(tmp_path), 0, pre.model, state, 0.05)
    ckpt = torch.load(path, weights_only=True)
    sd = dict(ckpt["model"])
    sd["pos_embed"] = torch.randn(1, 17, 32,
                                  generator=torch.Generator().manual_seed(5))
    if flavor == "gloria":
        ckpt = {"state_dict": {"gloria.img_encoder.model." + k: t
                               for k, t in sd.items()}}
    else:
        ckpt["model"] = sd
    torch.save(ckpt, path)

    jm = _jax_model(False)
    template = jax.jit(lambda r: jm.init(
        r, jnp.zeros((2, IMG, IMG, 3)), train=False))(jax.random.PRNGKey(2))
    template = jax.tree_util.tree_map(np.asarray, template)
    variables, loaded_j, _ = jax_import(template, path, from_pretrain=True,
                                        flavor=flavor)
    model = _port_model(False)
    model.load_state_dict(state_dict_from_flax(template["params"],
                                               template["batch_stats"]))
    loaded, missing = import_seg_vit(model, path, True, flavor)
    assert sorted(k[len("encoder."):] for k in loaded) == sorted(loaded_j)
    assert len(loaded) == 3 + 12 * 2 + 1  # embed, cls, 2 blocks, pos_embed
    assert all(k.startswith(("encoder.seg_head.", "decoder."))
               for k in missing)
    want = state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"]),
        jax.tree_util.tree_map(np.asarray, variables["batch_stats"]))
    for k, t in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(t.numpy(), want[k].numpy(), rtol=0,
                                       atol=2e-6, err_msg=k)


# ---------------------------------------------------------------------------
# data


SEG_DATASETS = ("SIIMSegmentationDataset", "RSNASegmentationDataset",
                "RIGASegmentationDataset")


@pytest.fixture(scope="module")
def seg_corpora(tmp_path_factory):
    """task -> a seeded corpus at 96 px (RIGA 96 x 128)."""
    from ecamp_tpu_torch.data.synthetic import write_segmentation_corpus

    root = tmp_path_factory.mktemp("seg")
    return {task: write_segmentation_corpus(str(root / task), task, 12, 5, 4,
                                            seed=1, img_size=96)
            for task in ("SIIM", "RSNA", "RIGA")}


@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8"])
@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("cls", SEG_DATASETS)
def test_seg_datasets_match_jax(seg_corpora, cls, split, u8):
    """Every sample of the three datasets against the JAX package's (pandas
    and cv2 there, csv and numpy here) on the seeded corpus, the train
    split with its ShiftScaleRotate after a worker reseed: the same images
    (SIIM's balanced ids in the same order), f32 images within 1e-5
    (OpenCV's and the numpy resizes differ by float32 rounding), u8 images
    within one gray level and masks within 1e-6."""
    from ecamp_tpu.data import datasets as jd
    from ecamp_tpu_torch.data import datasets as pd_

    task = cls[:4]
    root = seg_corpora[task]
    j = getattr(jd, cls)(root, root, split, img_size=48, seed=3,
                         output_u8=u8)
    p = getattr(pd_, cls)(root, root, split, img_size=48, seed=3,
                          output_u8=u8)
    assert len(p) == len(j) > 0
    if task == "SIIM":
        assert p.img_ids == j.img_ids
    j.reseed(1, 0)
    p.reseed(1, 0)
    for i in range(len(p)):
        a, b = j[i], p[i]
        assert b["image"].dtype == a["image"].dtype
        assert b["image"].shape == a["image"].shape
        assert b["mask"].dtype == np.float32
        tol = 1 if u8 else 1e-5
        assert np.abs(b["image"].astype(np.float32)
                      - a["image"].astype(np.float32)).max() <= tol
        np.testing.assert_allclose(b["mask"], a["mask"], rtol=0, atol=1e-6)
    channels = 3 if (task == "RIGA" or not u8) else 1
    assert b["image"].shape == (48, 48, channels)
    assert b["mask"].shape == (48, 48, 2 if task == "RIGA" else 1)


@pytest.mark.parametrize("method", ["area", "linear"])
def test_numpy_resizes_match_cv2(method):
    """The numpy INTER_AREA / INTER_LINEAR resizes against OpenCV's on
    float32 data in [0, 255]: shrinking, enlarging, both at once, integer
    and fractional scales, 2-D and 3-channel. The measured worst gap is
    6.1e-5 (float32 rounding of sums near 255); held to 1e-4."""
    cv2 = pytest.importorskip("cv2")
    from ecamp_tpu_torch.data.datasets import _cv_resize

    flag = {"area": cv2.INTER_AREA, "linear": cv2.INTER_LINEAR}[method]
    rng = np.random.default_rng(0)
    for shape in ((1024, 1024), (96, 96, 3), (300, 217, 3), (57, 100)):
        a = (rng.random(shape) * 255).astype(np.float32)
        for size in ((224, 224), (224, 161), (37, 224), (448, 448), (48, 48)):
            want = cv2.resize(a, size, interpolation=flag)
            got = _cv_resize(a, *size, method)
            assert got.dtype == np.float32 and got.shape == want.shape
            assert np.abs(got - want).max() <= 1e-4, (shape, size)


def test_rle_round_trip_and_siim_balancing(tmp_path):
    """`mask2rle` inverts the reference decoder; the SIIM training split
    keeps every positive and as many negatives, and a list without the
    pandas integer quirk reads "-1" rows as negatives."""
    from ecamp_tpu.data.datasets import rle2mask as jax_rle2mask
    from ecamp_tpu_torch.data.datasets import SIIMSegmentationDataset
    from ecamp_tpu_torch.data.synthetic import (mask2rle,
                                                write_segmentation_corpus)

    m = np.zeros((1024, 1024), bool)
    m[100:200, 300:350] = True
    m[1020:, 0:3] = True
    np.testing.assert_array_equal(jax_rle2mask(mask2rle(m), 1024, 1024), m)
    root = write_segmentation_corpus(str(tmp_path), "SIIM", 30, 2, 2, seed=4,
                                     img_size=32, positive_rate=0.2)
    with open(os.path.join(root, "SIIM", "train_list.csv")) as f:
        rows = [line.strip().split(",") for line in f][1:]
    pos = {i for i, r in rows if r != "-1"}
    ds = SIIMSegmentationDataset(root, root, "train", img_size=32, seed=4)
    assert len(ds) == 2 * len(pos)
    assert ds.img_ids[:len(pos)] == [i for i in dict.fromkeys(
        r[0] for r in rows) if i in pos]


# ---------------------------------------------------------------------------
# CLI and serving


def _tiny_vit(**kw):
    return pcfg.ViTConfig(patch_size=16, embed_dim=32, depth=2, num_heads=2,
                          **kw)


@pytest.fixture
def tiny_cli(monkeypatch):
    from ecamp_tpu_torch.cli import finetune_seg as cli

    monkeypatch.setitem(cli._VIT_FACTORY, "tiny", _tiny_vit)
    return cli


def _cli_args(root, out, *extra):
    return ["--dataset_path", root, "--model", "tiny", "--img_size", "32",
            "--decode_features", "16,8,8,4", "--batch_size", "8",
            "--eval_batch_size", "4", "--lr", "1e-2", "--warmup_steps", "1",
            "--device", "cpu", "--num_workers", "2", "--no_bf16",
            "--output_dir", out, *extra]


@pytest.mark.parametrize("task", ["SIIM", "RIGA"])
def test_cli_trains_stops_early_and_tests(tmp_path, tiny_cli, capsys, task):
    """A tiny CPU run: validations every epoch of updates (JAX's log.txt
    keys), the best `.pth` written in the reference namespace, an early
    stop at patience 1 or the step budget, then the test line from the
    reloaded best model."""
    import json

    from ecamp_tpu_torch.data.synthetic import write_segmentation_corpus

    root = write_segmentation_corpus(str(tmp_path / "data"), task, 20, 7, 5,
                                     seed=0, img_size=64)
    out = str(tmp_path / "out")
    dice = tiny_cli.main(["--task", task, "--num_steps", "8", "--patience",
                          "1"] + _cli_args(root, out))
    printed = capsys.readouterr().out
    with open(os.path.join(out, "log.txt")) as f:
        recs = [json.loads(line) for line in f]
    vals = [r for r in recs if "step" in r]
    n_train = len(tiny_cli.DATASETS[task](root, root, "train", img_size=32))
    per_epoch = n_train // 8
    assert [r["step"] for r in vals] == [per_epoch * (i + 1)
                                         for i in range(len(vals))]
    assert all({"dice", "best", "loss"} <= set(r) for r in vals)
    assert recs[-1] == {"test_dice": dice} and 0.0 <= dice <= 1.0
    if vals[-1]["step"] < 8:  # stopped early: no better dice at the last
        assert len(vals) >= 2 and vals[-1]["dice"] <= vals[-2]["best"]
    assert f"TEST dice: {dice:.4f}" in printed
    best = os.path.join(out, "best", "checkpoint-best.pth")
    sd = torch.load(best, weights_only=True)["model"]
    assert "encoder.seg_head.weight" in sd and (
        "decoder_cup.decoder_4.1.num_batches_tracked" in sd
        if task == "RIGA" else "decoder.final_out.bias" in sd)


def test_cli_refuses_an_empty_epoch_and_what_is_not_ported(
        tmp_path, tiny_cli, monkeypatch):
    """A training split smaller than one batch raises (the JAX CLI would
    spin without a step); the ResNet-50 baseline on RIGA raises (it has
    one decoder, as in JAX); `--resume` raises, naming ROADMAP's "Not to
    port" list (the JAX CLI reads it nowhere: a rerun with the same
    --output_dir resumes); `ECAMP_PREEMPT_AT_STEP` is honoured, so the
    empty epoch is what raises under it."""
    from ecamp_tpu_torch.data.synthetic import write_segmentation_corpus

    root = write_segmentation_corpus(str(tmp_path / "data"), "SIIM", 3, 2,
                                     2, seed=0, img_size=32)
    out = str(tmp_path / "out")
    with pytest.raises(ValueError, match="fewer than one micro-batch"):
        tiny_cli.main(["--task", "SIIM"] + _cli_args(root, out))
    with pytest.raises(ValueError, match="single-decoder"):
        tiny_cli.main(["--task", "RIGA"] + _cli_args(root, out)
                      + ["--model", "resnet50"])
    with pytest.raises(NotImplementedError,
                       match="same --output_dir.*Not to port"):
        tiny_cli.main(["--task", "SIIM", "--resume", "x"]
                      + _cli_args(root, out))
    monkeypatch.setenv("ECAMP_PREEMPT_AT_STEP", "3")
    with pytest.raises(ValueError, match="fewer than one micro-batch"):
        tiny_cli.main(["--task", "SIIM"] + _cli_args(root, out))


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
def test_segmenter_engine_matches_jax(tmp_path, dual):
    """`segmenter_engine` on a `.pth` the port wrote against the JAX
    package's on the same file (fp32): sigmoid masks within 1e-5 (RIGA:
    disc and cup concatenated), and `PredictionService` with task
    'segmentation' gives JAX's `_summarize_mask` of the same mask."""
    from ecamp_tpu.serve.http_server import _summarize_mask as jax_summary
    from ecamp_tpu.serve.loaders import segmenter_engine as jax_engine
    from ecamp_tpu_torch.cli.finetune_cls import save_best
    from ecamp_tpu_torch.serve import segmenter_engine
    from ecamp_tpu_torch.serve.http_server import (PredictionService,
                                                   _summarize_mask)

    cls = SegViTDual if dual else SegViT
    model = cls(_vit(pcfg), generator=torch.Generator().manual_seed(2))
    with torch.no_grad():  # a bias that puts part of the mask over 0.5
        for name in cls.DECODERS:
            getattr(model, name).final_out.bias.fill_(0.3)
    model(torch.from_numpy(_images(7)), train=True)
    path = str(tmp_path / "seg.pth")
    save_best(path, model)
    x = _images(8, n=3)
    engine = segmenter_engine(path, img_size=IMG, dual=dual, vit=_vit(pcfg),
                              buckets=(4,), bf16=False, device="cpu")
    got = engine(x)
    want = np.asarray(jax_engine(path, img_size=IMG, dual=dual,
                                 vit=_vit(jcfg), buckets=(4,), mesh=_mesh(),
                                 bf16=False)(x))
    assert got.shape == (3, IMG, IMG, 2 if dual else 1)
    assert got.dtype == np.float32
    _close(got, want, 1e-5, "served masks")
    service = PredictionService(engine, img_size=IMG, micro_batch=False,
                                task="segmentation")
    shaped = service.predict(x)
    for i, r in enumerate(shaped):
        assert r == _summarize_mask(got[i]) == jax_summary(got[i])
    assert (shaped[0]["channels"][0] if dual else shaped[0])[
        "area_fraction"] > 0
