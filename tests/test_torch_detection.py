"""The port's detection fine-tune (ecamp_tpu_torch.nn.det, ops.yolo,
ops.boxes, train.detection, cli.finetune_det, the RSNA/ObjectCXR datasets
and the detector engine) against the JAX package, on the CPU, at a tiny
size: ViT img 32, patch 16, dim 32, depth 2, 2 heads, B = 4, fp32; the
neck and the YOLO head at their fixed widths (512/1024/2048), on 4^2 /
2^2 / 1^2 maps.

Weights go JAX init (BatchNorm scales, biases and statistics perturbed so
they are not the identity) -> `state_dict_from_flax` -> strict
`load_state_dict`. Inputs come from numpy seeds. The JAX functions are
jitted once per configuration and shared by the module (the head's ~20M
parameters make each compile slow); the JAX package runs its kernels'
plain references on the CPU, the port its kernels' plain versions.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ecamp_tpu.core import config as jcfg  # noqa: E402
from ecamp_tpu.core.mesh import make_mesh  # noqa: E402
from ecamp_tpu.nn.det import DetectionModel as JaxDetectionModel  # noqa: E402
from ecamp_tpu.train.detection import \
    DetectionTask as JaxTask  # noqa: E402
from ecamp_tpu_torch.ckpt import state_dict_from_flax  # noqa: E402
from ecamp_tpu_torch.core import config as pcfg  # noqa: E402
from ecamp_tpu_torch.nn.det import YOLO_ANCHORS, DetectionModel  # noqa: E402
from ecamp_tpu_torch.train.detection import DetectionTask  # noqa: E402

B, IMG, T = 4, 32, 10
GRAD_IMG = 64  # the loss, gradient and AdamW parities: 8^2 / 4^2 / 2^2 maps
GRAD_GRIDS = (GRAD_IMG // 32, GRAD_IMG // 16, GRAD_IMG // 8)
LR = 1e-4  # the task's lr (see test_adamw_steps_match_jax)
EXPANSIONS = (4, 8)
# the tiny model's three maps, coarse to fine
GRIDS = (IMG // 32, IMG // 16, IMG // 8)


def _vit(lib, img=IMG):
    return lib.ViTConfig(img_size=img, patch_size=16, embed_dim=32, depth=2,
                         num_heads=2)


def _mesh():
    return make_mesh(jcfg.MeshConfig(data=1), devices=jax.devices()[:1])


def _jax_model(expansion=4, img=IMG):
    return JaxDetectionModel(_vit(jcfg, img), expansion=expansion)


def _port_model(expansion=4, seed=0):
    return DetectionModel(_vit(pcfg), expansion=expansion,
                          generator=torch.Generator().manual_seed(seed))


def _perturb(variables, seed):
    """Non-trivial BatchNorm scales, biases and running statistics."""
    rng = np.random.default_rng(seed)
    v = jax.tree_util.tree_map(np.asarray, variables)

    def walk(p, s):
        for k in p:
            if k.startswith("bn") and "scale" in p[k]:
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
    """expansion -> perturbed JAX variables at IMG, numpy leaves."""
    out = {}
    for e in EXPANSIONS:
        model = _jax_model(e)
        v = jax.jit(lambda r: model.init(
            r, jnp.zeros((2, IMG, IMG, 3)), train=False))(
                jax.random.PRNGKey(e))
        out[e] = _perturb(v, seed=e)
    return out


@pytest.fixture(scope="module")
def jax_vars_grad(jax_vars):
    """expansion -> the variables of `jax_vars` at GRAD_IMG: only the
    trunk's `pos_embed` depends on the image size, so it is drawn anew
    for the 4x4 patch grid (no second JAX init)."""
    out = {}
    for e, v in jax_vars.items():
        v = jax.tree_util.tree_map(np.copy, v)
        trunk = v["params"]["backbone"]["encoder"]["trunk"]
        n = (GRAD_IMG // 16) ** 2 + 1
        trunk["pos_embed"] = (0.02 * np.random.default_rng(e).normal(
            size=(1, n, trunk["pos_embed"].shape[-1]))).astype(np.float32)
        out[e] = v
    return out


@pytest.fixture(scope="module")
def jax_apply():
    """(expansion, train) -> the jitted JAX forward, shared by the tests."""
    return {(e, train): jax.jit(functools.partial(
        _jax_model(e).apply, train=train,
        mutable=["batch_stats"] if train else False))
        for e in EXPANSIONS for train in (False, True)}


def _port_from(variables, expansion=4):
    m = _port_model(expansion)
    m.load_state_dict(state_dict_from_flax(variables["params"],
                                           variables["batch_stats"]),
                      strict=True)
    return m.eval()


def _images(seed, n=B, img=IMG):
    return np.random.default_rng(seed).normal(
        size=(n, img, img, 3)).astype(np.float32)


def _targets(seed, n=B, distinct=True, grids=GRIDS):
    """(n, T, 5) rows [0, cx, cy, w, h]: 1-4 boxes an image, the rest
    padding. With `distinct` no two boxes of an image share a cell at any
    of `grids` (so no two can collide on an (anchor, cell))."""
    rng = np.random.default_rng(seed)
    t = np.zeros((n, T, 5), np.float32)
    for b in range(n):
        cells, k = set(), 0
        for _ in range(int(rng.integers(1, 5))):
            for _try in range(100):
                cx, cy = rng.uniform(0.05, 0.95, 2)
                key = {(int(cx * g), int(cy * g), g) for g in grids}
                if not (distinct and key & cells):
                    break
            else:
                break
            cells |= key
            t[b, k] = [0, cx, cy, *rng.uniform(0.05, 0.7, 2)]
            k += 1
    return t


def _close(got, want, rtol, atol, what=""):
    """max |got - want| <= rtol times the reference's scale (at least 1)
    plus atol."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = rtol * max(1.0, float(np.abs(want).max())) + atol
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: max|err| {err:.3e} > {bound:.3e}"


def _stats_of(model):
    return {k: v for k, v in model.state_dict().items() if "running_" in k}


# ---------------------------------------------------------------------------
# model


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("expansion", EXPANSIONS)
def test_forward_matches_jax(jax_vars, jax_apply, expansion, train):
    """The three NCHW maps from the same weights within 1e-4 of each map's
    scale + 1e-5 (in training mode the batch statistics of 4 samples
    normalise 1^2 maps: both sides sit ~5e-5 of the scale from an fp64
    forward); the running statistics the training forward leaves within
    1e-5 of flax's (momentum 0.9, biased fast variance)."""
    v = jax_vars[expansion]
    x = _images(1)
    out = jax_apply[expansion, train](v, jnp.asarray(x))
    if train:
        out, mutated = out
    port = _port_from(v, expansion)
    with torch.no_grad():
        got = port(torch.from_numpy(x), train=train)
    for g, w, grid in zip(got, out, GRIDS):
        assert g.shape == (B, 18, grid, grid) and g.dtype == torch.float32
        _close(g.numpy(), w, 1e-4, 1e-5, f"map {grid}")
    stats = _stats_of(port)
    assert len(stats) == 2 * 29
    if train:
        want = state_dict_from_flax(v["params"], mutated["batch_stats"])
        for k, t in stats.items():
            _close(t.numpy(), want[k].numpy(), 1e-5, 0.0, k)
    else:
        want = state_dict_from_flax(v["params"], v["batch_stats"])
        for k, t in stats.items():
            assert torch.equal(t, want[k]), k


def test_full_width_tree_and_namespace():
    """The full-width detector has the reference's sizes (116,628,534
    parameters; with the encoder frozen 30,831,414 trainable in 100 leaves;
    27,648 BatchNorm statistics in 29 BatchNorms) and `state_dict()` names
    in `export_detector`'s namespace; an unknown backbone raises."""
    from ecamp_tpu_torch.train.detection import det_freeze_mask

    m = DetectionModel(pcfg.ViTConfig())
    mask = det_freeze_mask(m)
    assert sum(p.numel() for p in m.parameters()) == 116_628_534
    assert sum(p.numel() for k, p in m.named_parameters()
               if mask[k]) == 30_831_414
    assert sum(mask.values()) == 100
    sd = m.state_dict()
    assert sum(t.numel() for k, t in sd.items() if "running_" in k) == 27_648
    for key in ("backbone.encoder.blocks.11.attn.qkv.weight",
                "backbone.encoder.det_head.weight",
                "backbone.layers.traspose.bias",
                "backbone.layers.layer3.bn3.running_var",
                "embedding0.5.conv.weight", "embedding0.conv_out.bias",
                "embedding1_cbl.bn.num_batches_tracked",
                "embedding2.4.bn.weight"):
        assert key in sd, key
    assert "backbone.layers.downsample.bias" not in sd
    assert not any(k.startswith("head.") for k in sd)
    assert mask["backbone.encoder.det_head.weight"]
    assert not mask["backbone.encoder.blocks.0.norm1.weight"]
    with pytest.raises(ValueError, match="unknown detector backbone"):
        DetectionModel(pcfg.ViTConfig(), backbone="resnet101")


def test_freeze_mask_and_config_match_jax(jax_vars):
    """`det_freeze_mask` names the leaves JAX's `_det_freeze_mask` trains,
    and `DetectionConfig` holds the JAX config's fields and defaults (but
    `mesh`), the mAP thresholds .40:.05:.75 included."""
    import dataclasses

    from ecamp_tpu.train.detection import _det_freeze_mask
    from ecamp_tpu_torch.train.detection import det_freeze_mask

    v = jax_vars[4]
    jmask = _det_freeze_mask(v["params"], True)
    want = {k: bool(t) for k, t in state_dict_from_flax(
        jax.tree_util.tree_map(np.float32, jmask)).items()}
    assert det_freeze_mask(_port_from(v)) == want
    jd = dataclasses.asdict(jcfg.DetectionConfig())
    jd.pop("mesh")
    assert dataclasses.asdict(pcfg.DetectionConfig()) == jd
    assert pcfg.DetectionConfig().map_iou_thresholds == (
        0.4, 0.45, 0.5, 0.55, 0.6, 0.65, 0.7, 0.75)


@pytest.mark.parametrize("shape", [(2, 5, 7, 3), (1, 1, 1, 4), (3, 2, 4, 1)])
def test_upsample_nearest_matches_jax(shape):
    """`F.interpolate(mode="nearest")` x2 on NCHW equals JAX's `repeat` on
    NHWC exactly; the gradient (each input's sum of its 4 copies, added in
    another order) within 1e-6."""
    from ecamp_tpu.ops.image_ops import upsample_nearest as jax_up
    from ecamp_tpu_torch.ops.image_ops import upsample_nearest

    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=shape).astype(np.float32)
    n, h, w, c = shape
    g = rng.normal(size=(n, 2 * h, 2 * w, c)).astype(np.float32)
    want, vjp = jax.vjp(lambda t: jax_up(t, 2), jnp.asarray(x))
    (gx_want,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    got = upsample_nearest(xt, 2).permute(0, 2, 3, 1)
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(gx_want), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# YOLO targets and loss

ANCHORS = np.asarray([[3.0, 2.5], [6.0, 5.0], [10.0, 9.0]], np.float32)


def _port_targets(targets, anchors, grid):
    from ecamp_tpu_torch.ops.yolo import build_targets

    out = build_targets(torch.from_numpy(targets), torch.from_numpy(anchors),
                        grid, num_classes=1)
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("grid", [2, 7, 14])
def test_build_targets_match_jax_without_collisions(grid):
    """On targets whose boxes never share a cell, every map equals JAX's:
    the masks exactly, the offsets and log sizes within 1e-6 (XLA's and
    torch's `log` differ by an ulp). JAX's winner of a collision is
    unspecified, so none is made here."""
    from ecamp_tpu.ops.yolo import build_targets as jax_build

    t = _targets(grid, n=6, grids=(grid,))
    anchors = ANCHORS * grid / 14
    want = jax_build(jnp.asarray(t), jnp.asarray(anchors), grid, 1)
    got = _port_targets(t, anchors, grid)
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == np.float32
        if k in ("tx", "ty", "tw", "th"):
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                          err_msg=k)
    assert got["mask"].sum() == (t.sum(-1) > 0).sum()


def _colliding_targets(rng, grid, n=3):
    """Boxes of each image drawn into two cells, so several boxes of an
    image share an (anchor, cell); the sizes repeat too, so they pick the
    same anchor."""
    t = np.zeros((n, T, 5), np.float32)
    for b in range(n):
        cells = rng.integers(0, grid, (2, 2))
        sizes = rng.uniform(0.05, 0.6, (2, 2))
        for i in range(rng.integers(4, T + 1)):
            c = i % 2
            t[b, i, 1:3] = (cells[c] + rng.uniform(0.1, 0.9, 2)) / grid
            t[b, i, 3:] = sizes[rng.integers(0, 2)]
    return t


@pytest.mark.parametrize("grid", [7, 14])
def test_build_targets_later_box_wins_on_collisions(grid):
    """Colliding boxes: every map equals the reference's sequential loop
    (`tests/test_yolo_parity.py::_loop_reference`), where the later box
    overwrites; the test makes sure collisions happened and that the
    winner was not the first box."""
    from test_yolo_parity import _loop_reference

    rng = np.random.default_rng(grid)
    anchors = ANCHORS * grid / 14
    t = _colliding_targets(rng, grid)
    want = _loop_reference(t, anchors, grid, num_classes=1)
    got = _port_targets(t, anchors, grid)
    n_boxes = int((t.sum(-1) > 0).sum())
    assert got["mask"].sum() < n_boxes  # collisions happened
    for k in ("mask", "noobj_mask", "tconf", "tcls"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("tx", "ty", "tw", "th"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    # the first box of a collision loses: drop the later boxes, and its
    # own offsets come back
    first = t.copy()
    first[:, 1:] = 0
    alone = _port_targets(first, anchors, grid)
    assert not np.array_equal(alone["tx"], got["tx"])


def test_build_targets_ignore_padding_rows():
    """All-zero rows anywhere in the (B, T, 5) targets change nothing."""
    t = _targets(3, n=4)
    packed = np.zeros((4, 2 * T, 5), np.float32)
    rng = np.random.default_rng(0)
    for b in range(4):
        rows = t[b][t[b].sum(-1) > 0]
        slots = np.sort(rng.choice(2 * T, len(rows), replace=False))
        packed[b, slots] = rows
    for grid in GRIDS + (7,):
        anchors = ANCHORS * grid / 14
        a, b = _port_targets(t, anchors, grid), _port_targets(packed,
                                                             anchors, grid)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("case", ["random", "saturated"])
def test_yolo_loss_parts_match_jax(case):
    """Each scale's total and its six parts (x, y, w, h, conf, cls) within
    1e-5 relative of JAX's, and the gradient in the logits within 1e-5 of
    its scale; 'saturated' drives every probability to 0 or 1, so BCE's
    clip and -100 clamp act (their gradient is zero)."""
    from ecamp_tpu.ops.yolo import yolo_loss as jax_loss
    from ecamp_tpu_torch.ops.yolo import yolo_loss

    rng = np.random.default_rng(7)
    t = _targets(8, n=B, grids=(7, 14, 28))
    for i, grid in enumerate((7, 14, 28)):
        logits = rng.normal(size=(B, 18, grid, grid)).astype(np.float32)
        if case == "saturated":
            logits = np.sign(logits) * 200.0
        (want, parts_j), g_j = jax.value_and_grad(
            lambda z: jax_loss(z, jnp.asarray(t), YOLO_ANCHORS[i], 224),
            has_aux=True)(jnp.asarray(logits))
        lt = torch.from_numpy(logits).requires_grad_(True)
        got, parts = yolo_loss(lt, torch.from_numpy(t), YOLO_ANCHORS[i], 224)
        got.backward()
        assert set(parts) == set(parts_j)
        for k in parts:
            w = float(parts_j[k])
            assert abs(float(parts[k]) - w) <= 1e-5 * max(abs(w), 1e-6), k
        assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
        _close(lt.grad.numpy(), np.asarray(g_j), 1e-5, 0.0, f"grad {grid}")
        assert np.isfinite(lt.grad.numpy()).all()


# ---------------------------------------------------------------------------
# the task


def _cfg(lib, freeze=True, expansion=4, img=IMG):
    kw = {"mesh": lib.MeshConfig(data=1)} if lib is jcfg else {}
    return lib.DetectionConfig(
        vit=_vit(lib, img),
        optimizer=lib.OptimizerConfig(
            name="adamw", lr=LR, weight_decay=0.05, betas=(0.9, 0.999),
            schedule="warmup_cosine_step", warmup_steps=0, total_steps=8,
            grad_clip=1.0),
        img_size=img, expansion=expansion, freeze_encoder=freeze, bf16=False,
        seed=5, **kw)


# The loss, gradient and AdamW parities run in float64 on both sides (the
# fp32 islands of both stay: the YOLO loss, `conv_out`, the LayerNorm and
# attention references' statistics) at GRAD_IMG. At IMG in fp32 any two
# implementations part by ~4e-3 of a gradient's scale: BatchNorm
# normalises 1^2 maps over 4 samples, and an activation within rounding of
# a ReLU kink takes either branch (measured: the port and JAX each 4.3e-3
# from a float64 run); in float64 at IMG still 1e-4 (BatchNorm over 4
# samples amplifies the fp32 islands' rounding); in float64 at GRAD_IMG,
# 1.8e-6.


def _to_fp64(model: torch.nn.Module) -> torch.nn.Module:
    model.double()
    for m in model.modules():
        if getattr(m, "dtype", None) == torch.float32:
            m.dtype = torch.float64
    return model


def _vars64(variables):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                  variables)


def _jax_task64(freeze=True, expansion=4):
    task = JaxTask(_cfg(jcfg, freeze, expansion, GRAD_IMG), mesh=_mesh())
    task.model = JaxDetectionModel(_vit(jcfg, GRAD_IMG), expansion=expansion,
                                   dtype=jnp.float64)
    return task


def _port_task64(variables, freeze=True, expansion=4):
    task = DetectionTask(_cfg(pcfg, freeze, expansion, GRAD_IMG),
                         device="cpu")
    task.model.load_state_dict(state_dict_from_flax(
        variables["params"], variables["batch_stats"]), strict=True)
    _to_fp64(task.model)
    return task


def _trunk(k):
    return k.startswith("backbone.encoder.") and not k.startswith(
        "backbone.encoder.det_head.")


@pytest.mark.parametrize("freeze", [True, False], ids=["frozen", "full"])
def test_loss_and_grads_match_jax(jax_vars_grad, freeze):
    """`DetectionTask`'s summed three-scale loss (1e-5 relative) and each
    scale's, its gradients (rtol 1e-4, atol 1e-6) and the BatchNorm
    statistics it leaves (1e-5), against the JAX task's `_loss` under
    `value_and_grad`, on u8 images normalised on the device, in float64
    (see `_to_fp64`). With the encoder frozen the trunk records no graph:
    no gradient at all in the port, zeros in JAX."""
    v = jax_vars_grad[4]
    x = np.random.default_rng(2).integers(0, 256, (B, GRAD_IMG, GRAD_IMG, 1),
                                          dtype=np.uint8)
    t = _targets(3, grids=GRAD_GRIDS)
    with jax.enable_x64(True):
        task_j = _jax_task64(freeze)
        v64 = _vars64(v)
        (loss_j, (stats_j, parts_j)), g_j = jax.jit(jax.value_and_grad(
            task_j._loss, has_aux=True))(v64["params"], v64["batch_stats"],
                                         jnp.asarray(x), jnp.asarray(t),
                                         jax.random.PRNGKey(0))
        loss_j, parts_j, g_j, stats_j = jax.tree_util.tree_map(
            np.asarray, (loss_j, parts_j, g_j, stats_j))
    task = _port_task64(v, freeze)
    task.model.eval()
    loss, parts = task.loss(torch.from_numpy(x), torch.from_numpy(t))
    loss.backward()
    assert abs(float(loss.detach()) - float(loss_j)) <= 1e-5 * abs(
        float(loss_j))
    for k, w in parts_j.items():
        assert abs(float(parts[k]) - float(w)) <= 1e-5 * abs(float(w)), k
    want = state_dict_from_flax(g_j)
    for k, p in task.model.named_parameters():
        if freeze and _trunk(k):
            assert p.grad is None, k
            assert not np.asarray(want[k]).any(), k
            continue
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    want_stats = state_dict_from_flax(v["params"], stats_j)
    for k, s in _stats_of(task.model).items():
        _close(s.numpy(), want_stats[k].numpy(), 1e-5, 0.0, k)


def test_adamw_steps_match_jax(jax_vars_grad):
    """3 masked AdamW updates past the warmup (lr 1e-4, warmup-cosine, clip
    1.0, weight decay 0.05 on the >= 2-D leaves, the encoder frozen), in
    float64 (see `_to_fp64`): the parameters and the BatchNorm running
    statistics within 1e-4 of the JAX task's, which runs its AdamW under
    the freeze mask, while each trainable element moves by about lr a
    step; the lr and the loss of each step agree, and the trunk stays
    bit-unchanged.

    The lr is 1e-4, not 1e-3: Adam's first steps move every element by
    about lr, 5% of a fresh 2048-fan-in weight at 1e-3, and the
    coarse map's BatchNorm (16 samples) then turns the 5e-5 parameter gaps
    of elements whose gradient is at the rounding floor into 3.5%
    gradient gaps one step later (measured); at 1e-4 the gaps stay under
    6e-6 over the 3 steps."""
    v = jax_vars_grad[8]
    task = _port_task64(v, expansion=8)
    state = task.init_state()
    before = {k: t.clone() for k, t in task.model.state_dict().items()}
    with jax.enable_x64(True):
        task_j = _jax_task64(expansion=8)
        state_j = task_j.init_state(jax.random.PRNGKey(0))
        v64 = _vars64(v)
        state_j = state_j.replace(
            params=v64["params"], batch_stats=v64["batch_stats"],
            opt_state=task_j.tx.init(v64["params"]))
    for i in range(3):
        x = _images(10 + i, img=GRAD_IMG)
        t = _targets(20 + i, grids=GRAD_GRIDS)
        with jax.enable_x64(True):
            state_j, m_j = task_j.train_step(state_j, jnp.asarray(x),
                                             jnp.asarray(t))
        state, m = task.train_step(state, torch.from_numpy(x),
                                   torch.from_numpy(t))
        assert abs(float(m["loss"]) - float(m_j["loss"])) <= 1e-4 * abs(
            float(m_j["loss"]))
        np.testing.assert_allclose(float(m["lr"]), float(m_j["lr"]),
                                   rtol=1e-6)
        assert float(m["lr"]) > 0
        want = state_dict_from_flax(
            jax.tree_util.tree_map(np.asarray, state_j.params),
            jax.tree_util.tree_map(np.asarray, state_j.batch_stats))
        for k, s in task.model.state_dict().items():
            if k.endswith("num_batches_tracked"):
                assert int(s) == i + 1, k
                continue
            np.testing.assert_allclose(s.numpy(), want[k].numpy(), rtol=0,
                                       atol=1e-4, err_msg=f"{k} step {i}")
    moved = task.model.embedding0.conv_out.weight - before[
        "embedding0.conv_out.weight"]
    assert float(moved.abs().max()) > 2e-4
    assert int(state.step) == int(state_j.step) == 3
    for k, s in task.model.state_dict().items():
        assert torch.equal(s, before[k]) == _trunk(k), k


@pytest.mark.parametrize("grid", GRIDS + (7, 14, 28))
def test_decode_yolo_matches_jax(grid):
    """The decode of one map to (B, 3 * G^2, 6) pixel boxes, objectness
    and class score within 1e-5 of JAX's (relative to the output's
    scale)."""
    from ecamp_tpu.ops.boxes import decode_yolo as jax_decode
    from ecamp_tpu_torch.ops.boxes import decode_yolo

    i = {1: 0, 7: 0, 2: 1, 14: 1}.get(grid, 2)
    logits = np.random.default_rng(grid).normal(
        size=(B, 18, grid, grid)).astype(np.float32)
    img = 224 if grid >= 7 else IMG
    want = jax_decode(jnp.asarray(logits), YOLO_ANCHORS[i], img, 1)
    got = decode_yolo(torch.from_numpy(logits), YOLO_ANCHORS[i], img, 1)
    assert got.shape == (B, 3 * grid * grid, 6) and got.dtype == torch.float32
    _close(got.numpy(), want, 1e-5, 0.0, "decoded")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_and_map_match_jax(seed):
    """The numpy copies of NMS and the COCO-style mAP give the JAX
    package's answers on random candidates (clustered around a few boxes,
    so suppression and matching both act); `DetectionTask.compute_map`
    equals JAX's."""
    from ecamp_tpu.ops import boxes as jb
    from ecamp_tpu_torch.ops import boxes as pb

    rng = np.random.default_rng(seed)
    n, k = 5, 60
    centres = rng.uniform(40, 180, (n, 3, 2))
    pick = rng.integers(0, 3, (n, k))
    preds = np.zeros((n, k, 6), np.float32)
    preds[..., :2] = np.take_along_axis(centres, pick[..., None], 1) + \
        rng.normal(0, 6, (n, k, 2))
    preds[..., 2:4] = rng.uniform(20, 60, (n, k, 2))
    preds[..., 4] = rng.uniform(0, 1, (n, k))
    preds[..., 5] = rng.uniform(0.5, 1, (n, k))
    for conf, thr in ((0.5, 0.5), (0.3, 0.3)):
        want = jb.nms(preds, 1, conf, thr)
        got = pb.nms(preds, 1, conf, thr)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                np.testing.assert_array_equal(g, w)
    dets = pb.nms(preds, 1, 0.3, 0.5)
    gts = [np.concatenate([c - 18, c + 18], axis=1)[:rng.integers(0, 4)]
           for c in centres]
    ths = pcfg.DetectionConfig().map_iou_thresholds
    boxes = [np.zeros((0, 4)) if d is None else d[:, :4] for d in dets]
    scores = [np.zeros((0,)) if d is None else d[:, 4] for d in dets]
    ap = pb.average_precision(boxes, scores, gts, ths)
    assert ap == jb.average_precision(boxes, scores, gts, ths)
    task_j = JaxTask(_cfg(jcfg), mesh=_mesh())
    task = DetectionTask(_cfg(pcfg), device="cpu")
    assert task.compute_map(dets, gts) == task_j.compute_map(dets, gts) == ap
    tp = rng.integers(0, 2, 30).astype(np.float64)
    conf = rng.uniform(0, 1, 30)
    assert pb._coco_ap_single(tp, conf, 20) == jb._coco_ap_single(tp, conf,
                                                                  20)


# ---------------------------------------------------------------------------
# data


@pytest.fixture(scope="module")
def det_corpora(tmp_path_factory):
    """task -> a seeded corpus at 96 px."""
    from ecamp_tpu_torch.data.synthetic import write_detection_corpus

    root = tmp_path_factory.mktemp("det")
    return {task: write_detection_corpus(str(root / task), task, 8, 5, 4,
                                         seed=1, img_size=96)
            for task in ("RSNA", "ObjectCXR")}


@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8"])
@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("task", ["RSNA", "ObjectCXR"])
def test_det_datasets_match_jax(det_corpora, task, split, u8):
    """Every sample of the RSNA and ObjectCXR detection datasets against
    the JAX package's (pandas and cv2 there, csv and numpy here) on the
    seeded corpus: the same images in the same order, f32 images within
    1e-5 (OpenCV's and the numpy resize differ by float32 rounding), u8
    images within one gray level, targets equal, padded to 10 / 20
    rows."""
    from ecamp_tpu.data import datasets as jd
    from ecamp_tpu_torch.data import datasets as pd_

    name = f"{task}DetectionDataset"
    root = det_corpora[task]
    j = getattr(jd, name)(root, root, split, img_size=48, output_u8=u8)
    p = getattr(pd_, name)(root, root, split, img_size=48, output_u8=u8)
    assert len(p) == len(j) > 0
    if task == "ObjectCXR":
        assert p.names == j.names == sorted(p.names)
    positives = 0
    for i in range(len(p)):
        a, b = j[i], p[i]
        assert b["image"].dtype == a["image"].dtype
        assert b["image"].shape == a["image"].shape == (48, 48,
                                                        1 if u8 else 3)
        tol = 1 if u8 else 1e-5
        assert np.abs(b["image"].astype(np.float32)
                      - a["image"].astype(np.float32)).max() <= tol
        assert b["target"].dtype == np.float32
        assert b["target"].shape == (10 if task == "RSNA" else 20, 5)
        np.testing.assert_array_equal(b["target"], a["target"])
        positives += bool(b["target"].any())
    assert positives >= 1


# ---------------------------------------------------------------------------
# checkpoints


def _trained_port(expansion, seed):
    """A port model with seeded weights and moved running statistics."""
    model = _port_model(expansion, seed=seed)
    model(torch.from_numpy(_images(seed)), train=True)
    return model.eval()


def _jax_template(expansion=4, seed=9):
    jm = _jax_model(expansion)
    return jax.jit(lambda r: jm.init(r, jnp.zeros((2, IMG, IMG, 3)),
                                     train=False))(jax.random.PRNGKey(seed))


def test_saved_pth_loads_into_jax(tmp_path, jax_apply):
    """The `.pth` the port's CLI writes (`{"model": state_dict, "step":
    n}`, the reference namespace, BatchNorm `num_batches_tracked`
    included) loads through JAX's `import_detector(from_pretrain=False)`
    whole, to the same eval outputs (1e-4 of the scale + 1e-5)."""
    from ecamp_tpu.ckpt import import_detector as jax_import
    from ecamp_tpu_torch.cli.finetune_det import save_best

    model = _trained_port(4, seed=3)
    path = str(tmp_path / "best.pth")
    save_best(path, model, 7)
    assert torch.load(path, weights_only=True)["step"] == 7
    variables, loaded, missing = jax_import(_jax_template(), path,
                                            from_pretrain=False)
    assert missing == []
    assert len(loaded) == len([k for k in model.state_dict()
                               if not k.endswith("num_batches_tracked")])
    x = _images(4)
    want = jax_apply[4, False](variables, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for g, w in zip(got, want):
        _close(g.numpy(), w, 1e-4, 1e-5, "eval maps")


def test_jax_export_loads_into_port(tmp_path, jax_vars, jax_apply):
    """JAX's `export_detector` file (flat, no `num_batches_tracked`)
    strict-loads into the port (`load_reference_state`) with every tensor
    equal to the converter's, and gives the same eval outputs."""
    from ecamp_tpu.ckpt import export_detector
    from ecamp_tpu_torch.ckpt import load_reference_pth, load_reference_state

    v = jax_vars[8]
    path = str(tmp_path / "jax.pth")
    export_detector(v, path)
    model = load_reference_state(_port_model(8, seed=1),
                                 load_reference_pth(path)).eval()
    want = state_dict_from_flax(v["params"], v["batch_stats"])
    for k, t in model.state_dict().items():
        assert torch.equal(t, want[k].to(t.dtype)), k
    x = _images(5)
    out_j = jax_apply[8, False](v, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for g, w in zip(got, out_j):
        _close(g.numpy(), w, 1e-4, 1e-5, "eval maps")


def test_import_from_pretrain_matches_jax(tmp_path):
    """`import_detector(from_pretrain=True)` on the port's pretraining
    checkpoint (`ckpt.save_checkpoint` of a `PretrainTask` with the same
    trunk), given a `pos_embed` of a 4x4 grid: the trunk loads under
    `backbone.encoder.`, the `pos_embed` is resized to the 2x2 grid,
    `det_head`, the neck and the head keep their init; the same names and
    values as JAX's importer."""
    from ecamp_tpu.ckpt import import_detector as jax_import
    from ecamp_tpu_torch.ckpt import import_detector, save_checkpoint
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
    ckpt["model"]["pos_embed"] = torch.randn(
        1, 17, 32, generator=torch.Generator().manual_seed(5))
    torch.save(ckpt, path)

    template = jax.tree_util.tree_map(np.asarray, _jax_template(seed=2))
    variables, loaded_j, _ = jax_import(template, path, from_pretrain=True)
    model = _port_model()
    model.load_state_dict(state_dict_from_flax(template["params"],
                                               template["batch_stats"]))
    loaded, missing = import_detector(model, path, True)
    pre_ = "backbone.encoder."
    assert sorted(k[len(pre_):] for k in loaded) == sorted(loaded_j)
    assert len(loaded) == 3 + 12 * 2 + 1  # embed, cls, 2 blocks, pos_embed
    assert all(not _trunk(k) for k in missing)
    want = state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"]),
        jax.tree_util.tree_map(np.asarray, variables["batch_stats"]))
    for k, t in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(t.numpy(), want[k].numpy(), rtol=0,
                                       atol=2e-6, err_msg=k)


# ---------------------------------------------------------------------------
# CLI and serving


def _tiny_vit(**kw):
    return pcfg.ViTConfig(patch_size=16, embed_dim=32, depth=2, num_heads=2,
                          **kw)


@pytest.fixture
def tiny_cli(monkeypatch):
    from ecamp_tpu_torch.cli import finetune_det as cli

    monkeypatch.setitem(cli._VIT_FACTORY, "tiny", _tiny_vit)
    return cli


def _cli_args(root, out, *extra):
    return ["--dataset_path", root, "--model", "tiny", "--img_size", "32",
            "--batch_size", "4", "--eval_batch_size", "3", "--lr", "1e-3",
            "--warmup_steps", "1", "--device", "cpu", "--num_workers", "2",
            "--no_bf16", "--output_dir", out, *extra]


def _log(out):
    with open(os.path.join(out, "log.txt")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("task", ["RSNA", "ObjectCXR"])
def test_cli_trains_stops_early_and_tests(tmp_path, tiny_cli, capsys, task):
    """A tiny CPU run: validations every epoch of updates from
    `--start_eval` on (JAX's log.txt keys, the ragged eval batch as it
    is), the best `.pth` written in the reference namespace with its
    step, an early stop at patience 1 or the step budget, then the test
    line from the reloaded best model."""
    from ecamp_tpu_torch.data.synthetic import write_detection_corpus

    root = write_detection_corpus(str(tmp_path / "data"), task, 8, 5, 4,
                                  seed=0, img_size=64)
    out = str(tmp_path / "out")
    ap = tiny_cli.main(["--task", task, "--num_steps", "8", "--patience",
                        "1", "--start_eval", "2"] + _cli_args(root, out))
    printed = capsys.readouterr().out
    recs = _log(out)
    vals = [r for r in recs if "step" in r]
    per_epoch = 8 // 4
    assert vals and [r["step"] for r in vals] == [
        per_epoch * (i + 2) for i in range(len(vals))]  # from epoch 2
    assert all({"mAP", "best", "loss", "kernel_launches"} <= set(r)
               for r in vals)
    assert all(0.0 <= r["mAP"] <= 1.0 and np.isfinite(r["loss"])
               for r in vals)
    assert recs[-1] == {"test_map": ap} and 0.0 <= ap <= 1.0
    if vals[-1]["step"] < 8:  # stopped early: no better mAP at the last
        assert len(vals) >= 2 and vals[-1]["mAP"] <= vals[-2]["best"]
    assert f"TEST mAP@[.40:.05:.75]: {ap:.4f}" in printed
    best = torch.load(os.path.join(out, "best", "checkpoint-best.pth"),
                      weights_only=True)
    assert best["step"] in [r["step"] for r in vals]
    assert "embedding2.conv_out.weight" in best["model"] and \
        "backbone.layers.layer1.bn3.num_batches_tracked" in best["model"]


def test_cli_resume_fast_forwards_to_the_best_step(tmp_path, tiny_cli,
                                                   capsys, monkeypatch):
    """`--resume` loads the best `.pth` and sets the step counter to its
    step and the epoch to match: the run goes on from there to
    `--num_steps`, its first validation one epoch of updates after the
    restored step. As in the JAX CLI, which restores params, batch_stats
    and `step` only, the optimizer starts afresh: its update count is 0,
    so its first update runs at JAX's lr for that count (0, the warmup's
    start) and leaves every weight where the `.pth` had it."""
    from ecamp_tpu.train.optim import make_schedule as jax_schedule
    from ecamp_tpu_torch.data.synthetic import write_detection_corpus

    root = write_detection_corpus(str(tmp_path / "data"), "RSNA", 8, 3, 2,
                                  seed=2, img_size=64)
    first = str(tmp_path / "first")
    tiny_cli.main(["--num_steps", "2", "--patience", "5"]
                  + _cli_args(root, first))
    assert [r["step"] for r in _log(first) if "step" in r] == [2]
    saved = torch.load(os.path.join(first, "best", "checkpoint-best.pth"),
                       weights_only=True)

    seen = []
    real_step = DetectionTask.train_step

    def spy(self, state, images, targets):
        # the step and count the first update starts from (both advance
        # in place), then the parameters it leaves
        count = state.opt_state.count
        start = (int(state.step), int(count),
                 float(self.tx.inner.schedule(count)))
        new, m = real_step(self, state, images, targets)
        if not seen:
            seen.append(start + ({k: p.detach().clone()
                                  for k, p in self.model.named_parameters()},))
        return new, m

    monkeypatch.setattr(DetectionTask, "train_step", spy)
    second = str(tmp_path / "second")
    tiny_cli.main(["--num_steps", "6", "--patience", "5", "--resume", first]
                  + _cli_args(root, second))
    assert "resumed from step 2" in capsys.readouterr().out
    assert [r["step"] for r in _log(second) if "step" in r] == [4, 6]
    step, count, lr, after = seen[0]
    want_lr = float(jax_schedule(jcfg.OptimizerConfig(
        name="adamw", lr=1e-3, schedule="warmup_cosine_step",
        warmup_steps=1, total_steps=6))(jnp.int32(0)))
    assert (step, count) == (2, 0)
    assert lr == want_lr == 0.0
    for k, v in after.items():
        assert torch.equal(v, saved["model"][k]), k


def test_cli_refuses_an_empty_epoch_and_what_is_not_ported(
        tmp_path, tiny_cli, monkeypatch):
    """A training split smaller than one batch raises (the JAX CLI would
    spin without a step), on the ResNet-50 baseline too;
    `ECAMP_PREEMPT_AT_STEP` is honoured, so the empty epoch is what raises
    under it. (A multi-process launch now trains:
    tests/test_torch_dp_finetune.py.)"""
    from ecamp_tpu_torch.data.synthetic import write_detection_corpus

    root = write_detection_corpus(str(tmp_path / "data"), "RSNA", 3, 2, 2,
                                  seed=0, img_size=32)
    out = str(tmp_path / "out")
    with pytest.raises(ValueError, match="fewer than one micro-batch"):
        tiny_cli.main(_cli_args(root, out))
    with pytest.raises(ValueError, match="fewer than one micro-batch"):
        tiny_cli.main(_cli_args(root, out) + ["--model", "resnet50"])
    monkeypatch.setenv("ECAMP_PREEMPT_AT_STEP", "3")
    with pytest.raises(ValueError, match="fewer than one micro-batch"):
        tiny_cli.main(_cli_args(root, out))


def test_detector_engine_matches_jax(tmp_path, monkeypatch):
    """`detector_engine` on a `.pth` the port wrote against the JAX
    package's on the same file (fp32, the tiny ViT): the decoded
    candidates of a bucket within 1e-4 of the scale, the boxes after each
    engine's NMS too, and the served boxes those of NMS on the same
    candidates;
    `PredictionService` with task 'detection' answers `{"boxes": ...}`
    through `/predict` without a MicroBatcher."""
    import base64
    import io
    import urllib.request

    from PIL import Image

    from ecamp_tpu.serve import loaders as jax_loaders
    from ecamp_tpu_torch.cli.finetune_det import save_best
    from ecamp_tpu_torch.ops.boxes import nms
    from ecamp_tpu_torch.serve import detector_engine
    from ecamp_tpu_torch.serve.http_server import PredictionService, serve

    model = _port_model(seed=2)
    with torch.no_grad():  # objectness over 0.5 for some candidates
        for i in range(3):
            getattr(model, f"embedding{i}").conv_out.bias[4::6].fill_(0.5)
    model(torch.from_numpy(_images(7)), train=True)
    path = str(tmp_path / "det.pth")
    save_best(path, model, 1)
    x = _images(8, n=3)
    engine = detector_engine(path, img_size=IMG, vit=_vit(pcfg),
                             buckets=(4,), bf16=False, device="cpu",
                             conf_threshold=0.3)
    tiny = _vit(jcfg)  # JAX's engine builds cfg.ViTConfig(img_size=...)
    monkeypatch.setattr(jax_loaders.cfg, "ViTConfig", lambda img_size: tiny)
    jax_engine = jax_loaders.detector_engine(
        path, img_size=IMG, buckets=(4,), mesh=_mesh(), bf16=False,
        conf_threshold=0.3)
    padded = np.concatenate([x, x[-1:]])  # the bucket of 4, as served
    with torch.inference_mode():
        cand = engine._fn(torch.from_numpy(padded)).numpy()[:3]
    cand_j = np.asarray(jax_engine._fn(jax_engine.params,
                                       jnp.asarray(padded)))[:3]
    got, want = engine(x), jax_engine(x)
    assert cand.shape == (3, 3 * sum(g * g for g in GRIDS), 6)
    _close(cand, cand_j, 1e-4, 1e-5, "candidates")
    assert len(got) == len(want) == 3
    assert any(g is not None for g in got)
    for g, w, d in zip(got, want, nms(cand, 1, 0.3, 0.5)):
        assert (g is None) == (w is None) == (d is None)
        if g is not None:
            _close(g, w, 1e-4, 1e-5, "boxes")
            np.testing.assert_array_equal(g, d)
    service = PredictionService(engine, img_size=IMG, task="detection")
    assert service.batcher is None
    buf = io.BytesIO()
    Image.fromarray(np.full((40, 40), 120, np.uint8)).save(buf, "PNG")
    httpd = serve(service, port=0, background=True)
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/predict",
            data=json.dumps({"image": base64.b64encode(
                buf.getvalue()).decode()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            reply = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()
    (pred,) = reply["predictions"]
    assert set(pred) == {"boxes"}
    assert pred["boxes"] is None or all(len(b) == 7 for b in pred["boxes"])
