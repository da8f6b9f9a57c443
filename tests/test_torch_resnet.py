"""The port's ResNet-50 baselines (ecamp_tpu_torch.nn.resnet, nn.unet, the
ResNet `DetectionModel`, `import_resnet_unet`, `import_detector(...,
backbone="resnet50")`, the ResNet branches of the segmentation and
detection tasks and CLIs) against the JAX package, on the CPU.

Sizes: `ResNet50Backbone(layers=(1, 1, 1, 1))` at 64 px; `ResNetUNet`
(full depth: JAX hardcodes (3, 4, 6, 3)) with the decoder (16, 16, 8, 8,
8) at 64 px; the ResNet detector at full depth and its head's full width
at 64 px (2^2 / 4^2 / 8^2 maps); B = 2 forward, 4 for a step. Weights go
JAX's variable tree (seeded lecun-scaled kernels, BatchNorm scales,
biases and statistics perturbed so they are not the identity) ->
`state_dict_from_flax` -> strict `load_state_dict`.
The JAX functions are jitted once per configuration and shared by the
module. The task-level parities (one `SegmentationTask` AdamW step, the
detector's loss and gradients) run in float64 on both sides, as
`tests/test_torch_detection.py` does: in fp32 a BatchNorm over a few
samples on a 2^2 map and the ReLU kinks part any two implementations by
more than the stated tolerances.
"""

import functools
import os
import re
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(__file__))

from test_resnet_baselines import _synthetic_state  # noqa: E402
from test_torch_detection import _targets  # noqa: E402

import flax.linen as fnn  # noqa: E402
from ecamp_tpu.core import config as jcfg  # noqa: E402
from ecamp_tpu.core.mesh import make_mesh  # noqa: E402
from ecamp_tpu.nn.det import DetectionModel as JaxDetectionModel  # noqa: E402
from ecamp_tpu.nn.resnet import ResNet50Backbone as JaxBackbone  # noqa: E402
from ecamp_tpu.nn.unet import ResNetUNet as JaxUNet  # noqa: E402
from ecamp_tpu.train.detection import \
    DetectionTask as JaxDetTask  # noqa: E402
from ecamp_tpu.train.segmentation import \
    SegmentationTask as JaxSegTask  # noqa: E402
from ecamp_tpu_torch.ckpt import (import_detector,  # noqa: E402
                                  import_resnet_unet, state_dict_from_flax)
from ecamp_tpu_torch.core import config as pcfg  # noqa: E402
from ecamp_tpu_torch.nn.det import DetectionModel  # noqa: E402
from ecamp_tpu_torch.nn.layers import Conv2d  # noqa: E402
from ecamp_tpu_torch.nn.resnet import ResNet50Backbone  # noqa: E402
from ecamp_tpu_torch.nn.unet import ResNetUNet  # noqa: E402
from ecamp_tpu_torch.train.detection import (DetectionTask,  # noqa: E402
                                             det_freeze_mask)
from ecamp_tpu_torch.train.segmentation import \
    SegmentationTask  # noqa: E402

B, IMG = 2, 64
TINY = (1, 1, 1, 1)
DECODER = (16, 16, 8, 8, 8)
GRIDS = (IMG // 32, IMG // 16, IMG // 8)
# a torchvision ResNet-50: 53 convs, 53 BatchNorms (weight, bias, mean, var)
RESNET50_TENSORS = 53 + 4 * 53


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads for this module: the suite runs six workers on
    the machine's cores, and a ResNet-50 on every core of each thrashes."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _perturb(variables, seed):
    """Non-trivial BatchNorm scales, biases and running statistics."""
    rng = np.random.default_rng(seed)
    v = jax.tree_util.tree_map(np.array, variables)

    def walk(p, s):
        for k in p:
            if isinstance(p[k], dict) and "scale" in p[k]:
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


def _jax_models():
    return {"backbone": JaxBackbone(layers=TINY),
            "unet": JaxUNet(decoder_channels=DECODER),
            "det": JaxDetectionModel(jcfg.ViTConfig(img_size=IMG),
                                     backbone="resnet50")}


def _port_model(name):
    g = torch.Generator().manual_seed(0)
    if name == "backbone":
        return ResNet50Backbone(layers=TINY, generator=g)
    if name == "unet":
        return ResNetUNet(decoder_channels=DECODER, generator=g)
    return DetectionModel(pcfg.ViTConfig(img_size=IMG), backbone="resnet50",
                          generator=g)


def _draw(model, seed):
    """A JAX variable tree of `model` without running its init (a jitted
    init of the full ResNet costs ~10 s to compile here): the shapes from
    `jax.eval_shape`, each kernel a normal of variance 1 / fan_in (flax's
    lecun-normal scale), biases and BatchNorm statistics at flax's init."""
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), train=False))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(
                np.float32)
        return (np.ones if name in ("scale", "var") else np.zeros)(
            s.shape, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def jax_vars():
    """name -> perturbed JAX variables, numpy leaves."""
    return {name: _perturb(_draw(model, i), seed=i)
            for i, (name, model) in enumerate(_jax_models().items())}


@pytest.fixture(scope="module")
def jax_apply():
    """(name, train) -> the jitted JAX forward, shared by the tests."""
    return {(name, train): jax.jit(functools.partial(
        model.apply, train=train,
        mutable=["batch_stats"] if train else False))
        for name, model in _jax_models().items() for train in (False, True)}


def _port_from(variables, name):
    m = _port_model(name)
    m.load_state_dict(state_dict_from_flax(variables["params"],
                                           variables["batch_stats"]),
                      strict=True)
    return m.eval()


def _images(seed, n=B, img=IMG):
    return np.random.default_rng(seed).normal(
        size=(n, img, img, 3)).astype(np.float32)


def _close(got, want, tol, what=""):
    """max |got - want| <= tol times the reference's scale (at least 1)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max|err| {err:.3e} > {tol * scale:.3e}"


def _stats_of(model):
    return {k: v for k, v in model.state_dict().items() if "running_" in k}


def _check_stats(model, variables, new_stats, tol=1e-4):
    want = state_dict_from_flax(variables["params"], new_stats)
    for k, t in _stats_of(model).items():
        _close(t.numpy(), want[k].numpy(), tol, k)


def _to_fp64(model: torch.nn.Module) -> torch.nn.Module:
    model.double()
    for m in model.modules():
        if getattr(m, "dtype", None) == torch.float32:
            m.dtype = torch.float64
    return model


def _vars64(variables):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                  variables)


# ---------------------------------------------------------------------------
# modules


@pytest.mark.parametrize("kernel,stride,padding,size", [
    (7, 2, 3, 17), (3, 2, 1, 9), (3, 2, 1, 8), (3, 1, 1, 7), (1, 2, 0, 9),
    (1, 2, None, 9), (3, 1, None, 6)])
def test_conv2d_padding_matches_flax(kernel, stride, padding, size):
    """`Conv2d` with a stride and flax's explicit integer padding (the
    ResNet stem's 7x7 / 2 pad 3, the strided 3x3's pad 1, odd and even
    sizes), and without a padding (SAME) as every earlier caller, against
    flax `nn.Conv` on the same weights within 1e-5."""
    rng = np.random.default_rng(kernel + stride + size)
    x = rng.normal(size=(2, size, size, 5)).astype(np.float32)
    conv = fnn.Conv(4, (kernel, kernel), strides=(stride, stride),
                    padding="SAME" if padding is None else padding)
    v = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.normal(size=a.shape).astype(
            np.float32), v)
    want = np.asarray(conv.apply(v, jnp.asarray(x)))
    port = Conv2d(5, 4, kernel, stride=stride, padding=padding)
    port.load_state_dict(state_dict_from_flax(v["params"]), strict=True)
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got.detach().numpy(), want, 1e-5, "conv")


def test_conv2d_refuses_a_strided_same_kernel():
    with pytest.raises(ValueError, match="explicit padding"):
        Conv2d(3, 4, 3, stride=2)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_backbone_matches_jax(jax_vars, jax_apply, train):
    """`ResNet50Backbone(layers=(1, 1, 1, 1))`'s layer2, layer3 and layer4
    taps (NCHW against JAX's NHWC) within 1e-4 of their scale; in train
    mode the batch statistics normalise and the updated running
    statistics agree within 1e-4 of their scale."""
    v = jax_vars["backbone"]
    x = _images(1)
    out = jax_apply["backbone", train](v, jnp.asarray(x))
    if train:
        out, new = out
    m = _port_from(v, "backbone")
    with torch.no_grad():
        got = m(torch.from_numpy(x), train=train)
    assert [tuple(t.shape) for t in got] == [
        (B, 512, IMG // 8, IMG // 8), (B, 1024, IMG // 16, IMG // 16),
        (B, 2048, IMG // 32, IMG // 32)]
    for i, (a, b) in enumerate(zip(got, out)):
        _close(a.permute(0, 2, 3, 1).numpy(), np.asarray(b), 1e-4, f"tap {i}")
    if train:
        _check_stats(m, v, new["batch_stats"])
    else:
        _check_stats(m, v, v["batch_stats"], 0.0)


def test_resnet50_namespace_is_torchvision():
    """A full `ResNet50Backbone` holds torchvision's resnet50 names and
    shapes (no `fc`): 53 convs and 53 BatchNorms, `downsample.0/.1` on the
    first block of each stage, the stride on the 3x3."""
    m = ResNet50Backbone()
    sd = m.state_dict()
    convs = [k for k, t in sd.items() if t.ndim == 4]
    assert len(convs) == 53
    assert sum(k.endswith("running_var") for k in sd) == 53
    assert sum(p.numel() for p in m.parameters()) == 23_508_032
    for k, shape in (("conv1.weight", (64, 3, 7, 7)),
                     ("layer1.0.downsample.0.weight", (256, 64, 1, 1)),
                     ("layer2.0.conv2.weight", (128, 128, 3, 3)),
                     ("layer3.5.bn3.running_mean", (1024,)),
                     ("layer4.0.downsample.1.weight", (2048,)),
                     ("layer4.2.conv3.weight", (2048, 512, 1, 1))):
        assert tuple(sd[k].shape) == shape, k
    assert m.layer2[0].conv2.stride == 2 and m.layer2[0].conv1.stride == 1
    assert not any(k.startswith("layer1.1.downsample") for k in sd)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_unet_matches_jax(jax_vars, jax_apply, train):
    """`ResNetUNet` fp32 logits (B, 64, 64, 1) within 1e-4 of their scale,
    and in train mode its 63 BatchNorms' running statistics within 1e-4
    of their scale."""
    v = jax_vars["unet"]
    x = _images(2)
    out = jax_apply["unet", train](v, jnp.asarray(x))
    if train:
        out, new = out
    m = _port_from(v, "unet")
    with torch.no_grad():
        got = m(torch.from_numpy(x), train=train)
    assert got.shape == (B, IMG, IMG, 1) and got.dtype == torch.float32
    _close(got.numpy(), np.asarray(out), 1e-4, "logits")
    assert sum(k.endswith("running_var") for k in m.state_dict()) == 63
    if train:
        _check_stats(m, v, new["batch_stats"])


def test_detector_maps_match_jax(jax_vars, jax_apply):
    """The ResNet `DetectionModel`'s three fp32 NCHW maps (B, 18, 2, 2),
    (B, 18, 4, 4), (B, 18, 8, 8) within 1e-4 of their scale from the
    running statistics; from the batch statistics (train mode) in float64
    (see the module docstring), within 1e-6, with the running statistics
    of the backbone and the head within 1e-6 of their scale."""
    v = jax_vars["det"]
    x = _images(3)
    m = _port_from(v, "det")
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    out = jax_apply["det", False](v, jnp.asarray(x))
    for g, a, b in zip(GRIDS, got, out):
        assert a.shape == (B, 18, g, g) and a.dtype == torch.float32
        _close(a.numpy(), np.asarray(b), 1e-4, f"map {g}")
    with jax.enable_x64(True):
        model = JaxDetectionModel(jcfg.ViTConfig(img_size=IMG),
                                  backbone="resnet50", dtype=jnp.float64)
        out, new = jax.jit(functools.partial(
            model.apply, train=True, mutable=["batch_stats"]))(
                _vars64(v), jnp.asarray(x, jnp.float64))
        out, new = jax.tree_util.tree_map(np.asarray, (out, new))
    _to_fp64(m)
    with torch.no_grad():
        got = m(torch.from_numpy(x).double(), train=True)
    for g, a, b in zip(GRIDS, got, out):
        _close(a.numpy(), b, 1e-6, f"map {g} (train)")
    _check_stats(m, v, new["batch_stats"], 1e-6)


def test_detector_namespace_and_freeze_mask_match_jax(jax_vars, tmp_path):
    """The ResNet detector's state dict is the namespace JAX's
    `export_detector` writes for it (`backbone.conv1`,
    `backbone.layer1.0.downsample.0`, the head at the top level), and
    `det_freeze_mask(..., "resnet50")` freezes the whole backbone, leaf
    for leaf as JAX's `_det_freeze_mask(..., "resnet50")`."""
    from ecamp_tpu.ckpt.torch_export import export_detector
    from ecamp_tpu.train.detection import _det_freeze_mask

    v = jax_vars["det"]
    m = _port_from(v, "det")
    exported = export_detector(v, str(tmp_path / "det.pth"))
    sd = m.state_dict()
    assert set(exported) == {k for k in sd
                             if not k.endswith("num_batches_tracked")}
    jmask = _det_freeze_mask(v["params"], True, "resnet50")
    want = {k: bool(t) for k, t in state_dict_from_flax(
        jax.tree_util.tree_map(np.float32, jmask)).items()}
    mask = det_freeze_mask(m, "resnet50")
    assert mask == want
    assert not any(mask[k] for k in mask if k.startswith("backbone."))
    assert all(mask[k] for k in mask if not k.startswith("backbone."))
    with pytest.raises(ValueError, match="unknown detector backbone"):
        DetectionModel(pcfg.ViTConfig(img_size=IMG), backbone="vgg")


# ---------------------------------------------------------------------------
# the tasks, in float64 (see the module docstring)


def _mesh():
    return make_mesh(jcfg.MeshConfig(data=1), devices=jax.devices()[:1])


def _opt(lib, lr):
    return lib.OptimizerConfig(
        name="adamw", lr=lr, weight_decay=0.05, betas=(0.9, 0.999),
        schedule="warmup_cosine_step", warmup_steps=0, total_steps=8,
        grad_clip=1.0)


def _seg_cfg(lib):
    kw = {"mesh": lib.MeshConfig(data=1)} if lib is jcfg else {}
    return lib.SegmentationConfig(
        backbone="resnet50", vit=lib.ViTConfig(img_size=IMG),
        optimizer=_opt(lib, 1e-4), task="SIIM", bf16=False, seed=5,
        data=lib.DataConfig(img_size=IMG, mean=0.4722, std=0.3028), **kw)


def _smooth_grads(jax_model, port_model, variables, x, seed, **kw):
    """The parameter gradients of sum(r_i * out_i) for seeded weights r_i
    over the model's outputs, in train mode and float64 on both sides:
    the model's own backward with no fp32 loss island in the way. Returns
    (port gradients by name, JAX's as a state dict)."""
    _to_fp64(port_model)
    outs = port_model(torch.from_numpy(x).double(), train=True, **kw)
    outs = outs if isinstance(outs, tuple) else (outs,)
    rng = np.random.default_rng(seed)
    rs = [rng.normal(size=tuple(o.shape)) for o in outs]
    sum((o * torch.from_numpy(r)).sum() for o, r in zip(outs, rs)).backward()
    with jax.enable_x64(True):
        v64 = _vars64(variables)

        def f(params):
            outs, _ = jax_model.apply(
                {"params": params, "batch_stats": v64["batch_stats"]},
                jnp.asarray(x, jnp.float64), train=True,
                mutable=["batch_stats"], **kw)
            outs = outs if isinstance(outs, tuple) else (outs,)
            return sum(jnp.sum(o * r) for o, r in zip(outs, rs))

        g_j = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(f))(
            v64["params"]))
    return ({k: p.grad for k, p in port_model.named_parameters()},
            state_dict_from_flax(g_j))


def test_unet_grads_match_jax(jax_vars):
    """The ResNet-50 UNet's backward: every parameter's gradient of a
    seeded linear function of its logits, in train mode and float64,
    within 1e-5 of the leaf's scale of JAX's (JAX keeps `seg_head` an fp32
    conv on the fp32 cast, the port's float64 run an f64 conv on it: its
    bias gradient, a sum over every pixel, parts by ~7e-6)."""
    v = jax_vars["unet"]
    got, want = _smooth_grads(JaxUNet(decoder_channels=DECODER,
                                      dtype=jnp.float64),
                              _port_from(v, "unet"), v, _images(5, n=4), 6)
    for k, g in got.items():
        _close(g.numpy(), want[k].numpy(), 1e-5, k)


@pytest.mark.slow  # the full-depth UNet step: ~40 s of JAX compile here
def test_segmentation_step_matches_jax(jax_vars):
    """One `SegmentationTask` step of the ResNet-50 UNet (AdamW lr 1e-4,
    clip 1.0, weight decay 0.05 on the >= 2-D leaves, no freeze mask: the
    whole UNet trains), B = 4 on u8 images normalised on the device, in
    float64, against the JAX step's body (`value_and_grad` of the task's
    `_loss`, then `apply_gradients`): the mixed loss within 1e-5 relative
    (an fp32 island on both sides), the lr, every BatchNorm statistic
    within 1e-5 of its scale, every parameter moved; and the port's AdamW
    update of every leaf from JAX's gradients within 1e-7 + 3e-7 relative
    of JAX's (0.1% of a step, or 2 fp32 ulps: the AdamW's plain version
    computes in fp32).

    The update is compared from the same gradients: the mixed loss is
    computed in fp32 on both sides, and its rounding moves a gradient by
    up to a few % of a leaf's scale through the BatchNorms (the model's
    backward alone agrees within 1e-5, `test_unet_grads_match_jax`),
    which Adam's normalisation g / (|g| + eps) turns into steps of the
    other sign or size wherever |g| is that small."""
    v = jax_vars["unet"]
    rng = np.random.default_rng(7)
    x = rng.integers(0, 256, (4, IMG, IMG, 1), dtype=np.uint8)
    masks = (rng.random((4, IMG, IMG, 1)) < 0.3).astype(np.float32)
    with jax.enable_x64(True):
        task_j = JaxSegTask(_seg_cfg(jcfg), mesh=_mesh())
        v64 = _vars64(v)
        # `init_state` would run an eager init of the full UNet (~30 s
        # here): hand it the perturbed variables instead, then the model
        task_j.model = SimpleNamespace(init=lambda *a, **k: v64)
        state_j = task_j.init_state(jax.random.PRNGKey(0))
        task_j.model = JaxUNet(decoder_channels=DECODER, dtype=jnp.float64)
        (loss_j, stats_j), g_j = jax.jit(jax.value_and_grad(
            task_j._loss, has_aux=True))(state_j.params,
                                         state_j.batch_stats, jnp.asarray(x),
                                         jnp.asarray(masks),
                                         jax.random.PRNGKey(0))
        state_j = state_j.replace(tx=task_j.tx).apply_gradients(
            g_j, batch_stats=stats_j)
        want = state_dict_from_flax(
            jax.tree_util.tree_map(np.asarray, state_j.params),
            jax.tree_util.tree_map(np.asarray, state_j.batch_stats))
        g_j = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, g_j))
        lr_j = float(task_j.schedule(0))
    task = SegmentationTask(_seg_cfg(pcfg), device="cpu")
    assert task.freeze_mask() is None
    task.model = ResNetUNet(decoder_channels=DECODER)
    task.model.load_state_dict(state_dict_from_flax(
        v["params"], v["batch_stats"]), strict=True)
    _to_fp64(task.model)
    start = {k: t.clone() for k, t in task.model.state_dict().items()}
    state = task.init_state()
    state, m = task.train_step(state, torch.from_numpy(x),
                               torch.from_numpy(masks))
    assert abs(float(m["loss"]) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    np.testing.assert_allclose(float(m["lr"]), lr_j, rtol=1e-6)
    for k, t in _stats_of(task.model).items():
        _close(t.numpy(), want[k].numpy(), 1e-5, k)
    assert all(int(t) == 1 for k, t in task.model.state_dict().items()
               if k.endswith("num_batches_tracked"))
    for k, p in task.model.named_parameters():
        assert not torch.equal(p, start[k]), k
    assert int(state.step) == int(state_j.step) == 1

    # the update from JAX's gradients, on a fresh optimizer
    task.model.load_state_dict(start)
    state = task.init_state()
    for k, p in task.model.named_parameters():
        p.grad = g_j[k].double()
    state = state.apply_gradients(task.tx)
    for k, p in task.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   rtol=3e-7, atol=1e-7, err_msg=k)


def test_segmentation_task_refuses_riga_and_unknown_backbones():
    """RIGA's two decoders have no ResNet baseline (JAX raises too); a
    backbone the port does not know raises rather than falling back."""
    with pytest.raises(ValueError, match="single-decoder"):
        SegmentationTask(pcfg.SegmentationConfig(
            backbone="resnet50", task="RIGA", bf16=False), device="cpu")
    with pytest.raises(ValueError, match="unknown segmentation backbone"):
        SegmentationTask(pcfg.SegmentationConfig(backbone="vgg"),
                         device="cpu")


def _det_cfg(lib):
    kw = {"mesh": lib.MeshConfig(data=1)} if lib is jcfg else {}
    return lib.DetectionConfig(
        backbone="resnet50", vit=lib.ViTConfig(img_size=IMG),
        optimizer=_opt(lib, 1e-4), img_size=IMG, bf16=False, seed=5, **kw)


def test_detection_loss_and_frozen_stats_match_jax(jax_vars):
    """`DetectionTask` on the ResNet detector, the backbone frozen, B = 4,
    in float64: the summed YOLO loss and each scale's (fp32 islands on
    both sides) within 1e-5 relative; no gradient in the backbone (JAX's
    zeros); the frozen backbone's BatchNorm statistics move in train mode
    (JAX's do under stop_gradient) and agree with JAX's within 1e-5 of
    their scale, as the head's do; one masked AdamW update then leaves the backbone's
    weights bit-unchanged and moves the head."""
    v = jax_vars["det"]
    rng = np.random.default_rng(8)
    x = rng.integers(0, 256, (4, IMG, IMG, 1), dtype=np.uint8)
    t = _targets(9, n=4, grids=GRIDS)
    with jax.enable_x64(True):
        task_j = JaxDetTask(_det_cfg(jcfg), mesh=_mesh())
        task_j.model = JaxDetectionModel(
            jcfg.ViTConfig(img_size=IMG), backbone="resnet50",
            dtype=jnp.float64)
        v64 = _vars64(v)
        (loss_j, (stats_j, parts_j)), g_j = jax.jit(jax.value_and_grad(
            task_j._loss, has_aux=True))(v64["params"], v64["batch_stats"],
                                         jnp.asarray(x), jnp.asarray(t),
                                         jax.random.PRNGKey(0))
        loss_j, parts_j, g_j, stats_j = jax.tree_util.tree_map(
            np.asarray, (loss_j, parts_j, g_j, stats_j))
    task = DetectionTask(_det_cfg(pcfg), device="cpu")
    task.model.load_state_dict(state_dict_from_flax(
        v["params"], v["batch_stats"]), strict=True)
    _to_fp64(task.model)
    state = task.init_state()
    before = {k: s.clone() for k, s in task.model.state_dict().items()}
    loss, parts = task.loss(torch.from_numpy(x), torch.from_numpy(t))
    loss.backward()
    assert abs(float(loss.detach()) - float(loss_j)) <= 1e-5 * abs(
        float(loss_j))
    for k, w in parts_j.items():
        assert abs(float(parts[k]) - float(w)) <= 1e-5 * abs(float(w)), k
    want = state_dict_from_flax(g_j)
    for k, p in task.model.named_parameters():
        if k.startswith("backbone."):
            assert p.grad is None, k
            assert not np.asarray(want[k]).any(), k
        else:
            assert p.grad is not None and bool(p.grad.any()), k
    want_stats = state_dict_from_flax(v["params"], stats_j)
    moved = 0
    for k, s in _stats_of(task.model).items():
        _close(s.numpy(), want_stats[k].numpy(), 1e-5, k)
        if k.startswith("backbone."):
            moved += not torch.equal(s, before[k])
    assert moved == 2 * 53  # every running mean and variance of the ResNet
    task.model.load_state_dict(before)
    state, _ = task.train_step(state, torch.from_numpy(x),
                               torch.from_numpy(t))
    for k, p in task.model.named_parameters():
        assert torch.equal(p, before[k]) == k.startswith("backbone."), k


def test_detection_head_grads_match_jax(jax_vars):
    """The ResNet detector's backward with the backbone frozen: the head's
    gradient of a seeded linear function of the three maps, in train mode
    and float64, within 1e-6 of the leaf's scale of JAX's; none in the
    backbone. (Through the YOLO loss, an fp32 island on both sides, the
    head's gradients part by up to ~1% of a leaf's scale on this batch:
    the loss's rounding, not the model.)"""
    v = jax_vars["det"]
    got, want = _smooth_grads(
        JaxDetectionModel(jcfg.ViTConfig(img_size=IMG), backbone="resnet50",
                          dtype=jnp.float64),
        _port_from(v, "det"), v, _images(10, n=4), 11, stop_trunk_grad=True)
    for k, g in got.items():
        if k.startswith("backbone."):
            assert g is None and not want[k].any(), k
        else:
            _close(g.numpy(), want[k].numpy(), 1e-6, k)


# ---------------------------------------------------------------------------
# importers


def _write_pth(sd, path):
    torch.save({k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()},
               path)


def _torchvision_pth(variables, keep, tmp_path, spelling):
    """A synthetic torchvision-layout `.pth` of every leaf `keep` selects
    (`tests/test_resnet_baselines.py::_synthetic_state`), with the `fc.*`
    and `num_batches_tracked` entries torchvision's carry (the running
    variances made positive, the convs scaled to a unit gain), under
    `spelling` (a prefix of every key; a detector's `backbone.` goes)."""
    sd, _ = _synthetic_state(variables, keep)
    sd = {k[len("backbone."):] if k.startswith("backbone.") else k: t
          for k, t in sd.items()}
    for k, t in sd.items():  # kept finite through 53 layers in eval mode
        if k.endswith("running_var"):
            sd[k] = 0.5 + np.abs(t)
        elif t.ndim == 4:
            sd[k] = t / np.sqrt(t[0].size)
    sd["fc.weight"] = np.zeros((1000, 2048), np.float32)
    sd["fc.bias"] = np.zeros((1000,), np.float32)
    sd["bn1.num_batches_tracked"] = np.asarray(7)
    path = str(tmp_path / "resnet50.pth")
    _write_pth({spelling + k: v for k, v in sd.items()}, path)
    return path


@pytest.mark.parametrize("spelling", ["", "encoder.",
                                      "module.img_encoder.model."])
def test_import_resnet_unet_matches_jax(jax_vars, jax_apply, tmp_path,
                                        spelling):
    """`import_resnet_unet` on a torchvision `.pth` (bare, smp's
    `encoder.`, a wrapped baseline's `module.img_encoder.model.`) loads
    the same 265 encoder tensors as JAX's `import_resnet_unet`, to the
    same values; the decoder and `seg_head` keep their init; the two
    models' forwards then agree within 1e-4."""
    from ecamp_tpu.ckpt import import_resnet_unet as jax_import

    v = jax_vars["unet"]
    path = _torchvision_pth(
        v, lambda k: not k.startswith(("decoder_", "seg_head.")), tmp_path,
        spelling)
    new_v, loaded_j, _ = jax_import(v, path)
    m = _port_from(v, "unet")
    init = {k: t.clone() for k, t in m.state_dict().items()}
    loaded, missing = import_resnet_unet(m, path)
    assert len(loaded) == len(loaded_j) == RESNET50_TENSORS
    assert all(k.startswith(("decoder_", "seg_head.")) for k in missing)
    want = state_dict_from_flax(new_v["params"], new_v["batch_stats"])
    for k, t in m.state_dict().items():
        if k.endswith("num_batches_tracked"):
            assert torch.equal(t, init[k]), k
            continue
        assert torch.equal(t, want[k]), k
        assert (k in loaded) != torch.equal(t, init[k]), k
    x = _images(4)
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    _close(got.numpy(), np.asarray(jax_apply["unet", False](
        jax.tree_util.tree_map(jnp.asarray, new_v), jnp.asarray(x))), 1e-4,
        "logits")


@pytest.mark.parametrize("spelling", ["", "model.",
                                      "module.img_encoder.model."])
def test_import_resnet_detector_matches_jax(jax_vars, tmp_path, spelling):
    """`import_detector(..., backbone="resnet50")` from a pretraining-style
    torchvision `.pth` (bare, ResNetDetector's `model.`, wrapped) loads
    the same 265 backbone tensors as JAX's, the head at its init; from the
    port's own saved detector (`from_pretrain=False`) it loads every
    tensor, as JAX's does from the same file."""
    from ecamp_tpu.ckpt import import_detector as jax_import

    v = jax_vars["det"]
    path = _torchvision_pth(v, lambda k: k.startswith("backbone."),
                            tmp_path, spelling)
    new_v, loaded_j, _ = jax_import(v, path, backbone="resnet50")
    m = _port_from(v, "det")
    init = {k: t.clone() for k, t in m.state_dict().items()}
    loaded, missing = import_detector(m, path, backbone="resnet50")
    assert len(loaded) == len(loaded_j) == RESNET50_TENSORS
    assert all(k.startswith("backbone.") for k in loaded)
    assert not any(k.startswith("backbone.") for k in missing)
    want = state_dict_from_flax(new_v["params"], new_v["batch_stats"])
    for k, t in m.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(t, want[k]), k

    # a fine-tuned detector (`from_pretrain=False`): the backbone read
    # bare, the head under its own names. A file in `export_detector`'s
    # namespace (`backbone.conv1...`, what the port's CLI saves) gives
    # both importers the head only: JAX's reads the backbone bare or
    # `model.`-prefixed, and the port follows it
    state = {k: t for k, t in init.items()
             if not k.endswith("num_batches_tracked")}
    for name, sd, n_backbone in (
            ("bare.pth", {k[len("backbone."):] if k.startswith("backbone.")
                          else k: t for k, t in state.items()},
             RESNET50_TENSORS),
            ("exported.pth", state, 0)):
        saved = str(tmp_path / name)
        torch.save({"model": sd}, saved)
        m.load_state_dict(init)
        loaded, missing = import_detector(m, saved, from_pretrain=False,
                                          backbone="resnet50")
        back_v, loaded_j, _ = jax_import(v, saved, from_pretrain=False,
                                         backbone="resnet50")
        assert len(loaded_j) == len(loaded) == len(state) - (
            RESNET50_TENSORS - n_backbone), name
        back = state_dict_from_flax(back_v["params"], back_v["batch_stats"])
        for k, t in m.state_dict().items():
            if not k.endswith("num_batches_tracked"):
                assert torch.equal(back[k], t), (name, k)


# ---------------------------------------------------------------------------
# the CLIs


def _pretrained_pth(tmp_path):
    """A torchvision-layout ResNet-50 `.pth` of the port's own backbone,
    with `fc.*` and `num_batches_tracked`."""
    sd = {k: t for k, t in ResNet50Backbone(
        generator=torch.Generator().manual_seed(3)).state_dict().items()}
    sd["fc.weight"] = torch.zeros(1000, 2048)
    sd["fc.bias"] = torch.zeros(1000)
    path = str(tmp_path / "resnet50.pth")
    torch.save(sd, path)
    return path


def _cli_args(root, out, *extra):
    return ["--dataset_path", root, "--model", "resnet50", "--img_size",
            "32", "--batch_size", "4", "--eval_batch_size", "3", "--lr",
            "1e-3", "--warmup_steps", "1", "--device", "cpu",
            "--num_workers", "2", "--no_bf16", "--output_dir", out, *extra]


def _log(out):
    import json

    with open(os.path.join(out, "log.txt")) as f:
        return [json.loads(line) for line in f]


def _loaded(printed):
    got = re.search(r": loaded (\d+) tensors, (\d+) left at init", printed)
    return got and (int(got[1]), int(got[2]))


def test_finetune_seg_cli_resnet50(tmp_path, capsys):
    """`cli.finetune_seg --model resnet50` on a tiny SIIM corpus: the
    encoder from a torchvision `.pth` (265 tensors, the 5 decoder blocks'
    50 and `seg_head`'s 2 at init), validations with AdamW's launch
    counter in the log (0 on the CPU), the best `.pth` in the UNet's
    namespace, the test line; RIGA raises."""
    from ecamp_tpu_torch.cli import finetune_seg
    from ecamp_tpu_torch.data.synthetic import write_segmentation_corpus

    root = write_segmentation_corpus(str(tmp_path / "data"), "SIIM", 12, 4,
                                     3, seed=0, img_size=64)
    out = str(tmp_path / "out")
    dice = finetune_seg.main(["--task", "SIIM", "--num_steps", "2",
                              "--patience", "3", "--pretrained",
                              _pretrained_pth(tmp_path)]
                             + _cli_args(root, out))
    printed = capsys.readouterr().out
    assert _loaded(printed) == (RESNET50_TENSORS, 5 * 10 + 2)
    vals = [r for r in _log(out) if "step" in r]
    assert vals and all(r["kernel_launches"] == {
        "layer_norm": 0, "attention": 0, "adamw": 0} for r in vals)
    assert f"TEST dice: {dice:.4f}" in printed
    sd = torch.load(os.path.join(out, "best", "checkpoint-best.pth"),
                    weights_only=True)["model"]
    assert {"layer4.2.bn3.running_var", "decoder_4.conv2.weight",
            "seg_head.bias"} <= set(sd)
    with pytest.raises(ValueError, match="single-decoder"):
        finetune_seg.main(["--task", "RIGA"]
                          + _cli_args(root, str(tmp_path / "riga")))


def test_finetune_det_cli_resnet50_trains_resumes_and_tests(tmp_path,
                                                            capsys):
    """`cli.finetune_det --model resnet50` on a tiny RSNA corpus: the
    backbone from a torchvision `.pth` (265 tensors, the head at init),
    validations, the best `.pth` with its step in the ResNet detector's
    namespace, the test line; then `--resume` from it fast-forwards to
    its step and trains on to `--num_steps`."""
    from ecamp_tpu_torch.cli import finetune_det
    from ecamp_tpu_torch.data.synthetic import write_detection_corpus

    root = write_detection_corpus(str(tmp_path / "data"), "RSNA", 8, 3, 2,
                                  seed=1, img_size=64)
    first = str(tmp_path / "first")
    ap = finetune_det.main(["--num_steps", "2", "--patience", "5",
                            "--pretrained", _pretrained_pth(tmp_path)]
                           + _cli_args(root, first))
    printed = capsys.readouterr().out
    n_entries = sum(1 for k in _port_model("det").state_dict()
                    if not k.endswith("num_batches_tracked"))
    assert _loaded(printed) == (RESNET50_TENSORS,
                                n_entries - RESNET50_TENSORS)
    assert [r["step"] for r in _log(first) if "step" in r] == [2]
    assert f"TEST mAP@[.40:.05:.75]: {ap:.4f}" in printed
    saved = torch.load(os.path.join(first, "best", "checkpoint-best.pth"),
                       weights_only=True)
    assert saved["step"] == 2
    assert {"backbone.layer4.2.bn3.running_var", "embedding0.conv_out.bias",
            "embedding2_cbl.bn.weight"} <= set(saved["model"])
    second = str(tmp_path / "second")
    finetune_det.main(["--num_steps", "4", "--patience", "5", "--resume",
                       first] + _cli_args(root, second))
    assert "resumed from step 2" in capsys.readouterr().out
    assert [r["step"] for r in _log(second) if "step" in r] == [4]
