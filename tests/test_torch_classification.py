"""The port's classification fine-tune (ecamp_tpu_torch.train.classification,
cli.finetune_cls and what they need) against the JAX package, on the CPU,
at a tiny size: ViT img 32, patch 16, dim 64, depth 2, 2 heads, 3 classes,
fp32, drop-path 0 (the two sides' random bits cannot match).

Weights go JAX init (head widened so the trunk's gradients are not ~0) ->
`state_dict_from_flax` -> strict `load_state_dict`. Inputs come from numpy
seeds. One jitted JAX loss-and-gradient function and one jitted JAX train
step per configuration are shared by the module. The JAX package runs its
kernels' plain references on the CPU; the port its kernels' plain versions.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ecamp_tpu.core import config as jcfg  # noqa: E402
from ecamp_tpu.core.mesh import make_mesh  # noqa: E402
from ecamp_tpu.train.classification import \
    ClassificationTask as JaxTask  # noqa: E402
from ecamp_tpu_torch.ckpt import state_dict_from_flax  # noqa: E402
from ecamp_tpu_torch.core import config as pcfg  # noqa: E402
from ecamp_tpu_torch.train.classification import \
    ClassificationTask  # noqa: E402

B, IMG, NC = 4, 32, 3
CASES = {  # name -> (is_multilabel, linear_probe, accum_steps)
    "bce": (True, False, 1), "ce": (False, False, 1),
    "probe": (True, True, 1), "accum": (True, False, 2)}


def _cfg(lib, multilabel, probe, accum):
    kw = {"mesh": lib.MeshConfig(data=1)} if lib is jcfg else {}
    return lib.ClassificationConfig(
        vit=lib.ViTConfig(img_size=IMG, patch_size=16, embed_dim=64, depth=2,
                          num_heads=2),
        optimizer=lib.OptimizerConfig(
            name="sgd", lr=5e-2, weight_decay=1e-4, momentum=0.9,
            schedule="warmup_cosine_step", warmup_steps=2, total_steps=8,
            grad_clip=1.0, accum_steps=accum),
        num_classes=NC, is_multilabel=multilabel, linear_probe=probe,
        bf16=False, seed=5, **kw)


@pytest.fixture(scope="module")
def jax_params():
    task = JaxTask(_cfg(jcfg, True, False, 1),
                   mesh=make_mesh(jcfg.MeshConfig(data=1),
                                  devices=jax.devices()[:1]))
    params = jax.jit(lambda r: task.model.init(
        r, jnp.zeros((2, IMG, IMG, 3))))(jax.random.PRNGKey(0))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(100)
    params["head"]["kernel"] = rng.normal(
        0, 0.2, params["head"]["kernel"].shape).astype(np.float32)
    params["head"]["bias"] = rng.normal(
        0, 0.1, params["head"]["bias"].shape).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def jax_tasks():
    """One JAX task per case, with its jitted loss-and-gradient function
    and train step (compiled on first use, then shared)."""
    out = {}
    for name, (ml, probe, accum) in CASES.items():
        task = JaxTask(_cfg(jcfg, ml, probe, accum),
                       mesh=make_mesh(jcfg.MeshConfig(data=1),
                                      devices=jax.devices()[:1]))
        grad_fn = jax.jit(jax.value_and_grad(task._loss, has_aux=True))
        out[name] = (task, grad_fn)
    return out


def _batch(seed, multilabel):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, IMG, IMG, 3)).astype(np.float32)
    if multilabel:
        y = (rng.random((B, NC)) < 0.4).astype(np.float32)
    else:
        y = rng.integers(0, NC, B).astype(np.int32)
    return x, y


def _port(name, params):
    ml, probe, accum = CASES[name]
    task = ClassificationTask(_cfg(pcfg, ml, probe, accum), device="cpu")
    task.model.load_state_dict(state_dict_from_flax(params), strict=True)
    return task


@pytest.mark.parametrize("name", ["bce", "ce", "probe"])
def test_loss_and_grads_match_jax(name, jax_params, jax_tasks):
    task_j, grad_fn = jax_tasks[name]
    x, y = _batch(1, CASES[name][0])
    (loss_j, logits_j), g_j = grad_fn(jax_params, jnp.asarray(x),
                                      jnp.asarray(y), jax.random.PRNGKey(3))
    task = _port(name, jax_params)
    task.model.train()
    loss, logits = task.loss(torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    assert abs(float(loss.detach()) - float(loss_j)) <= 1e-5
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(logits_j),
                               rtol=1e-4, atol=1e-5)
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, g_j))
    for k, p in task.model.named_parameters():
        got = np.zeros(p.shape, np.float32) if p.grad is None \
            else p.grad.numpy()
        if name == "probe" and not k.startswith(("fc_norm.", "head.")):
            # the trunk records no graph: no gradient at all, JAX's zero
            assert p.grad is None, k
        np.testing.assert_allclose(got, want[k].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", ["bce", "ce", "probe", "accum"])
def test_sgd_steps_match_jax(name, jax_params, jax_tasks):
    """3 optimizer updates (4 micro-steps of 2 with accumulation), warmup-
    cosine, clip 1.0, weight decay 1e-4: the parameters after each call
    within 1e-4 of JAX's; with the linear probe everything but the head
    stays bit-unchanged."""
    task_j, _ = jax_tasks[name]
    state_j = task_j.init_state(jax.random.PRNGKey(0))
    state_j = state_j.replace(params=jax.tree_util.tree_map(jnp.asarray,
                                                            jax_params))
    task = _port(name, jax_params)
    state = task.init_state()
    before = {k: v.clone() for k, v in task.model.state_dict().items()}
    ml, probe, accum = CASES[name]
    for i in range(4 if accum > 1 else 3):
        x, y = _batch(10 + i, ml)
        state_j, m_j = task_j.train_step(state_j, jnp.asarray(x),
                                         jnp.asarray(y))
        state, m = task.train_step(state, torch.from_numpy(x),
                                   torch.from_numpy(y))
        assert abs(float(m["loss"]) - float(m_j["loss"])) <= 1e-4
        np.testing.assert_allclose(float(m["lr"]), float(m_j["lr"]),
                                   rtol=1e-6)
        want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                           state_j.params))
        for k, v in task.model.state_dict().items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                       atol=1e-4, err_msg=f"{k} step {i}")
    assert int(state.step) == int(state_j.step) == task.step
    after = task.model.state_dict()
    for k, v in after.items():
        if probe and not k.startswith("head."):
            assert torch.equal(v, before[k]), k
        else:
            assert not torch.equal(v, before[k]), k


def test_compute_metrics_match_jax(jax_tasks):
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(40, NC)).astype(np.float32)
    logits[3] = logits[4]  # ties
    multi = (rng.random((40, NC)) < 0.3).astype(np.float32)
    multi[:, 2] = 0  # one class with no positive: NaN, left out of the mean
    single = rng.integers(0, NC, 40)
    for name, labels in (("bce", multi), ("ce", single)):
        want = jax_tasks[name][0].compute_metrics(logits, labels)
        got = ClassificationTask(_cfg(pcfg, *CASES[name]),
                                 device="cpu").compute_metrics(logits, labels)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)


def test_layerwise_lr_scales_match_jax(jax_params):
    from ecamp_tpu.train.optim import layerwise_lr_scales as jax_scales
    from ecamp_tpu_torch.train.optim import layerwise_lr_scales

    want = state_dict_from_flax(jax_scales(jax_params, 0.75, 2))
    got = layerwise_lr_scales(state_dict_from_flax(jax_params), 0.75, 2)
    assert set(got) == set(want)
    for k in got:
        assert got[k] == pytest.approx(float(want[k]), rel=1e-12), k
    assert got["patch_embed.proj.weight"] == 0.75 ** 3
    assert got["blocks.1.mlp.fc1.weight"] == 0.75
    assert got["head.weight"] == 1.0


def test_import_vit_classifier_matches_jax(tmp_path, jax_params):
    """One `.pth` from a 5-class classifier at 64 px (a 4x4 grid), keys
    under `module.` and wrapped in `model`: the trunk loads, `pos_embed` is
    resized to the 2x2 grid, the 5-wide head keeps the 3-class init; the
    same as JAX's importer."""
    from ecamp_tpu.ckpt import import_vit_classifier as jax_import
    from ecamp_tpu.nn import ViTClassifier as JaxViT
    from ecamp_tpu_torch.ckpt import import_vit_classifier

    src = JaxViT(jcfg.ViTConfig(img_size=64, patch_size=16, embed_dim=64,
                                depth=2, num_heads=2), 5)
    src_params = jax.jit(lambda r: src.init(
        r, jnp.zeros((1, 64, 64, 3))))(jax.random.PRNGKey(7))["params"]
    sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, src_params))
    path = str(tmp_path / "ft.pth")
    torch.save({"model": {"module." + k: v for k, v in sd.items()}}, path)

    variables, loaded_j, _ = jax_import({"params": jax_params}, path)
    task = _port("bce", jax_params)
    loaded, missing = import_vit_classifier(task.model, path)
    want = state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, variables["params"]))
    assert sorted(loaded) == sorted(loaded_j)
    assert sorted(missing) == ["head.bias", "head.weight"]
    for k, v in task.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=2e-6, err_msg=k)
    assert not np.array_equal(want["pos_embed"].numpy(),
                              jax_params["trunk"]["pos_embed"])


def _gray_jpegs(root, n, seed):
    from PIL import Image

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "img"), exist_ok=True)
    os.makedirs(os.path.join(root, "T"), exist_ok=True)
    lines = []
    for i in range(n):
        h, w = rng.integers(40, 90, 2)
        Image.fromarray(rng.integers(0, 256, (h, w), np.uint8), "L").save(
            os.path.join(root, "img", f"{i}.jpg"))
        lines.append(f"img/{i}.jpg " + " ".join(
            str(v) for v in rng.integers(0, 2, NC)))
    for split in ("train_list", "val_list"):
        with open(os.path.join(root, "T", f"{split}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")


@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8"])
@pytest.mark.parametrize("ratio", [1.0, 0.875])
def test_dataset_and_loaders_match_jax(tmp_path, monkeypatch, u8, ratio):
    """`ClassificationListDataset` through the train loader (TrainTransform,
    reseeded per epoch and worker) and the eval loader (EvalTransform,
    unshuffled, ragged last batch), bit-equal to `ecamp_tpu.data`'s with its
    C++ library off."""
    from ecamp_tpu.data import native
    from ecamp_tpu.data.datasets import ClassificationListDataset as JDS
    from ecamp_tpu.data.loader import DataLoader as JLoader
    from ecamp_tpu.data.transforms import EvalTransform as JEval
    from ecamp_tpu.data.transforms import TrainTransform as JTrain
    from ecamp_tpu_torch.data.datasets import ClassificationListDataset
    from ecamp_tpu_torch.data.loader import DataLoader
    from ecamp_tpu_torch.data.transforms import EvalTransform, TrainTransform

    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", True)
    root = str(tmp_path)
    _gray_jpegs(root, 11, seed=int(ratio * 8) + u8)
    pairs = [
        (JDS(root, root, "T", "train", transform=JTrain(
            24, 0.47, 0.3, seed=3, use_native=False, output_u8=u8)),
         ClassificationListDataset(root, root, "T", "train",
                                   transform=TrainTransform(
                                       24, 0.47, 0.3, seed=3,
                                       output_u8=u8)),
         dict(shuffle=True, drop_last=True)),
        (JDS(root, root, "T", "val", transform=JEval(
            24, 0.47, 0.3, crop_ratio=ratio, output_u8=u8)),
         ClassificationListDataset(root, root, "T", "val",
                                   transform=EvalTransform(
                                       24, 0.47, 0.3, crop_ratio=ratio,
                                       output_u8=u8)),
         dict(shuffle=False, drop_last=False))]
    for jds, pds, kw in pairs:
        jl = JLoader(jds, 4, seed=2, num_workers=2, **kw)
        pl = DataLoader(pds, 4, seed=2, num_workers=2, **kw)
        for epoch in (0, 1):
            jl.set_epoch(epoch)
            pl.set_epoch(epoch)
            want, got = list(jl), list(pl)
            assert len(got) == len(want) == len(pl)
            for a, b in zip(want, got):
                for k in ("image", "label"):
                    assert b[k].dtype == a[k].dtype, k
                    np.testing.assert_array_equal(b[k], a[k], err_msg=k)
        assert got[0]["image"].shape[1:] == ((24, 24, 1) if u8
                                             else (24, 24, 3))


def _tiny_vit(**kw):
    return pcfg.ViTConfig(patch_size=16, embed_dim=64, depth=2, num_heads=2,
                          **kw)


@pytest.fixture
def tiny_cli(monkeypatch):
    from ecamp_tpu_torch.cli import finetune_cls as cli

    monkeypatch.setitem(cli._VIT_FACTORY, "tiny", _tiny_vit)
    return cli


@pytest.mark.parametrize("task_name", ["ChestX-ray14", "COVIDx"])
def test_cli_trains_stops_early_and_tests(tmp_path, tiny_cli, capsys,
                                          task_name):
    """`cli.finetune_cls --device cpu` on a seeded synthetic list dataset
    (eval splits ragged against the eval batch): it validates every epoch
    of updates, stops after `--patience 1` validations without a better
    value (lr 0 keeps it constant), writes the best `.pth`, reloads it and
    prints the test line; `classifier_engine` serves that `.pth` with the
    task's own eval logits."""
    import json

    from ecamp_tpu_torch.data.synthetic import write_classification_corpus
    from ecamp_tpu_torch.serve import classifier_engine

    nc, multilabel = tiny_cli.TASKS[task_name]
    root = write_classification_corpus(str(tmp_path / "data"), task_name,
                                       16, 10, 10, seed=1, num_classes=nc,
                                       multilabel=multilabel, img_size=48)
    out = tmp_path / "out"
    common = ["--dataset_path", root, "--task", task_name, "--model", "tiny",
              "--img_size", "32", "--batch_size", "8", "--eval_batch_size",
              "4", "--num_workers", "2", "--no_bf16", "--device", "cpu",
              "--warmup_steps", "1", "--num_steps", "20", "--patience", "1",
              "--output_dir", str(out), "--u8_pipe"]
    metrics = tiny_cli.main(common + ["--lr", "0"])
    printed = capsys.readouterr().out
    recs = [json.loads(line) for line in (out / "log.txt").read_text()
            .splitlines()]
    key = "auc" if multilabel else "acc"
    # 16 images / batch 8: 2 updates an epoch; a validation each, the
    # second no better than the first, then the test
    assert [r.get("step") for r in recs] == [2, 4, None]
    assert recs[0][key] == recs[1][key] == recs[0]["best"]
    assert recs[2]["test"] == json.loads(json.dumps(metrics))
    assert printed.count("Epoch [") == 2 and "Total time:" in printed
    assert ("TEST mean AUROC:" if multilabel else "TEST accuracy:") in printed
    best = out / "best" / "checkpoint-best.pth"
    assert best.exists()

    # training with a real lr moves the weights; the engine serves them
    out2 = tmp_path / "out2"
    tiny_cli.main([a if a != str(out) else str(out2) for a in common]
                  + ["--lr", "0.05", "--num_steps", "4"])
    best2 = out2 / "best" / "checkpoint-best.pth"
    sd = torch.load(best2, weights_only=True)["model"]
    assert set(sd) == set(torch.load(best, weights_only=True)["model"])
    eng = classifier_engine(str(best2), num_classes=nc, img_size=32,
                            multilabel=multilabel, vit=_tiny_vit(img_size=32),
                            bf16=False, buckets=(4,), device="cpu")
    task = ClassificationTask(dataclasses.replace(
        pcfg.ClassificationConfig(), vit=_tiny_vit(img_size=32),
        num_classes=nc, is_multilabel=multilabel, bf16=False), device="cpu")
    task.model.load_state_dict(sd, strict=True)
    x = np.random.default_rng(0).integers(0, 256, (3, 32, 32, 1), np.uint8)
    xf = (x.astype(np.float32) / 255.0 - 0.4722) / 0.3028
    logits = task.eval_step(None, torch.from_numpy(x)).numpy()
    probs = eng(np.repeat(xf, 3, axis=-1))
    want = (1 / (1 + np.exp(-logits)) if multilabel else
            np.exp(logits) / np.exp(logits).sum(-1, keepdims=True))
    np.testing.assert_allclose(probs, want, rtol=1e-5, atol=1e-6)


def test_cli_refuses_what_waits_for_preemption(tmp_path, tiny_cli,
                                               monkeypatch):
    """`--resume` (the JAX CLI reads it nowhere) and orbax directories
    raise, naming ROADMAP's "Not to port" list; ECAMP_PREEMPT_AT_STEP is
    honoured now (`tests/test_torch_finetune_preemption.py` drives it)."""
    base = ["--dataset_path", str(tmp_path), "--device", "cpu",
            "--output_dir", str(tmp_path / "o")]
    with pytest.raises(NotImplementedError,
                       match="--resume .*same --output_dir.*Not to port"):
        tiny_cli.main(base + ["--resume", "x.pth"])
    with pytest.raises(NotImplementedError, match="orbax.*Not to port"):
        tiny_cli.main(base + ["--pretrained", str(tmp_path)])
    monkeypatch.setenv("ECAMP_PREEMPT_AT_STEP", "3")
    tiny_cli.refuse_what_is_not_ported(tiny_cli.get_args(base))


def test_early_stopper_matches_jax():
    from ecamp_tpu.cli.common import EarlyStopper as JaxStopper
    from ecamp_tpu_torch.cli.common import EarlyStopper

    for mode in ("max", "min"):
        a, b = EarlyStopper(2, mode), JaxStopper(2, mode)
        for v in (0.5, 0.6, 0.6, 0.55, 0.7, 0.1, 0.1):
            assert a.update(v) == b.update(v)
            assert (a.best, a.bad, a.should_stop) == (b.best, b.bad,
                                                      b.should_stop)


def test_config_and_factories_match_jax():
    want = dataclasses.asdict(jcfg.ClassificationConfig())
    want.pop("mesh")  # MeshConfig is TPU-only and not ported
    assert dataclasses.asdict(pcfg.ClassificationConfig()) == want
    for name in ("vit_tiny", "vit_base", "vit_base_singlechannel",
                 "vit_large", "vit_huge"):
        assert (dataclasses.asdict(getattr(pcfg, name)(img_size=448))
                == dataclasses.asdict(getattr(jcfg, name)(img_size=448))), name


def test_split_lists_resolve_as_in_jax(tmp_path):
    from ecamp_tpu.data import assets as jassets
    from ecamp_tpu_torch.data import assets

    for w in assets.WORKLOADS:
        assert (os.path.realpath(assets.splits_root(w))
                == os.path.realpath(jassets.splits_root(w)))
    probe = "ChestX-ray14/test_list.txt"
    (tmp_path / "ChestX-ray14").mkdir()
    (tmp_path / probe).write_text("a.png 0\n")
    for explicit, data in (("lists", str(tmp_path)), ("", str(tmp_path)),
                           ("", str(tmp_path / "none"))):
        got = assets.resolve_list_root(explicit, data, "Classification",
                                       probe)
        want = jassets.resolve_list_root(explicit, data, "Classification",
                                         probe)
        assert os.path.realpath(got) == os.path.realpath(want)
    with pytest.raises(ValueError, match="unknown workload"):
        assets.splits_root("Captioning")
