"""Preemption of the port's fine-tune CLIs (`cli/common.py::
FinetunePreemption`, `train_finetune`, `train/state.py::opt_state_dict`),
the counterpart of the JAX drills in `tests/test_preemption.py:255-357`.

`ECAMP_PREEMPT_AT_STEP` (or SIGTERM) makes `cli.finetune_{cls,seg,det}`
write `<output_dir>/preempt/checkpoint-step-<micro>.pth` and exit before
the test; a rerun with the same `--output_dir` resumes at that micro-step.
On the CPU the resumed run ends bit for bit where the uninterrupted one
does: parameters, BatchNorm statistics, optimizer state, the validations
and the test metric. Tiny models and corpora, torch on 2 threads.
"""

import dataclasses
import json
import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ecamp_tpu_torch.ckpt.checkpoint import latest_step_file  # noqa: E402
from ecamp_tpu_torch.cli.common import skip_micro_batches  # noqa: E402
from ecamp_tpu_torch.core import config as pcfg  # noqa: E402
from ecamp_tpu_torch.train.optim import make_optimizer  # noqa: E402
from ecamp_tpu_torch.train.state import (load_opt_state_dict,  # noqa: E402
                                         opt_state_dict)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the optimizer state as a state dict


def _params(seed=0):
    g = torch.Generator().manual_seed(seed)
    shapes = {"patch_embed.proj.weight": (8, 12), "blocks.0.fc.weight": (8, 8),
              "blocks.0.fc.bias": (8,), "blocks.1.fc.weight": (8, 8),
              "norm.weight": (8,), "head.weight": (3, 8), "head.bias": (3,)}
    return {k: torch.randn(s, generator=g) for k, s in shapes.items()}


def _grads(params, seed):
    g = torch.Generator().manual_seed(100 + seed)
    return {k: torch.randn(p.shape, generator=g) for k, p in params.items()}


OPTIMIZERS = {  # name -> (optimizer config, freeze mask?, lr scales?)
    "sgd": (dict(name="sgd", momentum=0.9, weight_decay=1e-2), False, False),
    "adamw": (dict(name="adamw", weight_decay=0.05, grad_clip=1.0), False,
              False),
    "masked": (dict(name="adamw", weight_decay=0.05), True, False),
    "multi_steps": (dict(name="sgd", momentum=0.9, accum_steps=3), True,
                    False),
    "layerwise": (dict(name="adamw", weight_decay=0.05), False, True),
}


def _optimizer(name, params):
    kw, masked, scaled = OPTIMIZERS[name]
    cfg = pcfg.OptimizerConfig(lr=1e-2, schedule="warmup_cosine_step",
                               warmup_steps=2, total_steps=20, **kw)
    mask = {k: not k.startswith("patch_embed") for k in params}
    scales = {k: 0.5 if k.startswith("blocks.0") else 1.0 for k in params}
    return make_optimizer(cfg, freeze_mask=mask if masked else None,
                          lr_scales=scales if scaled else None)


def _tensors(state):
    """Every tensor an optimizer state holds, by path."""
    out = {}
    for k, v in vars(state).items():
        if torch.is_tensor(v):
            out[k] = v
        elif isinstance(v, dict):
            out.update({f"{k}.{n}": t for n, t in v.items()})
        elif dataclasses.is_dataclass(v):
            out.update({f"{k}.{n}": t for n, t in _tensors(v).items()})
    return out


def _assert_same(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif torch.is_tensor(a):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_opt_state_dict_round_trip(tmp_path, name):
    """5 updates, the state through `torch.save` / `torch.load(weights_only
    =True)` into a fresh optimizer's state: copied in place into the same
    tensors, equal, and the next 2 updates bit-equal on both sides;
    MultiSteps stopped mid-cycle (mini_step 2 of 3)."""
    pa = _params()
    tx = _optimizer(name, pa)
    st = tx.init(pa)
    for i in range(5):
        st = tx.apply(pa, _grads(pa, i), st)
    sd = opt_state_dict(st)
    torch.save(sd, tmp_path / "opt.pth")
    loaded = torch.load(tmp_path / "opt.pth", weights_only=True)
    pb = {k: v.clone() for k, v in pa.items()}
    tb = _optimizer(name, pb)
    fresh = tb.init(pb)
    before = _tensors(fresh)
    sb = load_opt_state_dict(fresh, loaded)
    after = _tensors(sb)
    assert before.keys() == after.keys()
    assert all(after[k] is t for k, t in before.items())  # in place
    _assert_same(opt_state_dict(sb), sd)
    if name == "multi_steps":
        assert sb.mini_step == 2 and int(sb.inner_opt_state.count) == 1
    if name == "masked":  # the trainable leaves only
        assert "patch_embed.proj.weight" not in sd["mu"]
    if name == "multi_steps":
        assert "patch_embed.proj.weight" not in sd["acc_grads"]
    for i in range(5, 7):
        st = tx.apply(pa, _grads(pa, i), st)
        sb = tb.apply(pb, _grads(pb, i), sb)
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    _assert_same(opt_state_dict(sb), opt_state_dict(st))


def test_opt_state_dict_mismatch_raises_before_copying():
    """Another kind, a missing or extra leaf, or another shape raises, and
    leaves the optimizer's tensors as they were."""
    p = _params()
    adam = _optimizer("adamw", p)
    st = adam.init(p)
    st = adam.apply(p, _grads(p, 0), st)
    sd = opt_state_dict(st)
    target = adam.init(p)
    with pytest.raises(ValueError, match="'adamw' state"):
        load_opt_state_dict(_optimizer("sgd", p).init(p), sd)
    bad = {**sd, "nu": {k: v for k, v in sd["nu"].items()
                        if k != "head.bias"}}
    with pytest.raises(ValueError, match="missing \\['head.bias'\\]"):
        load_opt_state_dict(target, bad)
    bad = {**sd, "nu": {**sd["nu"], "head.bias": torch.zeros(4)}}
    with pytest.raises(ValueError, match="head.bias: shape"):
        load_opt_state_dict(target, bad)
    assert int(target.count) == 0
    assert all(float(t.abs().sum()) == 0.0
               for t in (*target.mu.values(), *target.nu.values()))


def test_skip_micro_batches_matches_jax():
    from ecamp_tpu.cli.common import skip_micro_batches as jax_skip

    for skip in (0, 1, 3, 7, 12):
        assert (list(skip_micro_batches(iter(range(7)), skip))
                == list(jax_skip(iter(range(7)), skip)))


def test_latest_step_file(tmp_path):
    assert latest_step_file(str(tmp_path / "none")) is None
    assert latest_step_file(str(tmp_path)) is None
    for name in ("checkpoint-step-3.pth", "checkpoint-step-12.pth",
                 "checkpoint-step-40.pth.tmp", "checkpoint-7.pth"):
        (tmp_path / name).write_bytes(b"")
    assert latest_step_file(str(tmp_path)) == str(
        tmp_path / "checkpoint-step-12.pth")


# ---------------------------------------------------------------------------
# the CLIs' drills


def _capture(monkeypatch, cli):
    """Record the task and its state where the CLI's training ends (before
    the test phase reloads the best model)."""
    from ecamp_tpu_torch.cli import common

    got = {}

    def spy(args, task, state, *a, **kw):
        state, preempted = common.train_finetune(args, task, state, *a, **kw)
        got.update(preempted=preempted, state={
            "model": {k: v.detach().clone()
                      for k, v in task.model.state_dict().items()},
            "opt": opt_state_dict(state.opt_state),
            "step": int(state.step),
            "task_step": getattr(task, "step", None)})
        return state, preempted

    monkeypatch.setattr(cli, "train_finetune", spy)
    return got


def _log(out):
    with open(os.path.join(out, "log.txt")) as f:
        return [json.loads(line) for line in f]


def _drill(cli, argv, tmp_path, monkeypatch, capsys, at, accum, per_epoch,
           metric, test_key, marker, resume_epoch=None):
    """The uninterrupted run, the run preempted at micro-step `at`, and its
    rerun: JAX's messages, the file's counters, `preempt/` gone, no test
    after the save, the validations, the test metric and the final state
    bit-equal to the uninterrupted run's."""
    handler = signal.getsignal(signal.SIGTERM)
    got = _capture(monkeypatch, cli)
    ref_out, out = str(tmp_path / "ref"), str(tmp_path / "pre")
    want_metric = cli.main(argv(ref_out))
    ref = got["state"]
    assert not got["preempted"]

    monkeypatch.setenv("ECAMP_PREEMPT_AT_STEP", str(at))
    assert cli.main(argv(out)) is None
    monkeypatch.delenv("ECAMP_PREEMPT_AT_STEP")
    printed = capsys.readouterr().out
    assert got["preempted"]
    step = at // accum
    assert (f"preemption checkpoint saved @ micro {at} (optimizer step "
            f"{step}); rerun with the same --output_dir to resume"
            in printed)
    assert marker not in printed.split("preemption checkpoint saved")[-1]
    path = os.path.join(out, "preempt", f"checkpoint-step-{at}.pth")
    saved = torch.load(path, weights_only=True)
    assert saved["meta"]["micro"] == at and saved["meta"]["step"] == step
    assert saved["meta"]["has_best"]  # after the first validation
    if accum > 1:
        assert saved["opt_state"]["kind"] == "multi_steps"
        assert saved["opt_state"]["mini_step"] == at % accum
    assert signal.getsignal(signal.SIGTERM) is handler

    metric_got = cli.main(argv(out))
    printed = capsys.readouterr().out
    epoch = at // per_epoch if resume_epoch is None else resume_epoch
    assert (f"resuming from preemption checkpoint: micro {at} (optimizer "
            f"step {step}, epoch {epoch})" in printed)
    assert marker in printed
    assert not os.path.exists(os.path.join(out, "preempt"))
    assert not got["preempted"]
    assert signal.getsignal(signal.SIGTERM) is handler

    def vals(recs):
        return [(r["step"], r[metric], r["best"]) for r in recs
                if "step" in r]

    ref_recs, recs = _log(ref_out), _log(out)
    assert vals(recs) == vals(ref_recs) and len(vals(recs)) >= 2
    assert recs[-1][test_key] == ref_recs[-1][test_key]
    assert json.dumps(metric_got) == json.dumps(want_metric)
    _assert_same(got["state"], ref)
    return printed


def _cls_vit(**kw):  # dropout, attention dropout and drop-path all on
    return pcfg.ViTConfig(patch_size=16, embed_dim=64, depth=2, num_heads=2,
                          drop_rate=0.1, attn_drop_rate=0.1, **kw)


@pytest.fixture
def cls_cli(monkeypatch):
    from ecamp_tpu_torch.cli import finetune_cls as cli

    monkeypatch.setitem(cli._VIT_FACTORY, "tiny", _cls_vit)
    return cli


@pytest.fixture(scope="module")
def cls_corpus(tmp_path_factory):
    from ecamp_tpu_torch.data.synthetic import write_classification_corpus

    return write_classification_corpus(
        str(tmp_path_factory.mktemp("cls")), "ChestX-ray14", 16, 6, 6,
        seed=1, num_classes=14, multilabel=True, img_size=40)


def _cls_argv(root, accum):
    def argv(out):
        return ["--dataset_path", root, "--task", "ChestX-ray14", "--model",
                "tiny", "--img_size", "32", "--batch_size", "8",
                "--gradient_accumulation_steps", str(accum),
                "--eval_batch_size", "4", "--num_workers", "2", "--no_bf16",
                "--device", "cpu", "--lr", "0.05", "--warmup_steps", "1",
                "--num_steps", "4", "--patience", "5", "--output_dir", out]
    return argv


@pytest.mark.parametrize("accum", [1, 2])
def test_cls_preempt_resume_is_bit_exact(tmp_path, cls_cli, cls_corpus,
                                         monkeypatch, capsys, accum):
    """Classification with dropout and drop-path (the task's host step,
    which folds their RNG, restored), 16 images at batch 8: accum 1 saves
    at micro 3 (epoch 1, batch 1); accum 2 at micro 5 (epoch 1, batch 1,
    the cycle's first micro-step), after the first validation both."""
    per_epoch = 16 * accum // 8
    at = per_epoch + 1
    _drill(cls_cli, _cls_argv(cls_corpus, accum), tmp_path, monkeypatch,
           capsys, at, accum, per_epoch, "auc", "test", "TEST mean AUROC")


def test_cls_sigterm_saves_and_every_exit_restores_the_handler(
        tmp_path, cls_cli, cls_corpus, monkeypatch, capsys):
    """SIGTERM during micro-step 2 saves at micro 2; an exception in the
    loop restores the SIGTERM handler too."""
    from ecamp_tpu_torch.train.classification import ClassificationTask

    before = signal.getsignal(signal.SIGTERM)
    real = ClassificationTask.train_step
    calls = []

    def term_at_second(self, *a):
        calls.append(1)
        if len(calls) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return real(self, *a)

    monkeypatch.setattr(ClassificationTask, "train_step", term_at_second)
    out = str(tmp_path / "sig")
    assert cls_cli.main(_cls_argv(cls_corpus, 1)(out)) is None
    printed = capsys.readouterr().out
    assert "preemption checkpoint saved @ micro 2 (optimizer step 2)" in \
        printed and "[signal]" in printed
    assert latest_step_file(os.path.join(out, "preempt")).endswith(
        "checkpoint-step-2.pth")
    assert signal.getsignal(signal.SIGTERM) is before

    def fail(self, *a):
        raise RuntimeError("boom")

    monkeypatch.setattr(ClassificationTask, "train_step", fail)
    with pytest.raises(RuntimeError, match="boom"):
        cls_cli.main(_cls_argv(cls_corpus, 1)(str(tmp_path / "fail")))
    assert signal.getsignal(signal.SIGTERM) is before


def _seg_vit(**kw):
    return pcfg.ViTConfig(patch_size=16, embed_dim=32, depth=2, num_heads=2,
                          **kw)


def test_seg_preempt_resume_is_bit_exact(tmp_path, monkeypatch, capsys):
    """SIIM segmentation (AdamW on the masked decoder, the decoder's
    BatchNorm statistics in the file): preempted at the second epoch's
    second micro-step, resumed bit for bit."""
    from ecamp_tpu_torch.cli import finetune_seg as cli
    from ecamp_tpu_torch.data.synthetic import write_segmentation_corpus

    monkeypatch.setitem(cli._VIT_FACTORY, "tiny", _seg_vit)
    root = write_segmentation_corpus(str(tmp_path / "data"), "SIIM", 20, 5,
                                     4, seed=0, img_size=64)
    per_epoch = len(cli.DATASETS["SIIM"](root, root, "train",
                                         img_size=32)) // 8
    assert per_epoch >= 2

    def argv(out):
        return ["--task", "SIIM", "--dataset_path", root, "--model", "tiny",
                "--img_size", "32", "--decode_features", "16,8,8,4",
                "--batch_size", "8", "--eval_batch_size", "4", "--lr",
                "1e-2", "--warmup_steps", "1", "--device", "cpu",
                "--num_workers", "2", "--no_bf16", "--num_steps",
                str(3 * per_epoch), "--patience", "5", "--output_dir", out]

    _drill(cli, argv, tmp_path, monkeypatch, capsys, per_epoch + 1, 1,
           per_epoch, "dice", "test_dice", "TEST dice")


def test_det_preemption_file_supersedes_resume(tmp_path, monkeypatch,
                                               capsys):
    """RSNA detection from `--resume <best .pth>` of a 2-update run (8
    images at batch 4: 2 updates an epoch, so the run starts at epoch 1):
    preempted at micro 5 (epoch 2, batch 1, after the validation at update
    4), then the same command again: the preemption file wins over
    `--resume`, AdamW's count and moments included, bit for bit."""
    from ecamp_tpu_torch.cli import finetune_det as cli
    from ecamp_tpu_torch.data.synthetic import write_detection_corpus

    monkeypatch.setitem(cli._VIT_FACTORY, "tiny", _seg_vit)
    root = write_detection_corpus(str(tmp_path / "data"), "RSNA", 8, 3, 2,
                                  seed=2, img_size=64)
    common = ["--dataset_path", root, "--model", "tiny", "--img_size", "32",
              "--batch_size", "4", "--eval_batch_size", "3", "--lr", "1e-3",
              "--warmup_steps", "1", "--device", "cpu", "--num_workers",
              "2", "--no_bf16", "--patience", "5"]
    first = str(tmp_path / "first")
    cli.main(common + ["--num_steps", "2", "--output_dir", first])
    capsys.readouterr()

    def argv(out):
        return common + ["--num_steps", "6", "--resume", first,
                         "--output_dir", out]

    printed = _drill(cli, argv, tmp_path, monkeypatch, capsys, 5, 1, 2,
                     "mAP", "test_map", "TEST mAP")
    assert "resumed from step 2" in printed
    assert printed.index("resumed from step 2") < printed.index(
        "resuming from preemption checkpoint")
    np.testing.assert_array_equal(
        [r["step"] for r in _log(str(tmp_path / "pre")) if "step" in r],
        [4, 6])
