"""Data-parallel fine-tuning in the port (`core/distributed.py`'s
differentiable all-reduce and row gather, the global-batch `BatchNorm` and
soft dice, the rank-aware fine-tune tasks, `cli/common.py::ShardedEval` and
the three fine-tune CLIs under a launcher) on the CPU, over gloo ranks
spawned by `tests/torch_dp_ranks.py`, at tiny sizes (2 ranks x 2 rows,
the 2-layer ViT of 32 px of the tasks' own tests):

  (i)   `BatchNorm` on 2 ranks against one process at the global batch:
        output, running statistics, input and weight gradients; eval mode
        calls no collective;
  (ii)  `mixed_loss` with the global dice: value and logit gradients;
  (iii) the segmentation, detection and classification tasks on 2 ranks
        against the JAX tasks on a 2-device CPU mesh, from the same
        weights, 3 steps;
  (iv)  `ShardedEval`'s index math against JAX's, its gathers on 2 ranks
        against one process;
  (v)   `cli.finetune_seg` and `cli.finetune_det` on 2 ranks: one log, one
        validation metric on both ranks, a test line; the segmentation run
        preempted at micro-step 3 and resumed equals the uninterrupted one;
  (vi)  `cli.finetune_cls` on 2 ranks writes one run, not two.

One spawn of 2 ranks runs (i)-(iv) and one the CLI runs of (v)-(vi).
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_classification as tc  # noqa: E402
import test_torch_detection as td  # noqa: E402
import test_torch_segmentation as ts  # noqa: E402
import torch_dp_ranks as ranks  # noqa: E402
from ecamp_tpu.cli.common import ShardedEval as JaxShardedEval  # noqa: E402
from ecamp_tpu.core import config as jcfg  # noqa: E402
from ecamp_tpu.core.mesh import cpu_test_mesh  # noqa: E402
from ecamp_tpu.core.mesh import place_finetune_state, shard_batch  # noqa: E402
from ecamp_tpu.train.classification import \
    ClassificationTask as JaxClsTask  # noqa: E402
from ecamp_tpu.train.detection import DetectionTask as JaxDetTask  # noqa: E402
from ecamp_tpu.train.detection import _det_freeze_mask  # noqa: E402
from ecamp_tpu.train.optim import \
    make_optimizer as jax_make_optimizer  # noqa: E402
from ecamp_tpu.train.segmentation import \
    SegmentationTask as JaxSegTask  # noqa: E402
from ecamp_tpu.train.state import TrainState as JaxTrainState  # noqa: E402
from ecamp_tpu_torch.ckpt import state_dict_from_flax  # noqa: E402
from ecamp_tpu_torch.cli.common import ShardedEval  # noqa: E402
from ecamp_tpu_torch.core import config as pcfg  # noqa: E402
from ecamp_tpu_torch.nn.layers import BatchNorm  # noqa: E402
from ecamp_tpu_torch.ops.losses import mixed_loss  # noqa: E402

WORLD, B = 2, 2   # ranks, rows a rank
G = WORLD * B     # the global batch
STEPS = 3
LOSS_RTOL = 1e-4  # (iii): the JAX tasks' losses, relative
STATS_TOL = 1e-5  # (iii): the BatchNorm running statistics
EXACT_TOL = 1e-6  # (i), (ii): one process at the global batch

# The bias of each segmentation decoder conv that feeds a BatchNorm has a
# zero gradient in exact arithmetic (the norm subtracts the channel mean),
# so both sides hand AdamW rounding noise, which it turns into lr-sized
# steps of either sign that the running means take in: (iii) leaves those
# biases out of both sides' optimizers (test_torch_segmentation's
# `test_adamw_steps_match_jax` subtracts their drift instead).
SEG_PRE_BN_BIAS = r"decoder\w*\.decoder_\d+\.0\.bias$"
JAX_PRE_BN_BIAS = r"decoder\w*/decoder_\d+_conv/bias$"


def _close(got, want, tol, what=""):
    """max |got - want| <= tol times the reference's scale (at least 1)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, \
        f"{what}: max|err| {err:.3e} > {tol * scale:.3e}"


# ---------------------------------------------------------------------------
# the inputs of (i)-(iv)

BN_C = 6


def _bn_inputs():
    rng = np.random.default_rng(0)
    x = (1.5 + 2.0 * rng.normal(size=(G, BN_C, 3, 5))).astype(np.float32)
    w_out = rng.normal(size=x.shape).astype(np.float32)
    state = {"weight": (1 + 0.2 * rng.normal(size=BN_C)).astype(np.float32),
             "bias": (0.1 * rng.normal(size=BN_C)).astype(np.float32),
             "running_mean": (0.1 * rng.normal(size=BN_C)).astype(np.float32),
             "running_var": rng.uniform(0.5, 1.5, BN_C).astype(np.float32),
             "num_batches_tracked": np.array(3, np.int64)}
    return x, w_out, state


def _dice_inputs():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(G, 16, 16)).astype(np.float32)
    targets = (rng.random((G, 16, 16)) < 0.3).astype(np.float32)
    return logits, targets


GATHER_N = (5, 1)  # 5 = 2 * 3 - 1: one wrap-padded row; 1 < the ranks


def _gather_inputs(n):
    rng = np.random.default_rng(n)
    rows = rng.normal(size=(n, 3)).astype(np.float64)
    ragged = [None if i % 3 == 1 else
              rng.normal(size=(1 + i % 4, 7)).astype(np.float32)
              for i in range(n)]
    return rows, ragged


def _seg_case():
    """(JAX variables, the global batches) of the segmentation task."""
    model = ts._jax_model(False)
    v = jax.jit(lambda r: model.init(r, jnp.zeros((2, ts.IMG, ts.IMG, 3)),
                                     train=False))(jax.random.PRNGKey(4))
    v = ts._perturb(v, seed=4)
    return v, [(ts._images(10 + i, G), ts._masks(20 + i, False, G))
               for i in range(STEPS)]


DET_EXPANSION = 8


def _det_case():
    """The weights and batches of test_torch_detection's AdamW parity
    (`jax_vars_grad`, expansion 8), in float64 on both sides at
    td.GRAD_IMG (64 px): in fp32 at 32 px its BatchNorms over 4 samples of
    1^2 maps part any two implementations by ~4e-3 of a gradient (that
    module's note), which 3 AdamW steps turn into a 1% loss gap, and its
    coarse map's BatchNorm makes other seeds' 3-step losses part by up to
    3e-4 even in float64 (measured: one process or two alike)."""
    e = DET_EXPANSION
    model = td._jax_model(e)
    v = jax.jit(lambda r: model.init(r, jnp.zeros((2, td.IMG, td.IMG, 3)),
                                     train=False))(jax.random.PRNGKey(e))
    v = td._perturb(v, seed=e)
    trunk = v["params"]["backbone"]["encoder"]["trunk"]
    n = (td.GRAD_IMG // 16) ** 2 + 1
    trunk["pos_embed"] = (0.02 * np.random.default_rng(e).normal(
        size=(1, n, trunk["pos_embed"].shape[-1]))).astype(np.float32)
    return v, [(td._images(10 + i, G, td.GRAD_IMG), td._targets(
        20 + i, G, grids=td.GRAD_GRIDS)) for i in range(STEPS)]


def _cls_case():
    task = JaxClsTask(tc._cfg(jcfg, True, False, 1), mesh=cpu_test_mesh(1))
    params = jax.jit(lambda r: task.model.init(
        r, jnp.zeros((2, tc.IMG, tc.IMG, 3))))(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    rng = np.random.default_rng(100)  # a head wide enough to move the trunk
    params["head"]["kernel"] = rng.normal(
        0, 0.2, params["head"]["kernel"].shape).astype(np.float32)
    return {"params": params}, [tc._batch(10 + i, True)
                                for i in range(STEPS)]


def _jax_steps(kind, v, batches):
    """3 steps of the JAX task on a 2-device mesh from variables `v`: the
    losses and the final variables (numpy)."""
    mesh = cpu_test_mesh(WORLD)
    dtype = jnp.float64 if kind == "det" else jnp.float32
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype),
                                    v["params"])
    mask = None  # the task's freeze mask, as its init_state builds it
    if kind == "seg":
        task = JaxSegTask(ts._cfg(jcfg, False), mesh=mesh)

        def trainable(path, _):
            keys = "/".join(getattr(k, "key", "") for k in path)
            return not (keys.startswith("encoder/trunk/")
                        or re.search(JAX_PRE_BN_BIAS, keys))

        mask = jax.tree_util.tree_map_with_path(trainable, params)
    elif kind == "det":
        task = JaxDetTask(td._cfg(jcfg, True, DET_EXPANSION, td.GRAD_IMG),
                          mesh=mesh)
        task.model = td.JaxDetectionModel(td._vit(jcfg, td.GRAD_IMG),
                                          expansion=DET_EXPANSION,
                                          dtype=jnp.float64)
        mask = _det_freeze_mask(params, True, "vit")
    else:
        task = JaxClsTask(tc._cfg(jcfg, True, False, 1), mesh=mesh)
    task.tx = jax_make_optimizer(task.cfg.optimizer, freeze_mask=mask)
    stats = v.get("batch_stats")
    state = place_finetune_state(mesh, JaxTrainState.create(
        params, task.tx, batch_stats=None if stats is None else
        jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), stats)))
    losses = []
    for batch in batches:
        state, m = task.train_step(state, *(shard_batch(mesh, a)
                                            for a in batch))
        losses.append(float(m["loss"]))
    final = {"params": jax.tree_util.tree_map(np.asarray, state.params)}
    if stats is not None:
        final["batch_stats"] = jax.tree_util.tree_map(np.asarray,
                                                      state.batch_stats)
    return losses, final


def _port_cfg(kind):
    if kind == "seg":
        return ts._cfg(pcfg, False)
    if kind == "det":
        return td._cfg(pcfg, True, DET_EXPANSION, td.GRAD_IMG)
    return tc._cfg(pcfg, True, False, 1)


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """Both spawns of 2 gloo ranks, started at once so that they run while
    the JAX tasks compile: (i)-(iv)'s parts and the CLI runs of (v)-(vi).
    Yields (the parts' spawn, the JAX tasks' inputs, the CLIs' spawn and
    their directories)."""
    cases = {"seg": _seg_case(), "det": _det_case(), "cls": _cls_case()}
    x, w_out, state = _bn_inputs()
    logits, targets = _dice_inputs()
    parts = {"bn": ("_bn_part", dict(x=x, w_out=w_out, state=state)),
             "dice": ("_dice_part", dict(logits=logits, targets=targets))}
    for kind, (v, batches) in cases.items():
        weights = {k: t.numpy() for k, t in state_dict_from_flax(
            v["params"], v.get("batch_stats")).items()}
        parts[kind] = ("_task_part", dict(
            kind=kind, cfg=_port_cfg(kind), weights=weights,
            batches=batches, float64=kind == "det",
            frozen=SEG_PRE_BN_BIAS if kind == "seg" else None))
    for n in GATHER_N:
        rows, ragged = _gather_inputs(n)
        parts[f"gather{n}"] = ("_gather_part", dict(
            n=n, rows=rows, ragged=ragged, cols=5))
    parts_run = ranks.start("finetune_parts", WORLD,
                            tmp_path_factory.mktemp("dpft"), parts=parts)
    cli_runs, dirs = _cli_runs(tmp_path_factory.mktemp("dpcli"))
    yield parts_run, cases, cli_runs, dirs
    ranks.stop(parts_run)  # ranks a failure left uncollected
    ranks.stop(cli_runs)


@pytest.fixture(scope="module")
def runs(started):
    """(i)-(iv): the port on 2 gloo ranks, one process at the global batch
    and the JAX tasks on a 2-device mesh."""
    parts_run, cases = started[:2]
    jax_runs = {kind: _jax_steps(kind, *case) for kind, case in cases.items()
                if kind != "det"}
    with jax.enable_x64(True):
        jax_runs["det"] = _jax_steps("det", *cases["det"])
    return {"port": ranks.collect(parts_run), "jax": jax_runs}


def _one_process_bn():
    x, w_out, state = _bn_inputs()
    bn = BatchNorm(BN_C)
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    xt = torch.from_numpy(x).requires_grad_(True)
    y = bn(xt, train=True)
    (y * torch.from_numpy(w_out)).sum().backward()
    return bn, xt, y


def test_batch_norm_takes_the_global_batch(runs):
    """(i) The train-mode BatchNorm on 2 ranks x 2 rows equals one process
    at 4 rows within 1e-6 (fp32): each rank's output rows, the running
    statistics (equal on both ranks), the input's gradient rows and the
    weight and bias gradients summed over the ranks, for the sum of the
    output against fixed weights (the statistics' all-reduce sums the
    ranks' gradients in its backward). The forward and the backward call
    one all-reduce each; eval mode, on a different number of rows on each
    rank, calls none."""
    bn, xt, y = _one_process_bn()
    got = [r["bn"] for r in runs["port"]]
    _close(torch.cat([g["y"] for g in got]), y.detach(), EXACT_TOL, "y")
    _close(torch.cat([g["x_grad"] for g in got]), xt.grad, EXACT_TOL, "dx")
    for k in ("weight", "bias"):
        _close(sum(g[f"{k}_grad"] for g in got),
               getattr(bn, k).grad, EXACT_TOL, f"d{k}")
    for k in ("running_mean", "running_var"):
        assert torch.equal(got[0][k], got[1][k]), k
        _close(got[0][k], getattr(bn, k), EXACT_TOL, k)
    assert [g["calls"] for g in got] == [(2, 0)] * WORLD


def test_mixed_loss_takes_the_global_dice(runs):
    """(ii) `mixed_loss` on 2 ranks: the ranks' mean loss equals one
    process's at the global batch, and each rank's logit gradient divided
    by the world size (its share of the averaged gradient) equals one
    process's rows, within 1e-6; the dice is global (a per-rank dice gives
    another loss)."""
    logits, targets = _dice_inputs()
    lt = torch.from_numpy(logits).requires_grad_(True)
    loss = mixed_loss(lt, torch.from_numpy(targets))
    loss.backward()
    got = [r["dice"] for r in runs["port"]]
    mean = sum(g["loss"] for g in got) / WORLD
    assert abs(mean - float(loss)) <= EXACT_TOL * abs(float(loss))
    _close(torch.cat([g["grad"] for g in got]) / WORLD, lt.grad, EXACT_TOL,
           "dlogits")
    local = sum(float(mixed_loss(torch.from_numpy(logits[r * B:(r + 1) * B]),
                                 torch.from_numpy(targets[r * B:(r + 1) * B])))
                for r in range(WORLD)) / WORLD
    assert abs(local - float(loss)) > 1e-4


@pytest.mark.parametrize("kind", ["seg", "det", "cls"])
def test_two_ranks_match_the_jax_task_on_two_devices(runs, kind):
    """(iii) The port's segmentation (SIIM, frozen trunk, AdamW),
    detection (frozen trunk, AdamW, collision-free targets; float64 at 64
    px, see `_det_case`) and
    classification (SGD, drop-path 0) tasks on 2 ranks x 2 rows against
    the JAX task on a 2-device CPU mesh at 4 rows, from the same weights:
    3 steps' losses within 1e-4 relative on both ranks, the BatchNorm
    running statistics within 1e-5, and the ranks' parameter and
    BatchNorm-buffer checksums equal."""
    want_losses, final = runs["jax"][kind]
    got = [r[kind] for r in runs["port"]]
    for r, g in enumerate(got):
        for i, (a, b) in enumerate(zip(g["losses"], want_losses)):
            assert abs(a - b) <= LOSS_RTOL * abs(b), (r, i, a, b)
    assert got[0]["param_sum"] == got[1]["param_sum"]
    assert got[0]["buffer_sum"] == got[1]["buffer_sum"]
    if kind == "cls":
        return
    want = state_dict_from_flax(final["params"], final["batch_stats"])
    assert got[0]["stats"]
    for k, t in got[0]["stats"].items():
        _close(t.numpy(), want[k].numpy(), STATS_TOL, k)


@pytest.mark.parametrize("n", [1, 5, 11, 64])
@pytest.mark.parametrize("procs", [1, 2, 3, 8])
def test_sharded_eval_indices_match_jax(n, procs):
    """(iv) Each process's shard (position k of process p holds sample
    (p + k P) mod n, wrap-padded to ceil(n / P)) equals JAX's, also where
    n < P; together the shards cover every sample, and the first n of
    the interleaved positions are the samples in order."""
    mine, theirs = [], []
    for p in range(procs):
        se, je = ShardedEval(n), JaxShardedEval(n)
        for e in (se, je):
            e.pid, e.P = p, procs
            e.n_local = -(-n // procs) if procs > 1 else n
        mine.append(se.local_indices())
        theirs.append(je.local_indices())
        np.testing.assert_array_equal(mine[-1], theirs[-1])
    order = np.stack(mine, axis=1).reshape(-1)[:n]
    np.testing.assert_array_equal(order, np.arange(n))


def test_sharded_eval_gathers_equal_one_process(runs):
    """(iv) `gather` of a per-sample array and `gather_ragged` of a list
    of boxes (None, or (k, 7) cut to 5 columns) on 2 ranks give every rank
    what one process holds, in dataset order, for n = 5 (one wrap-padded
    row) and n = 1 (fewer samples than ranks)."""
    for n in GATHER_N:
        rows, ragged = _gather_inputs(n)
        one = ShardedEval(n)
        assert not one.distributed
        np.testing.assert_array_equal(one.gather(rows), rows)
        want = one.gather_ragged(ragged, 5)
        for r, res in enumerate(runs["port"]):
            g = res[f"gather{n}"]
            np.testing.assert_array_equal(
                g["indices"], (r + WORLD * np.arange(-(-n // WORLD))) % n)
            np.testing.assert_array_equal(g["rows"], rows)
            assert len(g["ragged"]) == n
            for a, b in zip(g["ragged"], want):
                if b is None:
                    assert a is None
                else:
                    np.testing.assert_array_equal(
                        a, np.asarray(b, np.float32)[:, :5])


# ---------------------------------------------------------------------------
# (v), (vi): the CLIs on 2 ranks

SEG_PREEMPT_AT = 3


def _seg_argv(root, out):
    return ["--task", "SIIM", "--dataset_path", root, "--model", "tiny",
            "--img_size", "32", "--decode_features", "16,8,8,4",
            "--batch_size", "4", "--eval_batch_size", "3", "--lr", "1e-2",
            "--warmup_steps", "1", "--device", "cpu", "--num_workers", "2",
            "--no_bf16", "--num_steps", "6", "--patience", "5",
            "--output_dir", out]


def _det_argv(root, out):
    return ["--task", "RSNA", "--dataset_path", root, "--model", "tiny",
            "--img_size", "32", "--batch_size", "2", "--eval_batch_size",
            "2", "--lr", "1e-3", "--warmup_steps", "1", "--device", "cpu",
            "--num_workers", "2", "--no_bf16", "--num_steps", "4",
            "--start_eval", "1", "--patience", "5", "--output_dir", out]


def _cls_argv(root, out):
    return ["--task", "ChestX-ray14", "--dataset_path", root, "--model",
            "tiny", "--img_size", "32", "--batch_size", "4",
            "--eval_batch_size", "4", "--num_workers", "2", "--no_bf16",
            "--device", "cpu", "--lr", "0.05", "--warmup_steps", "1",
            "--num_steps", "4", "--patience", "5", "--output_dir", out]


def _cli_runs(tmp):
    """Start the CLI runs on 2 gloo ranks (one spawn): SIIM segmentation
    uninterrupted, preempted at micro-step SEG_PREEMPT_AT (the ranks
    agreeing every micro-step) and resumed; RSNA detection with its
    validation split of 3 over 2 ranks (a wrap-padded row); ChestX-ray14
    classification. Returns (the spawn, the corpora and output
    directories)."""
    from ecamp_tpu_torch.data.synthetic import (write_classification_corpus,
                                                write_detection_corpus,
                                                write_segmentation_corpus)

    seg = write_segmentation_corpus(str(tmp / "seg"), "SIIM", 20, 5, 4,
                                    seed=0, img_size=64)
    det = write_detection_corpus(str(tmp / "det"), "RSNA", 8, 3, 3, seed=2,
                                 img_size=64)
    cls = write_classification_corpus(str(tmp / "cls"), "ChestX-ray14", 16,
                                      6, 5, seed=1, num_classes=14,
                                      multilabel=True, img_size=40)
    outs = {k: str(tmp / k) for k in ("seg_ref", "seg_pre", "det", "cls")}
    runs = [
        {"cli": "finetune_seg", "argv": _seg_argv(seg, outs["seg_ref"])},
        {"cli": "finetune_seg", "argv": _seg_argv(seg, outs["seg_pre"]),
         "env": {"ECAMP_PREEMPT_AT_STEP": str(SEG_PREEMPT_AT)},
         "sync_every": 1},
        {"cli": "finetune_seg", "argv": _seg_argv(seg, outs["seg_pre"])},
        {"cli": "finetune_det", "argv": _det_argv(det, outs["det"])},
        {"cli": "finetune_cls", "argv": _cls_argv(cls, outs["cls"])}]
    return (ranks.start("finetune_clis", WORLD, tmp / "ranks", runs=runs),
            {"outs": outs, "data": {"seg": seg}})


@pytest.fixture(scope="module")
def clis(started):
    """The CLI runs' results a run: each rank's."""
    cli_runs, dirs = started[2:]
    got = ranks.collect(cli_runs)
    names = ("seg_ref", "seg_pre", "seg_resumed", "det", "cls")
    return {**dirs, **{name: [r[i] for r in got]
                       for i, name in enumerate(names)}}


def _log(out):
    with open(os.path.join(out, "log.txt")) as f:
        return [json.loads(line) for line in f]


def _one_run(ranks_of_run, out, test_key):
    """One log, written by rank 0: every rank produced the same records,
    validations and a test line; rank 1 printed nothing; the ranks ended
    with equal states; one best `.pth`."""
    r0, r1 = ranks_of_run
    lines = [json.dumps(r) for r in r0["records"]]
    assert lines == [json.dumps(r) for r in r1["records"]]
    with open(os.path.join(out, "log.txt")) as f:
        assert f.read().splitlines() == lines
    vals = [r for r in r0["records"] if "step" in r]
    assert vals and lines[-1] == json.dumps({test_key: r0["result"]})
    assert json.dumps(r0["result"]) == json.dumps(r1["result"])
    assert r0["checksum"] == r1["checksum"]
    assert r1["printed"] == ""
    assert os.path.isfile(os.path.join(out, "best", "checkpoint-best.pth"))
    return vals


def test_seg_cli_on_two_ranks(clis):
    """(v) `finetune_seg` on 2 ranks x 4 rows: the validations every epoch
    of updates of a rank's shard, the same dice on both ranks, one log
    from rank 0, the test line; the global batch drives the BatchNorms, so
    the ranks' BatchNorm statistics are equal."""
    vals = _one_run(clis["seg_ref"], clis["outs"]["seg_ref"], "test_dice")
    from ecamp_tpu_torch.cli import finetune_seg as cli

    root = clis["data"]["seg"]
    n = len(cli.DATASETS["SIIM"](root, root, "train", img_size=32))
    per_epoch = -(-n // WORLD) // 4
    assert per_epoch >= 2
    assert [r["step"] for r in vals] == [per_epoch * (i + 1)
                                         for i in range(len(vals))]
    assert f"TEST dice: {clis['seg_ref'][0]['result']:.4f}" in \
        clis["seg_ref"][0]["printed"]
    m0, m1 = (r["model"] for r in clis["seg_ref"])
    for k, t in m0.items():
        assert torch.equal(t, m1[k]), k


def test_seg_cli_preempted_on_two_ranks_resumes_exactly(clis):
    """(v) The 2-rank segmentation run preempted at micro-step 3 (epoch 1,
    after the first validation; both ranks stop there) and rerun equals
    the uninterrupted 2-rank run bit for bit: the validations, the test
    dice, the model with its BatchNorm statistics and the optimizer
    state."""
    pre, resumed, ref = clis["seg_pre"], clis["seg_resumed"], clis["seg_ref"]
    assert all(r["result"] is None and r["preempted"] for r in pre)
    assert (f"preemption checkpoint saved @ micro {SEG_PREEMPT_AT}"
            in pre[0]["printed"])
    assert pre[1]["printed"] == ""
    assert "resuming from preemption checkpoint: micro 3" in \
        resumed[0]["printed"]
    out = clis["outs"]["seg_pre"]
    assert not os.path.exists(os.path.join(out, "preempt"))
    vals = [(r["step"], r["dice"], r["best"]) for r in _log(out)
            if "step" in r]
    assert vals == [(r["step"], r["dice"], r["best"])
                    for r in _log(clis["outs"]["seg_ref"]) if "step" in r]
    for got, want in zip(resumed, ref):
        assert got["result"] == want["result"]
        assert got["step"] == want["step"]
        for k, t in want["model"].items():
            assert torch.equal(got["model"][k], t), k
        assert json.dumps(_opt_sums(got["opt"])) == json.dumps(
            _opt_sums(want["opt"]))


def _opt_sums(sd):
    """An optimizer state dict with each tensor replaced by its exact
    float64 sum and shape."""
    if isinstance(sd, dict):
        return {k: _opt_sums(v) for k, v in sd.items()}
    if isinstance(sd, torch.Tensor):
        return [float(sd.double().sum()), list(sd.shape)]
    return sd


def test_det_cli_on_two_ranks(clis):
    """(v) `finetune_det` on 2 ranks x 2 rows, validation every epoch from
    `--start_eval 1` over a split of 3 (rank 1 scores a wrap-padded copy
    of sample 0, which the gather drops): the same mAP on both ranks, one
    log from rank 0, the best `.pth` with its step, the test line."""
    vals = _one_run(clis["det"], clis["outs"]["det"], "test_map")
    assert [r["step"] for r in vals] == [2, 4]
    assert all(0.0 <= r["mAP"] <= 1.0 for r in vals)
    best = torch.load(os.path.join(clis["outs"]["det"], "best",
                                   "checkpoint-best.pth"), weights_only=True)
    assert best["step"] in (2, 4)


def test_cls_cli_on_two_ranks_writes_one_run(clis):
    """(vi) `finetune_cls` on 2 ranks x 4 rows writes one run into its
    `--output_dir`, not two: one log line a validation (2 updates an
    epoch of a rank's 8 rows, 4 updates) and one test line, from rank 0,
    equal on both ranks."""
    vals = _one_run(clis["cls"], clis["outs"]["cls"], "test")
    assert [r["step"] for r in vals] == [2, 4]
    log = _log(clis["outs"]["cls"])
    assert len(log) == 3
