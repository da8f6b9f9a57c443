"""K pretraining steps a call on the port (`PretrainTask.make_train_step_scan`,
`python -m ecamp_tpu_torch.cli.pretrain --steps_per_call K`), on the CPU:

  * the port's K-step call against JAX's `make_train_step_scan` (a
    `lax.scan` of the step over a (K, B, ...) superbatch) from the same
    weights, batches and masking noise;
  * the K-step call against K single port steps, bit for bit, with
    dropout on and the noise drawn from the task's generators: plain,
    accumulation 2 with a cycle that crosses a call, and a start
    mid-cycle;
  * the CLI with `--steps_per_call 3` over 4 micro-steps an epoch (a group
    of 3 and a tail of 1) against `--steps_per_call 1`, and a preemption
    at a call's end resumed with the same K.

On a card the K steps are CUDA graphs of the step
(`tests/test_torch_kernels_cuda.py` and `chip_smoke.py` (g) hold them
against eager steps); here they run in order.
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
from ecamp_tpu_torch.cli import pretrain as cli  # noqa: E402
from ecamp_tpu_torch.core import config as pcfg  # noqa: E402
from ecamp_tpu_torch.train.pretrain import PretrainTask  # noqa: E402
from ecamp_tpu_torch.train.state import adamw_state  # noqa: E402
from test_torch_accum import (_corpus, _exact_grad, cli_argv,  # noqa: E402
                              read_log, tiny_cli)
from test_torch_pretrain import NOISE, _batch, _tiny  # noqa: E402

K = 3
LOSS_RTOL = 1e-5  # the (K,) losses against JAX's, relative
# the parameters against JAX's: each element within the fine-tune step
# tests' 1e-4 (tests/test_torch_classification.py), all of them together
# within PARAM_L2 of their movement from the initial weights (L2). AdamW
# moves an element by about lr a step whatever its gradient's size, so an
# element whose gradient is near zero turns a rounding difference into a
# part of a step (the K single steps differ from JAX's by the same).
PARAM_ATOL = 1e-4
PARAM_L2 = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs six workers on the machine's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _scan_cfg(lib):
    """The tiny config of tests/test_train_steps.py:185 (ViT depth 1, one
    BERT layer, AdamW at a constant lr 1e-3, fp32), dropout off: JAX's step
    always applies dropout, so the port's runs deterministic."""
    c = _tiny(lib)
    return dataclasses.replace(
        c, vit=dataclasses.replace(c.vit, depth=1),
        bert=dataclasses.replace(c.bert, num_hidden_layers=1))


@pytest.fixture(scope="module")
def jax_scan():
    """JAX's scan of K steps on batches 5-7 with NOISE as every step's
    masking draw: the initial params, the (K,) metrics and the final
    params."""
    cfg = _scan_cfg(jcfg)
    task = JaxPretrainTask(cfg, mesh=make_mesh(cfg.mesh,
                                               devices=jax.devices()[:1]))
    params = jax.jit(lambda r: task.model.init(
        {"params": r, "masking": jax.random.fold_in(r, 1)},
        task.fake_batch(2), mask_ratio=cfg.mask_ratio,
        deterministic=True))(jax.random.PRNGKey(0))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    state = task.place_state(JaxTrainState.create(
        jax.tree_util.tree_map(jnp.asarray, params), task.tx))
    uniform = jax.random.uniform

    def fake(key, shape=(), *args, **kwargs):
        if tuple(shape) == NOISE.shape:
            return jnp.asarray(NOISE)
        return uniform(key, shape, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", fake)  # while the scan is traced
        scan = task.make_train_step_scan(state)
        state, metrics = scan(state, task.shard_superbatch(
            [_batch(5 + i) for i in range(K)]), jax.random.PRNGKey(7))
    assert int(state.step) == K
    return (params, {k: np.asarray(v) for k, v in metrics.items()},
            state_dict_from_flax(jax.device_get(state.params)))


def test_scan_matches_jax_scan(jax_scan):
    """The port's K-step call from JAX's weights on the same superbatch and
    noise (`_scan_cfg`): the (K,) losses
    within LOSS_RTOL, the lr exact, the parameters within PARAM_ATOL and
    PARAM_L2 (without the attention key biases, whose gradient is 0 in
    exact arithmetic), the step and AdamW's count K."""
    params, want, want_params = jax_scan
    task = PretrainTask(_scan_cfg(pcfg), device="cpu")
    task.model.load_state_dict(state_dict_from_flax(params), strict=True)
    state = task.init_state()
    scan = task.make_train_step_scan(state, K)
    superbatch = task.put_superbatch([_batch(5 + i) for i in range(K)])
    assert tuple(superbatch["image"].shape) == (K, 2, 64, 64, 3)
    noise = torch.from_numpy(np.stack([NOISE] * K))
    state, metrics = scan(state, superbatch, noise, deterministic=True)
    for k in ("loss", "mim_loss", "res_loss", "mlm_loss"):
        assert tuple(metrics[k].shape) == (K,)
        np.testing.assert_allclose(metrics[k].numpy(), want[k],
                                   rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_array_equal(metrics["lr"].numpy(), want["lr"])
    assert int(state.step) == task.step == K
    assert int(adamw_state(state.opt_state).count) == K
    got = _exact_grad(task.model.state_dict())
    init = _exact_grad(state_dict_from_flax(params))
    err2 = moved2 = 0.0
    for k, w in _exact_grad(want_params).items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)
        err2 += float(((got[k] - w).double() ** 2).sum())
        moved2 += float(((w - init[k]).double() ** 2).sum())
    assert err2 <= PARAM_L2 ** 2 * moved2, (err2 / moved2) ** 0.5


def _dropout_cfg(accum: int):
    """The tiny config with BERT dropout on and the CLI's epoch cosine
    (warmup 1 epoch of 3 micro-steps, so every update's lr differs)."""
    c = _tiny(pcfg)
    return dataclasses.replace(
        c, max_epoch=4,
        bert=dataclasses.replace(c.bert, hidden_dropout_prob=0.1,
                                 attention_probs_dropout_prob=0.1),
        optimizer=pcfg.OptimizerConfig(lr=1e-3, warmup_epochs=1,
                                       accum_steps=accum))


def _snapshot(task, state):
    st = state.opt_state
    adam = adamw_state(st)
    return {"params": {k: v.clone() for k, v in task.model.state_dict()
                       .items()},
            "mu": {k: v.clone() for k, v in adam.mu.items()},
            "nu": {k: v.clone() for k, v in adam.nu.items()},
            "acc": {k: v.clone() for k, v in getattr(st, "acc_grads",
                                                     {}).items()},
            "counters": (int(state.step), task.step, int(adam.count),
                         getattr(st, "mini_step", None))}


@pytest.mark.parametrize("accum,first", [(1, 0), (2, 0), (2, 1)],
                         ids=["plain", "accum2_across_calls",
                              "accum2_mid_cycle"])
def test_scan_matches_single_steps_bitwise(accum, first):
    """`first` single steps, then two K-step calls (dropout on, the noise
    from the masking generator), against 2 K + `first` single steps from
    the same seed: every metric, the parameters, moments, running mean,
    step, count and cycle bit for bit. Under accumulation 2 a cycle
    crosses the calls' boundary; with `first` 1 the calls start
    mid-cycle."""
    batches = [_batch(20 + i) for i in range(first + 2 * K)]
    runs = []
    for scanned in (False, True):
        task = PretrainTask(_dropout_cfg(accum), device="cpu",
                            steps_per_epoch=3)
        state = task.init_state()
        metrics = []
        for b in batches[:first if scanned else len(batches)]:
            state, m = task.train_step(state, task.put_batch(b))
            metrics.append({k: float(v) for k, v in m.items()})
        if scanned:
            scan = task.make_train_step_scan(state, K)
            for c in range(2):
                group = batches[first + c * K:first + (c + 1) * K]
                state, m = scan(state, task.put_superbatch(group))
                metrics += [{k: float(v[i]) for k, v in m.items()}
                            for i in range(K)]
        runs.append((metrics, _snapshot(task, state)))
    (want, ref), (got, res) = runs
    assert got == want
    assert res["counters"] == ref["counters"] == (
        first + 2 * K, first + 2 * K, (first + 2 * K) // accum,
        None if accum == 1 else (first + 2 * K) % accum)
    for part in ("params", "mu", "nu", "acc"):
        assert set(res[part]) == set(ref[part])
        for k, v in ref[part].items():
            assert torch.equal(res[part][k], v), (part, k)
    assert len({m["lr"] for m in want}) > 1  # the schedule moved


def test_cli_steps_per_call_repeats_single_steps(tmp_path):
    """`--steps_per_call 3 --accum_iter 2` for 2 epochs of 4 micro-steps
    (a group of 3 and a tail of 1 an epoch, a cycle across the group's
    end), the u8 pipe and the fused CE on, against `--steps_per_call 1`:
    `log.txt` equal line for line (losses, lr, micro_steps, updates,
    kernel_launches) and both checkpoints equal bit for bit."""
    root = _corpus(tmp_path, 16)
    extra = ("--epochs", "2", "--accum_iter", "2", "--u8_pipe",
             "--fused_mlm_ce")
    with tiny_cli():
        for k in (1, K):
            cli.main(cli_argv(root, tmp_path / f"k{k}", *extra,
                              "--steps_per_call", str(k)))
    one, many = (tmp_path / "k1", tmp_path / f"k{K}")
    assert (many / "log.txt").read_text() == (one / "log.txt").read_text()
    recs = read_log(many)
    assert [(r["micro_steps"], r["updates"]) for r in recs] == [(4, 2),
                                                               (8, 4)]
    for e in (0, 1):
        a, b = (torch.load(d / f"checkpoint-{e}.pth", weights_only=True)
                for d in (one, many))
        for k, v in a["model"].items():
            assert torch.equal(v, b["model"][k]), (e, k)
        for i, st in a["optimizer"]["state"].items():
            for f in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(st[f], b["optimizer"]["state"][i][f])
        assert a["accum_cycle"] == b["accum_cycle"]


def test_cli_preempt_at_call_boundary_resumes(tmp_path, monkeypatch):
    """ECAMP_PREEMPT_AT_STEP=3 with `--steps_per_call 3`: the guard is
    asked at the call's end, the run saves at micro-step 3 (epoch 0,
    batch 3) and a resume with the same K, its first epoch a tail of one
    batch, equals the uninterrupted run: the last epoch's log line and the
    final checkpoint bit for bit."""
    root = _corpus(tmp_path, 16)
    extra = ("--epochs", "2", "--steps_per_call", str(K))
    with tiny_cli():
        cli.main(cli_argv(root, tmp_path / "ref", *extra))
    monkeypatch.setenv("ECAMP_PREEMPT_AT_STEP", "2")
    with tiny_cli() as buf:
        cli.main(cli_argv(root, tmp_path / "pre", *extra))
    monkeypatch.delenv("ECAMP_PREEMPT_AT_STEP")
    path = tmp_path / "pre" / "checkpoint-step-3.pth"
    assert (f"preemption checkpoint saved @ step 3 (epoch 0); resume with "
            f"--resume {path} [injected @ 2]") in buf.getvalue()
    with tiny_cli() as buf:
        cli.main(cli_argv(root, tmp_path / "pre", *extra, "--resume",
                          str(path)))
    assert "resuming at epoch 0, batch 3" in buf.getvalue()
    ref, res = read_log(tmp_path / "ref"), read_log(tmp_path / "pre")
    assert [r["epoch"] for r in res] == [0, 1]
    assert res[-1] == ref[-1]
    a, b = (torch.load(d / "checkpoint-1.pth", weights_only=True)
            for d in (tmp_path / "ref", tmp_path / "pre"))
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    for i, st in a["optimizer"]["state"].items():
        assert int(st["step"]) == int(b["optimizer"]["state"][i]["step"])
        for f in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(st[f], b["optimizer"]["state"][i][f])


def test_graph_launches_take_back_the_capture_and_add_each_replay():
    """A capture counts no launch (the wrappers called under it record
    their kernels and run nothing); each replay adds what it recorded.
    Every counter of the port is in `_build.COUNTERS`."""
    from ecamp_tpu_torch.kernels import (_build, flash_attention,
                                         fused_adamw, layer_norm)

    assert {id(c) for c in (layer_norm.launches, flash_attention.launches,
                            fused_adamw.launches)} <= {
        id(c) for c in _build.COUNTERS}
    ln, fa = layer_norm.launches, flash_attention.launches
    before = (ln.value, fa.value)
    with _build.GraphLaunches() as recorded:
        ln.add()
        ln.add()
        fa.add()
    assert (ln.value, fa.value) == before
    for _ in range(3):
        recorded.replay()
    assert (ln.value, fa.value) == (before[0] + 6, before[1] + 3)
