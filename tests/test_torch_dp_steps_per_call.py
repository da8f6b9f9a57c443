"""K data-parallel pretraining micro-steps a call on the port
(`PretrainTask.make_train_step_scan` under a process group; `torchrun ...
-m ecamp_tpu_torch.cli.pretrain --steps_per_call K`), on the CPU, over 2
gloo ranks spawned by `tests/torch_dp_ranks.py`, at the tiny sizes of
`tests/test_torch_pretrain.py`:

  * the 2-rank K-step call against JAX's `make_train_step_scan` on a
    2-device CPU mesh, plain and with `MeshConfig(shard_optimizer=True)`,
    from the same weights, superbatch (placed by `shard_superbatch`) and
    injected noise, dropout off;
  * the K-step call against K single steps on the same ranks, bit for bit,
    with dropout on and the noise drawn: plain, ZeRO-1, and accumulation 2
    with a cycle that crosses a call;
  * the preemption guard after calls of K micro-steps: with one micro-step
    a call its rule is the old one, and a request on one rank stops both
    at the first call that reaches or crosses a multiple of `sync_every`;
  * the CLI on 2 ranks with `--steps_per_call 3 --shard_optimizer
    --accum_iter 2` against `--steps_per_call 1`, and preempted mid-epoch
    and resumed.

On NCCL ranks the K steps are CUDA graphs of the data-parallel step
(`tests/test_torch_kernels_cuda.py` and `chip_smoke.py` (6e) hold them
against eager steps); on gloo ranks on the CPU they run in order. The
ranks start before JAX compiles its scans and run beside them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dp_ranks as ranks  # noqa: E402
from ecamp_tpu.core import config as jcfg  # noqa: E402
from ecamp_tpu.core.mesh import cpu_test_mesh  # noqa: E402
from ecamp_tpu.train.pretrain import PretrainTask as JaxPretrainTask  # noqa: E402
from ecamp_tpu.train.state import TrainState as JaxTrainState  # noqa: E402
from ecamp_tpu_torch.ckpt import state_dict_from_flax  # noqa: E402
from ecamp_tpu_torch.core import config as pcfg  # noqa: E402
from ecamp_tpu_torch.core import distributed, preemption  # noqa: E402
from test_torch_accum import _corpus, cli_argv, read_log  # noqa: E402
from test_torch_cli_pretrain import _tiny_kw  # noqa: E402
from test_torch_distributed import (LOSS_RTOL, NOISE, WORLD,  # noqa: E402
                                    _batch, _rel)
from test_torch_preemption import _assert_same_final  # noqa: E402
from test_torch_steps_per_call import _dropout_cfg, _scan_cfg  # noqa: E402

K = 3
SHARDS = {"plain": False, "zero1": True}
# the guard's case: a request at step 2 on rank 1, calls of K = 3, the
# ranks agreeing at the call that reaches or crosses a multiple of 4
GUARD = dict(at_rank=1, at=2, sync_every=4, steps=4 * K, taken=K)
CLI_EXTRA = ("--batch_size", "2", "--accum_iter", "2", "--epochs", "2",
             "--shard_optimizer")  # 4 micro-steps an epoch: a call, a tail


def _mesh_cfg(cfg, lib, shard: bool):
    return dataclasses.replace(cfg, mesh=lib.MeshConfig(
        data=WORLD if lib is jcfg else -1, shard_optimizer=shard))


def _bitwise_cases() -> dict:
    """name -> (the port's config, micro-steps an epoch): dropout on and an
    epoch cosine that moves every micro-step (`_dropout_cfg`)."""
    return {"plain": (_mesh_cfg(_dropout_cfg(1), pcfg, False), 3),
            "zero1": (_mesh_cfg(_dropout_cfg(1), pcfg, True), 3),
            "zero1_accum2": (_mesh_cfg(_dropout_cfg(2), pcfg, True), 3)}


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The JAX initial weights, then both spawns started at once: the
    task-level parts (`scan_parts`) and the CLI runs (`cli_mains`)."""
    tmp = tmp_path_factory.mktemp("dpscan")
    cfg = _mesh_cfg(_scan_cfg(jcfg), jcfg, False)
    task = JaxPretrainTask(cfg, mesh=cpu_test_mesh(WORLD))
    params = jax.jit(lambda r: task.model.init(
        {"params": r, "masking": jax.random.fold_in(r, 1)},
        task.fake_batch(2), mask_ratio=cfg.mask_ratio,
        deterministic=True))(jax.random.PRNGKey(0))["params"]
    weights = jax.tree_util.tree_map(np.asarray, params)
    batches = [_batch(5 + i) for i in range(K)]
    superbatch = {k: np.stack([b[k] for b in batches]) for k in batches[0]}
    noise = np.stack([NOISE] * K)
    parts = ranks.start(
        "scan_parts", WORLD, tmp / "parts",
        parity={n: _mesh_cfg(_scan_cfg(pcfg), pcfg, s)
                for n, s in SHARDS.items()},
        weights={k: v.numpy()
                 for k, v in state_dict_from_flax(weights).items()},
        superbatch=superbatch, noise=noise, bitwise=_bitwise_cases(),
        batches=[_batch(20 + i) for i in range(2 * K)], k=K, guard=GUARD)
    root = _corpus(tmp, 16)
    dirs = {n: tmp / n for n in ("k1", "k3", "pre")}
    path = dirs["pre"] / "checkpoint-step-3.pth"
    k3 = ("--steps_per_call", str(K))
    runs = [{"argv": cli_argv(root, dirs["k1"], *CLI_EXTRA,
                              "--steps_per_call", "1")},
            {"argv": cli_argv(root, dirs["k3"], *CLI_EXTRA, *k3)},
            # both ranks asked at step 2: they agree at the call that
            # crosses 2, which ends at micro-step 3 (mid-epoch, mid-cycle)
            {"argv": cli_argv(root, dirs["pre"], *CLI_EXTRA, *k3),
             "env": {"ECAMP_PREEMPT_AT_STEP": "2"}, "sync_every": 2},
            {"argv": cli_argv(root, dirs["pre"], *CLI_EXTRA, *k3,
                              "--resume", str(path)), "sync_every": 2}]
    clis = ranks.start("cli_mains", WORLD, tmp / "clis", runs=runs,
                       tiny=_tiny_kw(pcfg))
    yield {"weights": weights, "superbatch": superbatch, "parts": parts,
           "clis": clis, "dirs": dirs, "path": path}
    ranks.stop(parts)  # ranks a failure left uncollected
    ranks.stop(clis)


@pytest.fixture(scope="module")
def jax_scans(started):
    """JAX's K-step scan on the 2-device mesh, plain and ZeRO-1, with NOISE
    as every step's global masking draw: the (K,) metrics of each."""
    out = {}
    uniform = jax.random.uniform

    def fake(key, shape=(), *args, **kwargs):
        if tuple(shape) == NOISE.shape:
            return jnp.asarray(NOISE)
        return uniform(key, shape, *args, **kwargs)

    for name, shard in SHARDS.items():
        cfg = _mesh_cfg(_scan_cfg(jcfg), jcfg, shard)
        task = JaxPretrainTask(cfg, mesh=cpu_test_mesh(WORLD))
        state = task.place_state(JaxTrainState.create(
            jax.tree_util.tree_map(jnp.asarray, started["weights"]),
            task.tx))
        sb = started["superbatch"]
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "uniform", fake)  # while it is traced
            scan = task.make_train_step_scan(state)
            state, metrics = scan(state, task.shard_superbatch(
                [{k: v[i] for k, v in sb.items()} for i in range(K)]),
                jax.random.PRNGKey(7))
        assert int(state.step) == K
        out[name] = {k: np.asarray(v) for k, v in metrics.items()}
    return out


@pytest.fixture(scope="module")
def parts(started, jax_scans):
    """Each rank's `scan_parts` result (collected after JAX's scans)."""
    return ranks.collect(started["parts"])


@pytest.mark.parametrize("name", list(SHARDS))
def test_two_rank_scan_matches_jax_scan(parts, jax_scans, name):
    """The 2-rank K-step call's (K,) losses within LOSS_RTOL of JAX's scan
    on the 2-device mesh, on both ranks (the ranks' mean), the lr exact,
    the step and AdamW's count K."""
    want = jax_scans[name]
    for r, got in enumerate(parts):
        run = got["parity"][name]
        for k in ("loss", "mim_loss", "res_loss", "mlm_loss"):
            assert len(run["metrics"][k]) == K
            for i in range(K):
                assert _rel(run["metrics"][k][i], want[k][i]) < LOSS_RTOL, \
                    (r, i, k)
        np.testing.assert_allclose(run["metrics"]["lr"], want["lr"],
                                   rtol=1e-7)
        assert run["counters"] == (K, K, K, None)


@pytest.mark.parametrize("name", list(_bitwise_cases()))
def test_two_rank_scan_equals_single_steps_bitwise(parts, name):
    """Two K-step calls (dropout on, the global noise drawn from the
    masking generator) against 2 K single steps from the same seed, on
    each rank: every metric, the parameters, the rank's moments and
    running mean, the step, count and cycle bit for bit; the ranks hold
    equal parameters; under accumulation 2 a cycle crosses the calls."""
    accum = 2 if name.endswith("accum2") else 1
    params = []
    for got in parts:
        single, scanned = got["bitwise"][name]
        assert scanned["metrics"] == single["metrics"]
        ref, res = single["state"], scanned["state"]
        assert res["counters"] == ref["counters"] == (
            2 * K, 2 * K, 2 * K // accum, None if accum == 1 else 0)
        for part in ("params", "mu", "nu", "acc"):
            assert set(res[part]) == set(ref[part])
            for k, v in ref[part].items():
                assert torch.equal(res[part][k], v), (part, k)
        params.append(res["params"])
        assert len({m["lr"] for m in single["metrics"]}) > 1
    for k, v in params[0].items():
        assert torch.equal(v, params[1][k]), k


def test_gloo_ranks_cannot_capture_their_collectives(parts):
    """A gloo group's collectives run on the host: `graph_capturable` is
    False on its ranks and `graph_group` (which `GraphedSteps` calls under
    a group) raises, naming gloo. Outside a group there is nothing to
    capture."""
    for got in parts:
        assert got["capturable"] is False
        assert "the gloo process group runs on the host" in \
            got["graph_group_refused"]
    assert distributed.graph_capturable()
    assert distributed.graph_group() is None


def test_guard_with_one_step_a_call_keeps_the_old_rule(monkeypatch):
    """`should_save(step)` (one micro-step a call) under a group asks the
    ranks exactly where `step % sync_every == 0`, at every step."""
    monkeypatch.setattr(distributed, "world_size", lambda: WORLD)
    asked = []
    monkeypatch.setattr(distributed, "any_rank",
                        lambda flag: asked.append(1) or flag)
    for sync_every in (1, 2, 3, 50):
        guard = preemption.PreemptionGuard(sync_every=sync_every)
        try:
            guard._flag = True  # a request on this rank
            for step in range(0, 3 * sync_every + 2):
                del asked[:]
                got = guard.should_save(step)
                assert got == (step % sync_every == 0) == bool(asked), \
                    (sync_every, step)
                assert guard.should_save(step, 1) == got
        finally:
            guard.uninstall()


def test_guard_agrees_at_the_call_crossing_a_boundary(parts):
    """Calls of K = 3 micro-steps, `sync_every` 4, a request on rank 1
    alone at step 2: both ranks stop at micro-step 6, the end of the call
    that crosses 4 (`step % 4` would not fire until 12)."""
    assert [tuple(p["guard"]) for p in parts] == [
        (6, "another rank's request"), (6, "injected @ 2")]


@pytest.fixture(scope="module")
def clis(started):
    """What rank 0 and rank 1 printed, a run of `cli_mains`."""
    return ranks.collect(started["clis"])


def test_cli_two_ranks_steps_per_call_repeats_single_steps(started, clis):
    """`--steps_per_call 3 --shard_optimizer --accum_iter 2` on 2 ranks for
    2 epochs of 4 micro-steps (a call and a tail an epoch, a cycle across
    the call's end) against `--steps_per_call 1`: `log.txt` equal line for
    line and both checkpoints (gathered moments, the open cycle) bit for
    bit. Rank 0 alone prints."""
    one, many = started["dirs"]["k1"], started["dirs"]["k3"]
    assert (many / "log.txt").read_text() == (one / "log.txt").read_text()
    assert [(r["micro_steps"], r["updates"]) for r in read_log(many)] == [
        (4, 2), (8, 4)]
    for e in (0, 1):
        a, b = (torch.load(d / f"checkpoint-{e}.pth", weights_only=True)
                for d in (one, many))
        for k, v in a["model"].items():
            assert torch.equal(v, b["model"][k]), (e, k)
        for i, st in a["optimizer"]["state"].items():
            for f in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(st[f], b["optimizer"]["state"][i][f])
        assert a["accum_cycle"] == b["accum_cycle"]
    assert [printed for printed in clis[1]] == [""] * 4


def test_cli_two_ranks_preempted_mid_call_resumes(started, clis):
    """The K = 3 run with both ranks asked at micro-step 2 and agreeing
    every 2: they stop at the end of the call that crosses 2, micro-step 3
    (epoch 0, batch 3, mid-cycle), save, and the resume (its first epoch a
    tail of one batch) ends equal to the uninterrupted run: the last log
    line and the final checkpoint bit for bit."""
    path = started["path"]
    pre, resumed = clis[0][2], clis[0][3]
    assert (f"preemption checkpoint saved @ step 3 (epoch 0); resume with "
            f"--resume {path} [injected @ 2]") in pre
    ck = torch.load(path, weights_only=True)
    assert ck["step"] == 3 and ck["accum_cycle"]["mini_step"] == 1
    assert "resuming at epoch 0, batch 3" in resumed
    ref, res = (read_log(started["dirs"][n]) for n in ("k3", "pre"))
    assert [r["epoch"] for r in res] == [0, 1]
    assert res[-1] == ref[-1]
    _assert_same_final(started["dirs"]["k3"], started["dirs"]["pre"])
