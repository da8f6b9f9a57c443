"""FSDP (ZeRO-3) pretraining in the port (`MeshConfig.shard_params`,
`core/distributed.py::Fsdp`, AdamW on the shards, the pretrain CLI's
`--fsdp`) on the CPU, over gloo ranks spawned by `tests/torch_dp_ranks.py`
beside the JAX compiles, at the tiny sizes of
`tests/test_torch_pretrain.py`:

  * 2 ranks x 3 steps against the JAX `PretrainTask` with
    `MeshConfig(data=2, shard_params=True)` on a 2-device CPU mesh, from
    the same weights and injected noise, dropout off, and the port's FSDP
    `make_train_step_scan` of K = 3 against JAX's over 3 copies of the
    batch;
  * the port's FSDP scan against its own single steps bit for bit, with
    and without accumulation (on gloo ranks the K steps run in order; on
    NCCL ranks they are CUDA graphs, which `chip_smoke.py` (6e) and
    `tests/test_torch_kernels_cuda.py` hold against eager steps);
  * where the collectives go, with the step's group a second gloo group
    (as a graphed step sets `graph_group()`): every gather, reduce-scatter,
    the clip's norm and the metrics' all-reduce of an FSDP step, and of a
    ZeRO-1 step with its accumulated, clipped update, through the step's
    group; `whole_params` (init, save, load) through the default group;
  * FSDP against plain data parallelism bit for bit (parameters, moments,
    the open cycle), also with accumulation and with remat and dropout;
  * each rank's persistent shard elements, about half of plain's;
  * one process with `shard_params` against the plain step bit for bit;
  * `shard_params` with a model axis refused;
  * the clip's global norm over sharded gradients against the whole one;
  * the CLI on 2 ranks with `--fsdp --accum_iter 2`, preempted and
    resumed, against the uninterrupted run, and its checkpoint in one
    process;
  * the CLI in one process with `--fsdp` and `--fsdp --shard_optimizer`
    against the plain run, bit for bit.
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
from ecamp_tpu_torch.core import distributed  # noqa: E402
from ecamp_tpu_torch.train.pretrain import PretrainTask  # noqa: E402
from test_torch_distributed import (B, LOSS_RTOL, NOISE, STEPS,  # noqa: E402
                                    WORLD, _batch, _rel)
from test_torch_pretrain import _tiny  # noqa: E402
from test_torch_steps_per_call import _dropout_cfg  # noqa: E402

PREEMPT_AT = 5  # the CLI's micro-step: epoch 1, batch 1, mid-cycle


def _cfg(lib, shard: bool, **kw):
    """The tiny config on WORLD ranks, FSDP or plain, with `kw` replaced
    (the optimizer's accumulation, the three remats)."""
    cfg = _tiny(lib)
    if "accum" in kw:
        kw["optimizer"] = dataclasses.replace(cfg.optimizer,
                                              accum_steps=kw.pop("accum"))
    if kw.pop("remat", False):
        kw.update(vit=dataclasses.replace(cfg.vit, remat=True),
                  decoder=dataclasses.replace(cfg.decoder, remat=True),
                  bert=dataclasses.replace(cfg.bert, remat=True,
                                           hidden_dropout_prob=0.1,
                                           attention_probs_dropout_prob=0.1))
    return dataclasses.replace(cfg, mesh=lib.MeshConfig(
        data=WORLD if lib is jcfg else -1, shard_params=shard), **kw)


# name -> (config keywords, noise injected, dropout off)
VARIANTS = {"base": ({}, True, True), "accum": ({"accum": 2}, True, True),
            "remat": ({"remat": True}, False, False)}
K = STEPS  # micro-steps a call of the scans


def _bitwise_cases() -> dict:
    """name -> (the port's FSDP config, micro-steps an epoch): dropout on
    and an epoch cosine that moves every micro-step (`_dropout_cfg`)."""
    return {name: (dataclasses.replace(_dropout_cfg(accum),
                                       mesh=pcfg.MeshConfig(shard_params=True)),
                   3)
            for name, accum in (("fsdp", 1), ("fsdp_accum2", 2))}


def _route_cases() -> dict:
    """name -> the port's config of `torch_dp_ranks._step_groups`, a clip
    set: FSDP, and ZeRO-1 with accumulation 2 (its update clips the
    running mean's pieces, a norm over the ranks)."""
    base = _tiny(pcfg)
    return {
        "fsdp": dataclasses.replace(
            base, mesh=pcfg.MeshConfig(shard_params=True),
            optimizer=dataclasses.replace(base.optimizer, grad_clip=1.0)),
        "zero1_accum2": dataclasses.replace(
            base, mesh=pcfg.MeshConfig(shard_optimizer=True),
            optimizer=dataclasses.replace(base.optimizer, grad_clip=1.0,
                                          accum_steps=2))}


def _cli_runs(root, tmp):
    from test_torch_accum import cli_argv

    extra = ("--batch_size", "2", "--accum_iter", "2", "--epochs", "2",
             "--fsdp")
    path = tmp / "pre" / f"checkpoint-step-{PREEMPT_AT}.pth"
    return [{"argv": cli_argv(root, tmp / "ref", *extra), "sync_every": 1},
            {"argv": cli_argv(root, tmp / "pre", *extra),
             "env": {"ECAMP_PREEMPT_AT_STEP": str(PREEMPT_AT)},
             "sync_every": 1},
            {"argv": cli_argv(root, tmp / "pre", *extra, "--resume",
                              str(path)), "sync_every": 1}]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's FSDP and plain data-parallel runs of every variant, the
    clip's norms, the FSDP scans, the collectives' groups and the three
    CLI runs on 2 gloo ranks, started first; beside them the JAX task's
    STEPS FSDP steps and its FSDP scan of as many on a 2-device mesh, from
    the same initial weights."""
    from test_torch_accum import _corpus
    from test_torch_cli_pretrain import _tiny_kw

    tmp = tmp_path_factory.mktemp("fsdp")
    cfg = _cfg(jcfg, True)
    task = JaxPretrainTask(cfg, mesh=cpu_test_mesh(WORLD))
    fb = task.fake_batch(2)
    weights = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda r: task.model.init(
            {"params": r, "masking": jax.random.fold_in(r, 1)}, fb,
            mask_ratio=cfg.mask_ratio, deterministic=True))(
                jax.random.PRNGKey(0))["params"])
    sd = {k: v.numpy() for k, v in state_dict_from_flax(weights).items()}
    port = {f"{name}_{kind}": (_cfg(pcfg, kind == "fsdp", **kw), inject, det)
            for name, (kw, inject, det) in VARIANTS.items()
            for kind in ("fsdp", "dp")}
    batch = _batch()
    scans = {"parity": {"fsdp": _cfg(pcfg, True)},
             "superbatch": {k: np.stack([v] * K) for k, v in batch.items()},
             "noise": np.stack([NOISE] * K), "bitwise": _bitwise_cases(),
             "batches": [_batch(20 + i) for i in range(2 * K)], "k": K}
    started = ranks.start(
        "fsdp_parts", WORLD, tmp / "ranks", runs=port, weights=sd,
        batch=batch, noise=NOISE, steps=STEPS,
        clis=_cli_runs(_corpus(tmp, 16), tmp), tiny=_tiny_kw(pcfg),
        scans=scans, routes=_route_cases(), work=str(tmp / "routes"))
    try:
        def placed():  # each jit donates the state it is given
            return task.place_state(JaxTrainState.create(
                jax.tree_util.tree_map(jnp.asarray, weights), task.tx))

        uniform = jax.random.uniform

        def fake(key, shape=(), *args, **kwargs):
            if tuple(shape) == NOISE.shape:
                return jnp.asarray(NOISE)
            return uniform(key, shape, *args, **kwargs)

        losses = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "uniform", fake)  # while it is traced
            state = placed()
            for _ in range(STEPS):
                state, m = task.train_step(state, task.shard_batch(batch),
                                           jax.random.PRNGKey(7))
                losses.append({k: float(v) for k, v in m.items()})
            state = placed()
            scan = task.make_train_step_scan(state)
            state, m = scan(state, task.shard_superbatch([batch] * K),
                            jax.random.PRNGKey(7))
        assert int(state.step) == K
        scanned = [{k: float(v[i]) for k, v in m.items()} for i in range(K)]
    except BaseException:
        ranks.stop(started)
        raise
    return {"jax": losses, "jax_scan": scanned,
            "port": ranks.collect(started), "tmp": tmp, "weights": sd}


def test_two_fsdp_ranks_match_jax_fsdp_step(runs):
    """Each of 3 steps' losses within 1e-4 relative of the JAX package's
    FSDP step on a 2-device mesh, and the lr exact, on both ranks."""
    for r, got in enumerate(runs["port"]):
        for i, want in enumerate(runs["jax"]):
            for k in ("loss", "mim_loss", "res_loss", "mlm_loss"):
                assert _rel(got["base_fsdp"]["losses"][i][k], want[k]) \
                    < LOSS_RTOL, (r, i, k)
            assert got["base_fsdp"]["losses"][i]["lr"] == pytest.approx(
                want["lr"], rel=1e-7)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_fsdp_equals_plain_data_parallel_bitwise(runs, name):
    """FSDP changes where the parameters, gradients and moments live and
    which collectives move them, not a bit of the result: the losses, the
    whole parameters, the gathered moments and the open cycle equal plain
    data parallelism's after 3 steps on every rank, with accumulation
    (an update every 2 micro-steps: the third leaves a cycle open) and
    with remat and dropout (the recompute gathers again)."""
    for got in runs["port"]:
        fsdp, dp = got[f"{name}_fsdp"], got[f"{name}_dp"]
        assert fsdp["losses"] == dp["losses"]
        for k, p in dp["params"].items():
            assert torch.equal(fsdp["params"][k], p), k
        for i, st in dp["optimizer"]["state"].items():
            other = fsdp["optimizer"]["state"][i]
            assert int(st["step"]) == int(other["step"])
            for f in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(st[f], other[f]), (i, f)
        if name == "accum":
            assert dp["cycle"]["mini_step"] == fsdp["cycle"]["mini_step"] == 1
            for k, a in dp["cycle"]["acc_grads"].items():
                assert torch.equal(fsdp["cycle"]["acc_grads"][k], a), k
        else:
            assert dp["cycle"] is None and fsdp["cycle"] is None
    # the ranks hold the same whole parameters
    a, b = (r[f"{name}_fsdp"]["params"] for r in runs["port"])
    assert all(torch.equal(v, b[k]) for k, v in a.items())


def test_fsdp_ranks_keep_half_the_state(runs):
    """Each rank keeps its span of every unit: parameter shards, gradient
    shards and moments of the same elements, their sum over the ranks the
    parameters padded per unit, so about half of plain data parallelism's
    whole parameters a rank (which keeps them and the moments whole)."""
    total = sum(v.size for v in runs["weights"].values())
    shards = []
    for got in runs["port"]:
        fsdp, dp = got["base_fsdp"]["elements"], got["base_dp"]["elements"]
        assert dp["params"] == dp["moments"] == total
        assert dp["param_shards"] == dp["grad_shards"] == 0
        assert fsdp["param_shards"] == fsdp["grad_shards"]
        assert fsdp["params"] == fsdp["moments"] <= fsdp["param_shards"]
        shards.append(fsdp["param_shards"])
    assert shards[0] == shards[1]  # every unit cut into equal spans
    # padding: each leaf to ALIGN elements, each unit to WORLD * ALIGN
    units = len(PretrainTask(_tiny(pcfg), device="cpu").model.fsdp_units())
    pad = (len(runs["weights"]) + (units + 1) * WORLD) * distributed.ALIGN
    assert total <= WORLD * shards[0] <= total + pad
    assert sum(r["base_fsdp"]["elements"]["params"]
               for r in runs["port"]) == total


def test_one_process_fsdp_equals_plain_step_bitwise():
    """In one process FSDP has one span: the unit gathers are copies and
    the step, with the remats and dropout on and the noise drawn, equals
    the plain one bit for bit (losses, parameters, moments) over 3 steps;
    the model's own parameters are empty placeholders between calls."""
    torch.set_num_threads(2)
    out = {}
    for shard in (False, True):
        cfg = _cfg(pcfg, shard, remat=True)
        task = PretrainTask(cfg, device="cpu")
        state = task.init_state(torch.Generator().manual_seed(3))
        batch = task.put_batch({k: v[:B] for k, v in _batch().items()})
        losses = []
        for _ in range(STEPS):
            state, m = task.train_step(state, batch)
            losses.append(m)
        if shard:
            assert all(p.numel() == 0 for p in task.model.parameters())
        with distributed.whole_params(task.model, write_back=False) as m:
            params = {k: v.clone() for k, v in m.state_dict().items()}
        out[shard] = ([{k: float(v) for k, v in x.items()} for x in losses],
                      params, state.optimizer_state_dict(0.05))
    (l0, p0, o0), (l1, p1, o1) = out[False], out[True]
    assert l0 == l1
    assert all(torch.equal(v, p1[k]) for k, v in p0.items())
    for i, st in o0["state"].items():
        for f in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(st[f], o1["state"][i][f]), (i, f)


def test_fsdp_with_a_model_axis_is_refused():
    """FSDP and tensor parallelism do not combine, as in JAX; tensor
    parallelism alone is not ported."""
    with pytest.raises(ValueError, match="FSDP"):
        PretrainTask(dataclasses.replace(
            _tiny(pcfg), mesh=pcfg.MeshConfig(model=2, shard_params=True)),
            device="cpu")
    with pytest.raises(NotImplementedError, match="tensor parallelism"):
        PretrainTask(dataclasses.replace(
            _tiny(pcfg), mesh=pcfg.MeshConfig(model=2)), device="cpu")


def test_clip_norm_over_sharded_gradients(runs):
    """The clip's global norm over each rank's pieces (an all-reduce of
    their sums of squares) equals the whole gradients' within 1e-6
    relative on both ranks, and a clipped update of ZeRO-1's running mean
    in pieces equals the unsharded one's within it too."""
    for got in runs["port"]:
        c = got["clip"]
        assert _rel(c["sharded_norm"], c["whole_norm"]) < 1e-6
        assert c["whole_norm"] > 0.5  # the clip acts
        for k, t in c["updated"]["whole"].items():
            torch.testing.assert_close(c["updated"]["zero1"][k], t,
                                       rtol=1e-6, atol=1e-7, msg=k)


def test_cli_fsdp_two_ranks_preempted_and_resumed(runs):
    """`cli.pretrain --fsdp --accum_iter 2` on 2 gloo ranks, 2 images a
    rank, 2 epochs of 4 micro-steps; the same preempted at micro-step 5
    (mid-epoch, mid-cycle) and resumed, each rank taking its shards back:
    the final checkpoint equals the uninterrupted run's bit for bit. Its
    checkpoint-0.pth holds whole parameters and moments, which load into
    FSDP in one process and come back out unchanged."""
    from test_torch_cli_pretrain import _tiny_kw
    from test_torch_preemption import _assert_same_final

    from ecamp_tpu_torch.ckpt.checkpoint import (load_checkpoint,
                                                 load_model_state)

    tmp = runs["tmp"]
    printed = runs["port"][0]["printed"]
    path = tmp / "pre" / f"checkpoint-step-{PREEMPT_AT}.pth"
    assert f"preemption checkpoint saved @ step {PREEMPT_AT} (epoch 1)" \
        in printed[1]
    assert "resuming at epoch 1, batch 1" in printed[2]
    assert runs["port"][1]["printed"] == ["", "", ""]
    ck = torch.load(path, weights_only=True)
    assert ck["accum_cycle"]["mini_step"] == 1
    _assert_same_final(tmp / "ref", tmp / "pre")

    ck = load_checkpoint(str(tmp / "ref" / "checkpoint-0.pth"))
    cfg = pcfg.PretrainConfig(data=pcfg.DataConfig(img_size=64),
                              mesh=pcfg.MeshConfig(shard_params=True),
                              bf16=False, **_tiny_kw(pcfg))
    task = PretrainTask(cfg, device="cpu")
    loaded, missing = load_model_state(task.model, ck["model"])
    assert not missing and len(loaded) == len(ck["model"])
    state = task.init_state().load_optimizer_state_dict(ck["optimizer"])
    with distributed.whole_params(task.model, write_back=False) as m:
        for k, v in m.state_dict().items():
            assert torch.equal(v, ck["model"][k]), k
    got = state.optimizer_state_dict(0.05)["state"]
    for i, st in ck["optimizer"]["state"].items():
        assert int(got[i]["step"]) == int(st["step"]) == 2
        for f in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(got[i][f], st[f]), (i, f)


def test_cli_fsdp_in_one_process_equals_plain(tmp_path):
    """`--fsdp` in one process (one span) and `--fsdp --shard_optimizer`
    (the same: FSDP implies sharded moments) write the checkpoint of the
    run without either, bit for bit: whole parameters and moments."""
    from test_torch_accum import _corpus, cli_argv, tiny_cli

    from ecamp_tpu_torch.cli import pretrain as cli

    root = _corpus(tmp_path, 8)
    runs = {"plain": (), "fsdp": ("--fsdp",),
            "both": ("--fsdp", "--shard_optimizer")}
    with tiny_cli():
        for out, extra in runs.items():
            cli.main(cli_argv(root, tmp_path / out, "--epochs", "1", *extra))
    ref = torch.load(tmp_path / "plain" / "checkpoint-0.pth",
                     weights_only=True)
    for out in ("fsdp", "both"):
        ck = torch.load(tmp_path / out / "checkpoint-0.pth", weights_only=True)
        assert ck["model"].keys() == ref["model"].keys()
        for k, v in ref["model"].items():
            assert torch.equal(v, ck["model"][k]), (out, k)
        for i, st in ref["optimizer"]["state"].items():
            for f in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(st[f], ck["optimizer"]["state"][i][f]), \
                    (out, i, f)


def test_two_fsdp_ranks_scan_matches_jax_scan(runs):
    """The port's FSDP `make_train_step_scan` on 2 gloo ranks, one call of
    K = 3 micro-steps from the JAX weights over the superbatch of 3 copies
    of the batch with the injected noise, dropout off: each micro-step's
    losses within LOSS_RTOL (1e-4 relative) of JAX's FSDP scan on the
    2-device mesh, the lr exact, the step, host step and AdamW's count K,
    on both ranks."""
    for r, got in enumerate(runs["port"]):
        run = got["scans"]["parity"]["fsdp"]
        for i, want in enumerate(runs["jax_scan"]):
            for k in ("loss", "mim_loss", "res_loss", "mlm_loss"):
                assert _rel(run["metrics"][k][i], want[k]) < LOSS_RTOL, \
                    (r, i, k)
            assert run["metrics"]["lr"][i] == pytest.approx(want["lr"],
                                                            rel=1e-7)
        assert run["counters"] == (K, K, K, None)


@pytest.mark.parametrize("name", list(_bitwise_cases()))
def test_fsdp_scan_equals_single_steps_bitwise(runs, name):
    """Two FSDP K-step calls (dropout on, the global noise drawn from the
    masking generator) against 2 K single steps from the same seed, on
    each rank: every metric, the whole parameters, the rank's moment
    pieces and running mean, the step, count and cycle bit for bit;
    under accumulation 2 a cycle crosses the calls."""
    accum = 2 if name.endswith("accum2") else 1
    for got in runs["port"]:
        single, scanned = got["scans"]["bitwise"][name]
        assert scanned["metrics"] == single["metrics"]
        ref, res = single["state"], scanned["state"]
        assert res["counters"] == ref["counters"] == (
            2 * K, 2 * K, 2 * K // accum, None if accum == 1 else 0)
        for part in ("params", "mu", "nu", "acc"):
            assert set(res[part]) == set(ref[part])
            for k, v in ref[part].items():
                assert torch.equal(res[part][k], v), (part, k)
        assert len({m["lr"] for m in single["metrics"]}) > 1


@pytest.mark.parametrize("name", list(_route_cases()))
def test_step_collectives_go_through_the_step_group(runs, name):
    """With the step's group (`task.dp.group`) a second gloo group, as a
    graphed step sets `graph_group()`, every collective of 2 steps goes
    through it, on both ranks: under FSDP each unit's gather (gloo: a
    broadcast a rank) and reduce-scatter (gloo: an all-reduce of the
    unit's flat gradient) every step; the clip's norm over the ranks (an
    all-reduce of one element) at every update, FSDP's and ZeRO-1's
    accumulated one; the metrics' all-reduce every step."""
    for got in runs["port"]:
        calls, units = (got["routes"][name][k] for k in ("calls", "units"))
        steps = calls["steps"]
        assert {tag for _, tag, _ in steps} == {"step"}, steps
        norms = [c for c in steps if c[0] == "all_reduce" and c[2] == 1]
        metrics = [c for c in steps if c[0] == "all_reduce" and c[2] == 4]
        assert len(norms) == (2 if name == "fsdp" else 1)
        assert len(metrics) == 2
        if name == "fsdp":
            assert units > 1
            assert sum(c[0] == "broadcast" for c in steps) == 2 * units * WORLD
            assert sum(c[0] == "all_reduce" and c[2] > 4
                       for c in steps) == 2 * units


def test_whole_params_go_through_the_default_group(runs):
    """The eager collectives between steps take the whole group, not the
    step's: under FSDP `whole_params` at `init_state(generator)`, at the
    checkpoint's save and at its load; the checkpoint's gathered moments
    under FSDP and ZeRO-1."""
    for got in runs["port"]:
        for name in _route_cases():
            calls = got["routes"][name]["calls"]
            phases = ("init", "save", "load") if name == "fsdp" else ("save",)
            for phase in phases:
                assert calls[phase], (name, phase)
            for phase, made in calls.items():
                if phase != "steps":
                    assert {tag for _, tag, _ in made} == {"default"}, \
                        (name, phase, made)
