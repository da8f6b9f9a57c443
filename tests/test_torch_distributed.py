"""Data-parallel pretraining in the port (`core/distributed.py`, the
rank-aware `PretrainTask`, ZeRO-1 in `kernels/fused_adamw.py`, the
loader's process shards, the ranks' preemption agreement and the CLI under
a launcher) on the CPU, over gloo ranks spawned by
`tests/torch_dp_ranks.py`, at the tiny sizes of
`tests/test_torch_pretrain.py`:

  * 2 ranks x 3 steps against the JAX `PretrainTask` on a 2-device CPU
    mesh, plain and with `MeshConfig(shard_optimizer=True)`, from the same
    weights and injected noise, dropout off;
  * the 2 ranks against one process at the global batch;
  * ZeRO-1 against plain data parallelism, bit for bit;
  * the loader's shards against the JAX loader's;
  * the CLI on 2 ranks with ZeRO-1 and accumulation, preempted and
    resumed, against the uninterrupted run, and its checkpoint in one
    process.
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
from test_torch_pretrain import GRID, IMG, L, _tiny  # noqa: E402

WORLD, B = 2, 2      # ranks, rows a rank
G = WORLD * B        # the global batch
STEPS = 3
LOSS_RTOL = 1e-4     # test_pretrain_task_three_steps_match_jax's bound

NOISE = np.random.default_rng(11).uniform(size=(G, GRID)).astype(np.float32)


def _batch(seed=5):
    rng = np.random.default_rng(seed)
    mask = np.ones((G, L), np.int32)
    mask[1, 5:] = 0
    mask[3, 6:] = 0
    return {
        "image": rng.normal(size=(G, IMG, IMG, 3)).astype(np.float32),
        "ids": rng.integers(0, 64, (G, L)).astype(np.int32),
        "labels": rng.integers(0, 64, (G, L)).astype(np.int32),
        "attention_mask": mask,
        "type_ids": rng.integers(0, 2, (G, L)).astype(np.int32),
        "weights": rng.uniform(0.5, 2.0, (G, L)).astype(np.float32),
        "column": np.array([0, 1, 1, 0], np.int32),
        "row": np.array([1, 0, 1, 0], np.int32)}


def _cfg(lib, shard: bool):
    return dataclasses.replace(
        _tiny(lib), mesh=lib.MeshConfig(data=WORLD if lib is jcfg else -1,
                                        shard_optimizer=shard))


def _not_key_bias(name: str, p: torch.Tensor) -> torch.Tensor:
    """False on the attention key biases' elements: BERT's `key.bias`, the
    middle third of a fused `qkv.bias`."""
    keep = torch.ones_like(p, dtype=torch.bool)
    if name.endswith("key.bias"):
        keep[:] = False
    elif name.endswith("qkv.bias"):
        d = p.numel() // 3
        keep[d:2 * d] = False
    return keep


def _rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX task on a 2-device mesh (plain and ZeRO-1) and the port on
    2 gloo ranks (plain and ZeRO-1) and in one process at the global
    batch, all from one set of initial weights."""
    tmp = tmp_path_factory.mktemp("dp")
    out = {"jax": {}, "port": {}}
    weights = None
    for shard in (False, True):
        cfg = _cfg(jcfg, shard)
        task = JaxPretrainTask(cfg, mesh=cpu_test_mesh(WORLD))
        if weights is None:
            fb = task.fake_batch(2)
            params = jax.jit(lambda r: task.model.init(
                {"params": r, "masking": jax.random.fold_in(r, 1)}, fb,
                mask_ratio=cfg.mask_ratio, deterministic=True))(
                    jax.random.PRNGKey(0))["params"]
            weights = jax.tree_util.tree_map(np.asarray, params)
        state = task.place_state(JaxTrainState.create(
            jax.tree_util.tree_map(jnp.asarray, weights), task.tx))
        batch = task.shard_batch(_batch())
        uniform = jax.random.uniform

        def fake(key, shape=(), *args, **kwargs):
            if tuple(shape) == NOISE.shape:
                return jnp.asarray(NOISE)
            return uniform(key, shape, *args, **kwargs)

        losses = []
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.random, "uniform", fake)
            for _ in range(STEPS):
                state, m = task.train_step(state, batch,
                                           jax.random.PRNGKey(7))
                losses.append({k: float(v) for k, v in m.items()})
        out["jax"][shard] = {"losses": losses}

    sd = {k: v.numpy() for k, v in state_dict_from_flax(weights).items()}
    for shard in (False, True):
        out["port"][shard] = ranks.spawn(
            "task_steps", WORLD, tmp, cfg=_cfg(pcfg, shard), weights=sd,
            batch=_batch(), noise=NOISE, steps=STEPS)
    torch.set_num_threads(2)
    task = PretrainTask(_tiny(pcfg), device="cpu")
    task.model.load_state_dict({k: torch.from_numpy(v)
                                for k, v in sd.items()}, strict=True)
    state, batch = task.init_state(), task.put_batch(_batch())
    losses, grads = [], None
    for _ in range(STEPS):
        state, m = task.train_step(state, batch, noise=torch.from_numpy(NOISE),
                                   deterministic=True)
        losses.append({k: float(v) for k, v in m.items()})
        grads = grads or {k: p.grad.clone() for k, p in state.params.items()}
    out["one"] = {"losses": losses, "grads": grads,
                  "params": {k: p.detach().clone()
                             for k, p in state.params.items()}}
    return out


@pytest.mark.parametrize("shard", [False, True], ids=["plain", "zero1"])
def test_two_ranks_match_jax_data_parallel_step(runs, shard):
    """Each of 3 steps' losses within 1e-4 relative of the JAX package's
    2-device data-parallel step and the lr exact, on both ranks (the
    logged metrics are the ranks' mean)."""
    want = runs["jax"][shard]
    for r, got in enumerate(runs["port"][shard]):
        for i in range(STEPS):
            for k in ("loss", "mim_loss", "res_loss", "mlm_loss"):
                assert _rel(got["losses"][i][k], want["losses"][i][k]) \
                    < LOSS_RTOL, (r, i, k)
            assert got["losses"][i]["lr"] == pytest.approx(
                want["losses"][i]["lr"], rel=1e-7)


def test_two_ranks_match_one_process_at_the_global_batch(runs):
    """2 ranks x 2 rows compute what 1 process does at 4 rows: the losses
    within 1e-4 relative, the averaged gradients within 1e-5, and the
    parameters after 3 steps within 1e-5 but for the attention key biases
    (softmax is invariant to them, so their gradient is rounding noise,
    which AdamW turns into lr-sized steps of either sign); the ranks hold
    equal parameters."""
    one = runs["one"]
    plain = runs["port"][False]
    assert plain[0]["checksum"] == plain[1]["checksum"]
    for got in plain:
        for i in range(STEPS):
            for k in ("loss", "mim_loss", "res_loss", "mlm_loss"):
                assert _rel(got["losses"][i][k], one["losses"][i][k]) \
                    < LOSS_RTOL, (i, k)
        for k, g in one["grads"].items():
            torch.testing.assert_close(got["grads"][k], g, rtol=1e-4,
                                       atol=1e-5, msg=k)
        for k, p in one["params"].items():
            real = _not_key_bias(k, p)
            torch.testing.assert_close(got["params"][k][real], p[real],
                                       rtol=1e-4, atol=1e-5, msg=k)


def test_zero1_equals_plain_data_parallel_bitwise(runs):
    """ZeRO-1 changes where the moments live, not a bit of the result: the
    losses, the parameters and the gathered moments equal plain data
    parallelism's on every rank, while each rank keeps half the moment
    elements."""
    for plain, zero1 in zip(runs["port"][False], runs["port"][True]):
        assert plain["losses"] == zero1["losses"]
        for k, p in plain["params"].items():
            assert torch.equal(p, zero1["params"][k]), k
        for i, st in plain["optimizer"]["state"].items():
            other = zero1["optimizer"]["state"][i]
            for f in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(st[f], other[f]), (i, f)
        assert zero1["checksum"] == plain["checksum"]
    total = sum(p.numel() for p in runs["one"]["params"].values())
    assert runs["port"][False][0]["moment_elems"] == total
    halves = [r["moment_elems"] for r in runs["port"][True]]
    assert sum(halves) == total and max(halves) - min(halves) < total // 4


def test_flat_layout_pieces_cover_every_element_once():
    """The ZeRO-1 spans: every element of every leaf in exactly one rank's
    piece, leaves 512-byte aligned, spans equal."""
    shapes = {"a": (3, 5), "b": (7,), "c": (2, 2, 130), "d": (1,)}
    for world in (1, 2, 3, 4):
        lay = distributed.FlatLayout(shapes, world)
        assert lay.total == lay.span * world
        assert lay.span % distributed.ALIGN == 0
        for k, s in shapes.items():
            assert lay.offsets[k] % distributed.ALIGN == 0
            n = int(np.prod(s))
            seen = np.zeros(n, int)
            for r in range(world):
                lo, hi = lay.piece(k, r)
                seen[lo:hi] += 1
            assert (seen == 1).all(), (world, k)


def test_zero1_pieces_in_turn_equal_the_whole_update():
    """The plain AdamW on each of 3 ranks' pieces in turn (one process; the
    pieces are disjoint, so this stands in for the exchange) leaves the
    parameters of the whole update bit for bit, its moment pieces are
    those elements of the whole moments, and a running mean of pieces
    under `MultiSteps` updates as the whole one does."""
    from ecamp_tpu_torch.kernels.fused_adamw import AdamWState, FusedAdamW
    from ecamp_tpu_torch.train.optim import MultiSteps

    g = torch.Generator().manual_seed(5)
    shapes = {"w": (64, 48), "b": (3,), "pos": (1, 1, 40), "odd": (7, 13)}

    def draw(scale=1.0):
        return {k: scale * torch.randn(s, generator=g)
                for k, s in shapes.items()}

    params, mu0, nu0 = draw(), draw(0.1), {k: v.abs() for k, v in
                                           draw(0.01).items()}
    grads = [draw(), draw()]
    count = torch.full((), 2, dtype=torch.int32)

    def make(zero1=None, clip=1.0):
        return FusedAdamW(lambda c: 1e-3 * (1 + c.float()), 0.9, 0.95, 1e-8,
                          0.05, mask_fn=lambda p: {k: v.ndim > 1
                                                   for k, v in p.items()},
                          grad_clip=clip, zero1=zero1)

    def state(z=None):  # the count advances in place: one a state
        if z is None:
            return AdamWState(count.clone(),
                              {k: t.clone() for k, t in mu0.items()},
                              {k: t.clone() for k, t in nu0.items()})
        return AdamWState(count.clone(), z.take(mu0, "cpu"),
                          z.take(nu0, "cpu"))

    whole = {k: p.clone() for k, p in params.items()}
    w_state = state()
    make().apply(whole, grads[0], w_state)
    acc_whole = {k: p.clone() for k, p in params.items()}
    tx = MultiSteps(make(clip=None), 2)
    st = tx.init(acc_whole)
    for gr in grads:
        st = tx.apply(acc_whole, gr, st)
    layout = distributed.FlatLayout({k: p.shape for k, p in params.items()},
                                    3)
    sharded = {k: p.clone() for k, p in params.items()}
    acc_sharded = {k: p.clone() for k, p in params.items()}
    for r in range(3):
        z = distributed.Zero1(layout, r)
        st_r = state(z)
        make(z).apply(sharded, grads[0], st_r)
        for k in params:
            assert torch.equal(st_r.mu[k], z.local(w_state.mu[k], k))
            assert torch.equal(st_r.nu[k], z.local(w_state.nu[k], k))
        tx = MultiSteps(make(z, clip=None), 2)
        st = tx.init(acc_sharded)
        for gr in grads:
            st = tx.apply(acc_sharded, gr, st)
    for k in params:
        assert torch.equal(sharded[k], whole[k]), k
        assert torch.equal(acc_sharded[k], acc_whole[k]), k
    # the clip's norm sums the ranks' pieces: 3 ranks' pieces in one
    # process have no group to sum over
    with pytest.raises(ValueError, match="share of 3 ranks needs a process"):
        z = distributed.Zero1(layout, 0)
        MultiSteps(make(z), 1).apply(sharded, grads[0],
                                     MultiSteps(make(z), 1).init(sharded))


@pytest.mark.parametrize("n,count,batch,drop_last,shuffle",
                         [(10, 3, 2, True, True), (10, 3, 2, False, True),
                          (7, 2, 3, False, False), (5, 4, 1, True, True)])
def test_loader_shards_match_jax(n, count, batch, drop_last, shuffle):
    """Each rank's batches of sample indices, for n not divisible by the
    ranks (wrap-around padding), equal the JAX loader's, and so does its
    length."""
    from ecamp_tpu.data.loader import DataLoader as JaxLoader
    from ecamp_tpu_torch.data.loader import DataLoader

    class Indices:
        def __len__(self):
            return n

        def __getitem__(self, i):
            return {"index": np.array(i)}

    for rank in range(count):
        kw = dict(batch_size=batch, shuffle=shuffle, seed=3, num_workers=2,
                  drop_last=drop_last, process_index=rank,
                  process_count=count)
        pl, jl = DataLoader(Indices(), **kw), JaxLoader(Indices(), **kw)
        for epoch in (0, 1):
            pl.set_epoch(epoch)
            jl.set_epoch(epoch)
            got = [b["index"].tolist() for b in pl]
            want = [b["index"].tolist() for b in jl]
            assert got == want and len(pl) == len(jl) == len(got), \
                (rank, epoch)


def test_guard_agrees_across_ranks(tmp_path):
    """A preemption requested on rank 1 alone stops both ranks at the
    first `sync_every` boundary at or after it, with a reason on each."""
    got = ranks.spawn("guard_steps", WORLD, tmp_path, at_rank=1, at=3,
                      sync_every=2, steps=8)
    assert got == [(4, "another rank's request"), (4, "injected @ 3")]


def test_launcher_variables():
    """(rank, world, local rank, ranks on the host) from torchrun's
    variables at any size, OpenMPI's and SLURM's only where they count
    more than one task; nothing without a launcher."""
    f = distributed._launcher_ranks
    assert f({}) is None
    assert f({"RANK": "0", "WORLD_SIZE": "1"}) == (0, 1, 0, 1)
    assert f({"RANK": "3", "WORLD_SIZE": "4", "LOCAL_RANK": "1",
              "LOCAL_WORLD_SIZE": "2"}) == (3, 4, 1, 2)
    assert f({"OMPI_COMM_WORLD_SIZE": "1"}) is None
    assert f({"OMPI_COMM_WORLD_SIZE": "2", "OMPI_COMM_WORLD_RANK": "1",
              "OMPI_COMM_WORLD_LOCAL_RANK": "1",
              "OMPI_COMM_WORLD_LOCAL_SIZE": "2"}) == (1, 2, 1, 2)
    assert f({"SLURM_NTASKS": "1", "SLURM_PROCID": "0"}) is None
    assert f({"SLURM_NTASKS": "8", "SLURM_PROCID": "5", "SLURM_LOCALID": "1",
              "SLURM_NTASKS_PER_NODE": "4"}) == (5, 8, 1, 4)
    assert f({"SLURM_NTASKS": "8", "SLURM_PROCID": "5",
              "SLURM_NTASKS_PER_NODE": "4(x2)"}) == (5, 8, 0, 1)
    assert not distributed.initialize_distributed("cpu")  # no launcher here
    assert (distributed.rank(), distributed.world_size()) == (0, 1)


def test_cli_two_ranks_preempted_and_resumed(tmp_path):
    """`cli.pretrain` on 2 gloo ranks, 2 images a rank, `--shard_optimizer
    --accum_iter 2`, 2 epochs of 4 micro-steps; the same preempted at
    micro-step 5 (epoch 1, batch 1, mid-cycle; the ranks agree every
    micro-step, `SYNC_EVERY` lowered in each rank) and resumed: the final checkpoint equals the uninterrupted
    run's bit for bit (parameters, gathered moments, AdamW's count, the
    open cycle). Rank 0 alone writes `log.txt` and prints. The preemption
    file then resumes in one process at the global batch, which runs to the
    end."""
    from test_torch_accum import _corpus, cli_argv, read_log, tiny_cli
    from test_torch_cli_pretrain import _tiny_kw
    from test_torch_preemption import _assert_same_final

    from ecamp_tpu_torch.cli import pretrain as cli

    root = _corpus(tmp_path, 16)
    extra = ("--batch_size", "2", "--accum_iter", "2", "--epochs", "2",
             "--shard_optimizer")
    tiny = _tiny_kw(pcfg)
    ranks.spawn("cli_main", WORLD, tmp_path / "r",
                argv=cli_argv(root, tmp_path / "ref", *extra), tiny=tiny,
                env={}, sync_every=1)
    printed = ranks.spawn("cli_main", WORLD, tmp_path / "p",
                          argv=cli_argv(root, tmp_path / "pre", *extra),
                          tiny=tiny, env={"ECAMP_PREEMPT_AT_STEP": "5"},
                          sync_every=1)
    path = tmp_path / "pre" / "checkpoint-step-5.pth"
    assert (f"preemption checkpoint saved @ step 5 (epoch 1); resume with "
            f"--resume {path} [" in printed[0])
    assert printed[1] == ""
    ck = torch.load(path, weights_only=True)
    assert ck["step"] == 5 and ck["accum_cycle"]["mini_step"] == 1
    printed = ranks.spawn("cli_main", WORLD, tmp_path / "q",
                          argv=cli_argv(root, tmp_path / "pre", *extra,
                                        "--resume", str(path)),
                          tiny=tiny, env={}, sync_every=1)
    assert "resuming at epoch 1, batch 1" in printed[0]
    _assert_same_final(tmp_path / "ref", tmp_path / "pre")
    log = read_log(tmp_path / "ref")
    assert [r["epoch"] for r in log] == [0, 1]
    assert log[-1]["micro_steps"] == 8 and log[-1]["updates"] == 4

    with tiny_cli() as buf:
        cli.main(cli_argv(root, tmp_path / "one", "--accum_iter", "2",
                          "--epochs", "2", "--resume", str(path)))
    assert "resuming at epoch 1, batch 1" in buf.getvalue()
    one = torch.load(tmp_path / "one" / "checkpoint-1.pth", weights_only=True)
    assert {int(s["step"]) for s in one["optimizer"]["state"].values()} == {4}
