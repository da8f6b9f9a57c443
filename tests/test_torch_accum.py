"""Gradient accumulation on the port's pretraining path (`--accum_iter`)
against the JAX package, on the CPU at a tiny size:

  * `PretrainTask` with accum 2 against JAX's `PretrainTask` with accum 2
    (optax.MultiSteps over optax.adamw) over 4 micro-steps with the epoch
    cosine at 3 micro-steps an epoch: parameters, AdamW moments and count,
    the open cycle and the applied lr after every micro-step;
  * `python -m ecamp_tpu_torch.cli.pretrain --accum_iter 2` over 3
    micro-steps an epoch (epoch 0 ends mid-cycle), and a resume from its
    `checkpoint-0.pth`, equal to the uninterrupted run bit for bit;
  * that checkpoint, with its open cycle, read by the JAX package's
    reference-checkpoint importer.
"""

import contextlib
import dataclasses
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

from ecamp_tpu.core import config as jcfg  # noqa: E402
from ecamp_tpu.core.mesh import make_mesh  # noqa: E402
from ecamp_tpu.train.pretrain import PretrainTask as JaxPretrainTask  # noqa: E402
from ecamp_tpu.train.state import TrainState as JaxTrainState  # noqa: E402
from ecamp_tpu_torch.ckpt import state_dict_from_flax  # noqa: E402
from ecamp_tpu_torch.ckpt.checkpoint import CYCLE_KEY  # noqa: E402
from ecamp_tpu_torch.cli import pretrain as cli  # noqa: E402
from ecamp_tpu_torch.core import config as pcfg  # noqa: E402
from ecamp_tpu_torch.data.synthetic import write_mimic_corpus  # noqa: E402
from ecamp_tpu_torch.train.pretrain import PretrainTask  # noqa: E402
from ecamp_tpu_torch.train.state import adamw_state  # noqa: E402
from test_cli_pretrain_viz import _make_tokenizer_json  # noqa: E402
from test_torch_cli_pretrain import _tiny_kw  # noqa: E402
from test_torch_pretrain import NOISE, _batch, _tiny, jax_noise  # noqa: E402, F401

ACCUM = 2
STEPS_PER_EPOCH = 3  # odd: epoch 0 ends mid-cycle
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads: the suite runs six workers on the machine's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _accum_cfg(lib):
    """The tiny config with the CLI's AdamW and epoch cosine (lr 1e-3,
    warmup 1 epoch of 4) and accumulation over ACCUM micro-steps."""
    return dataclasses.replace(
        _tiny(lib), max_epoch=4,
        optimizer=lib.OptimizerConfig(lr=1e-3, warmup_epochs=1,
                                      accum_steps=ACCUM))


def _jax_adam(opt_state):
    return next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


def _exact_grad(sd):
    """Leave out the attention key biases (BERT's `key.bias`, the middle
    third of each `qkv.bias`): their gradient is 0 in exact arithmetic
    (softmax does not see a shift of the scores), so AdamW turns each
    side's rounding noise into updates of up to lr."""
    out = {}
    for k, v in sd.items():
        if k.endswith(".key.bias"):
            continue
        if k.endswith("qkv.bias"):
            d = v.shape[0] // 3
            v = torch.cat([v[:d], v[2 * d:]])
        out[k] = v
    return out


def _within(got, want, what):
    """Each leaf within TOL of its largest magnitude."""
    assert set(got) == set(want), what
    for k, w in want.items():
        err = float((got[k] - w).abs().max())
        assert err <= TOL * max(float(w.abs().max()), 1e-30), (what, k, err)


def test_pretrain_task_accum_matches_jax(jax_noise):
    """4 micro-steps at accum 2 on 4 batches: the parameters move only at
    micro-steps 2 and 4 (the first update's lr is the warmup's 0, the
    second's that of micro-step 2), and after every micro-step the
    parameters (1e-6 absolute), the moments (TOL of each leaf's scale),
    AdamW's count, the cycle's micro-step and the applied lr equal JAX's;
    the AdamW state under accumulation round-trips through the reference
    layout with the cycle kept."""
    c = _accum_cfg(jcfg)
    jtask = JaxPretrainTask(c, mesh=make_mesh(c.mesh,
                                              devices=jax.devices()[:1]),
                            steps_per_epoch=STEPS_PER_EPOCH)
    params = jax.jit(lambda r: jtask.model.init(
        {"params": r, "masking": jax.random.fold_in(r, 1)},
        jtask.fake_batch(2), mask_ratio=c.mask_ratio,
        deterministic=True))(jax.random.PRNGKey(0))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    jstate = jtask.place_state(JaxTrainState.create(
        jax.tree_util.tree_map(jnp.asarray, params), jtask.tx))

    port = PretrainTask(_accum_cfg(pcfg), device="cpu",
                        steps_per_epoch=STEPS_PER_EPOCH)
    port.model.load_state_dict(state_dict_from_flax(params), strict=True)
    state = port.init_state()
    lrs = []
    for i in range(4):
        before = {k: v.clone() for k, v in port.model.state_dict().items()}
        batch = _batch(5 + i)
        jstate, jm = jtask.train_step(jstate, jtask.shard_batch(batch),
                                      jax.random.PRNGKey(7))
        state, m = port.train_step(state, port.put_batch(batch),
                                   noise=torch.from_numpy(NOISE),
                                   deterministic=True)
        for k in ("loss", "mim_loss", "res_loss", "mlm_loss"):
            assert abs(float(m[k]) - float(jm[k])) <= TOL * abs(
                float(jm[k])), (i, k)
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-7)
        lrs.append(float(m["lr"]))
        jadam, adam = _jax_adam(jstate.opt_state), adamw_state(state.opt_state)
        assert int(adam.count) == int(jadam.count) == (i + 1) // ACCUM
        assert state.opt_state.mini_step == int(jstate.opt_state.mini_step) \
            == (i + 1) % ACCUM
        assert int(state.step) == port.step == i + 1

        got = _exact_grad(port.model.state_dict())
        want = _exact_grad(state_dict_from_flax(jstate.params))
        for k, w in want.items():
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0,
                                       atol=1e-6, err_msg=f"{i} {k}")
        moved = any(not torch.equal(v, before[k])
                    for k, v in port.model.state_dict().items())
        assert moved == (i == 3), i  # micro-step 2's update has lr 0
        _within(_exact_grad(adam.mu), _exact_grad(
            state_dict_from_flax(jadam.mu)), f"mu {i}")
        _within(_exact_grad(adam.nu), _exact_grad(
            state_dict_from_flax(jadam.nu)), f"nu {i}")
    # the applied lr is the epoch cosine at each cycle's first micro-step
    sched = port.schedule
    assert lrs == [float(sched(0))] * 2 + [float(sched(2))] * 2
    assert lrs[2] > 0

    # the reference layout reaches the inner AdamW; loading keeps the cycle
    sd = state.optimizer_state_dict(0.05)
    assert {int(s["step"]) for s in sd["state"].values()} == {2}
    state, _ = port.train_step(state, port.put_batch(_batch(9)),
                               noise=torch.from_numpy(NOISE),
                               deterministic=True)
    again = state.load_optimizer_state_dict(sd)
    assert again.opt_state.mini_step == 1
    assert again.opt_state.acc_grads is state.opt_state.acc_grads
    cycle = again.cycle_state_dict()
    assert cycle["mini_step"] == 1 and set(cycle["acc_grads"]) == set(
        state.params)
    back = again.load_cycle_state_dict(cycle, ACCUM)
    assert back.opt_state.mini_step == 1
    assert back.load_cycle_state_dict(None, ACCUM).opt_state.mini_step == 0
    # a cycle longer than the run's accumulation allows
    for mini, every_k in ((1, 1), (2, 2), (3, 2)):
        with pytest.raises(ValueError, match="open cycle"):
            again.load_cycle_state_dict(dict(cycle, mini_step=mini), every_k)


def _corpus(tmp_path, n_images):
    vocab = tmp_path / "tiny_wordpiece.json"
    _make_tokenizer_json(vocab)
    return write_mimic_corpus(str(tmp_path / "mimic"), str(vocab),
                              n_images=n_images, img_size=96,
                              max_window_start=1, seed=0)


def cli_argv(root, out, *extra):
    """The tiny CLI run of `tests/test_torch_cli_pretrain.py` (B = 4)."""
    return ["--data_path", root, "--batch_size", "4", "--max_epoch", "4",
            "--warmup_epochs", "1", "--input_size", "64",
            "--max_caption_length", "16", "--num_workers", "2",
            "--output_dir", str(out), "--no_bf16", "--print_freq", "1",
            "--device", "cpu", *extra]


@contextlib.contextmanager
def tiny_cli():
    """The CLI at the tiny model, its prints swallowed."""
    orig = pcfg.PretrainConfig

    def tiny_config(**kw):
        return orig(**dict(kw, **_tiny_kw(pcfg)))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli.cfg, "PretrainConfig", tiny_config)
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            yield buf


def read_log(out):
    return [json.loads(line)
            for line in (out / "log.txt").read_text().splitlines()]


@pytest.fixture(scope="module")
def accum_runs(tmp_path_factory):
    """accum 2 at 3 micro-steps an epoch: 2 epochs in one directory, and 1
    epoch then a resume from its checkpoint-0.pth for the second in
    another (BERT dropout on)."""
    tmp = tmp_path_factory.mktemp("accum")
    root = _corpus(tmp, 12)
    with tiny_cli() as buf:
        cli.main(cli_argv(root, tmp / "whole", "--accum_iter", "2",
                          "--epochs", "2"))
        cli.main(cli_argv(root, tmp / "split", "--accum_iter", "2",
                          "--epochs", "1"))
        cli.main(cli_argv(root, tmp / "split", "--accum_iter", "2",
                          "--epochs", "2", "--resume",
                          str(tmp / "split" / "checkpoint-0.pth")))
    return tmp, buf.getvalue()


def test_cli_accum_resume_repeats_the_uninterrupted_run(accum_runs):
    """Epoch 0 ends after 3 micro-steps, one update and an open cycle of
    one micro-step, which checkpoint-0.pth carries; the resumed second
    epoch equals the uninterrupted one bit for bit: losses, lr, the
    parameters, moments, count and cycle of checkpoint-1.pth."""
    tmp, printed = accum_runs
    assert "(torch step 1)" in printed and "resuming at epoch 1" in printed
    c0 = torch.load(tmp / "whole" / "checkpoint-0.pth", weights_only=True)
    assert c0["epoch"] == 0 and c0[CYCLE_KEY]["mini_step"] == 1
    assert set(c0[CYCLE_KEY]["acc_grads"]) == set(c0["model"])
    assert {int(s["step"]) for s in c0["optimizer"]["state"].values()} == {1}
    logs = {name: read_log(tmp / name) for name in ("whole", "split")}
    assert [(r["micro_steps"], r["updates"]) for r in logs["whole"]] == [
        (3, 1), (6, 3)]
    assert logs["split"] == logs["whole"]
    for r in logs["whole"]:
        assert all(np.isfinite(r[k]) for k in ("loss", "mim_loss", "lr"))
    whole, split = (torch.load(tmp / name / "checkpoint-1.pth",
                               weights_only=True)
                    for name in ("whole", "split"))
    assert whole[CYCLE_KEY] == {"mini_step": 0} == split[CYCLE_KEY]
    for k, v in whole["model"].items():
        assert torch.equal(v, split["model"][k]), k
    for i, st in whole["optimizer"]["state"].items():
        other = split["optimizer"]["state"][i]
        assert int(st["step"]) == int(other["step"]) == 3
        for f in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(st[f], other[f]), (i, f)


def test_cycle_checkpoint_reads_into_jax(accum_runs):
    """checkpoint-0.pth, open cycle and all, through the JAX package's
    torch-free reader and `import_ecamp_adamw_state` into a JAX state with
    accumulation: AdamW's count 1 and both moments of every parameter
    equal the file's."""
    from ecamp_tpu.ckpt.torch_import import (import_ecamp_adamw_state,
                                             load_pth)

    path = accum_runs[0] / "whole" / "checkpoint-0.pth"
    raw = load_pth(str(path))
    assert int(raw[CYCLE_KEY]["mini_step"]) == 1
    ckpt = torch.load(path, weights_only=True)
    cfg = jcfg.PretrainConfig(
        data=jcfg.DataConfig(img_size=64), mesh=jcfg.MeshConfig(data=1),
        optimizer=jcfg.OptimizerConfig(accum_steps=2), **_tiny_kw(jcfg))
    task = JaxPretrainTask(cfg, mesh=make_mesh(cfg.mesh,
                                               devices=jax.devices()[:1]))
    params = jax.eval_shape(lambda r: task.model.init(
        {"params": r, "masking": jax.random.fold_in(r, 1)},
        task.fake_batch(2), mask_ratio=cfg.mask_ratio,
        deterministic=True), jax.random.PRNGKey(0))["params"]
    params = jax.tree_util.tree_map(lambda s: jnp.zeros(s.shape, s.dtype),
                                    params)
    opt_state, n, step = import_ecamp_adamw_state(task.tx.init(params),
                                                  params, raw)
    assert (n, step) == (len(ckpt["optimizer"]["state"]), 1)
    adam = _jax_adam(opt_state)
    assert int(adam.count) == 1
    order = list(ckpt["model"])  # the reference's index order, rebuilt
    no_decay = [k for k in order
                if ckpt["model"][k].ndim <= 1 or k.endswith(".bias")]
    order = no_decay + [k for k in order if k not in set(no_decay)]
    for tree, field in ((adam.mu, "exp_avg"), (adam.nu, "exp_avg_sq")):
        moments = state_dict_from_flax(tree)
        for i, k in enumerate(order):
            np.testing.assert_array_equal(
                moments[k].numpy(),
                ckpt["optimizer"]["state"][i][field].numpy(), err_msg=k)
