"""The port's fused vocab-projection + weighted CE
(`ecamp_tpu_torch/kernels/fused_mlm_loss.py`) against the JAX package's
`fused_mlm_loss_sum`, run in Pallas interpret mode as
tests/test_fused_mlm_kernel.py runs it (BLOCK_N 32, BLOCK_V 128), and the
tiny ECAMP with `fused_mlm_ce=True` against the JAX ECAMP with the fused
CE switched on (`fused_supported` patched to True, interpret mode).

On the CPU the port runs the kernels' plain versions: the fp32
materialised forward and the plain backward with the kernels' dtype rules.
The JAX weight is (D, V); the port's is (V, D).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

torch = pytest.importorskip("torch")

from ecamp_tpu.kernels import fused_mlm_loss as JF  # noqa: E402
from ecamp_tpu_torch.ckpt import state_dict_from_flax  # noqa: E402
from ecamp_tpu_torch.kernels import fused_mlm_loss as PF  # noqa: E402
from ecamp_tpu_torch.train.pretrain import PretrainTask  # noqa: E402
from test_torch_pretrain import NOISE, _batch, _tiny  # noqa: E402

from ecamp_tpu.core import config as jcfg  # noqa: E402
from ecamp_tpu.core.mesh import make_mesh  # noqa: E402
from ecamp_tpu.train.pretrain import PretrainTask as JaxPretrainTask  # noqa: E402
from ecamp_tpu_torch.core import config as pcfg  # noqa: E402


@pytest.fixture
def small_blocks(monkeypatch):
    monkeypatch.setattr(JF, "BLOCK_N", 32)
    monkeypatch.setattr(JF, "BLOCK_V", 128)


def _inputs(n, d, v, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, d)).astype(np.float32) * 0.5,
            rng.normal(size=(d, v)).astype(np.float32) * 0.1,
            rng.normal(size=(v,)).astype(np.float32) * 0.1,
            rng.integers(0, v, (n,)).astype(np.int32),
            rng.random((n,)).astype(np.float32))


@pytest.mark.parametrize("n,d,v", [(70, 64, 300), (128, 32, 257)])
def test_plain_fused_ce_matches_pallas_kernel(n, d, v, small_blocks):
    """Loss within 1e-5 relative, dx / dW / db within rtol 1e-4, atol 1e-5
    of the Pallas kernels' forward and custom VJP."""
    x, w, b, labels, weights = _inputs(n, d, v)
    j = [jnp.asarray(a) for a in (x, w, b, labels, weights)]
    with pltpu.force_tpu_interpret_mode():
        want = JF.fused_mlm_loss_sum(*j)
        want_grads = jax.grad(JF.fused_mlm_loss_sum, argnums=(0, 1, 2))(*j)

    xt, wt, bt = (torch.tensor(a, requires_grad=True)
                  for a in (x, np.ascontiguousarray(w.T), b))
    before = (PF.launches_fwd.value, PF.launches_dx.value,
              PF.launches_dw.value)
    got = PF.fused_mlm_loss_sum(xt, wt, bt, torch.from_numpy(labels),
                                torch.from_numpy(weights))
    got.backward()
    assert (PF.launches_fwd.value, PF.launches_dx.value,
            PF.launches_dw.value) == before  # CPU tensors: no kernel
    assert abs(float(got.detach()) - float(want)) / abs(float(want)) < 1e-5
    for name, a, e in (("dx", xt.grad, want_grads[0]),
                       ("dW", wt.grad.T, want_grads[1]),
                       ("db", bt.grad, want_grads[2])):
        np.testing.assert_allclose(a.numpy(), np.asarray(e), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_plain_pieces_agree_with_the_reference_formula():
    """`_forward_plain` gives `_fused_reference`'s loss; the plain backward
    equals autograd of `_fused_reference` in fp32 and keeps the kernels'
    dtypes in bf16 (dx in x's dtype, dW in w's, db fp32)."""
    x, w, b, labels, weights = _inputs(40, 24, 130, seed=1)
    xt, wt, bt = (torch.tensor(a, requires_grad=True)
                  for a in (x, np.ascontiguousarray(w.T), b))
    lab, wts = torch.from_numpy(labels), torch.from_numpy(weights)
    ref = PF._fused_reference(xt, wt, bt, lab, wts)
    ref.backward()
    lse, gold = PF._forward_plain(xt.detach(), wt.detach(), bt.detach(), lab)
    assert torch.allclose(((lse - gold) * wts).sum(), ref.detach())
    g = torch.tensor(0.75)
    dx, dw, db = PF._fused_backward_plain(xt.detach(), wt.detach(),
                                          bt.detach(), lab, lse, g * wts)
    for a, e in ((dx, xt.grad), (dw, wt.grad), (db, bt.grad)):
        torch.testing.assert_close(a, 0.75 * e, rtol=1e-5, atol=1e-6)
    xb, wb = xt.detach().bfloat16(), wt.detach().bfloat16()
    dx, dw, db = PF._fused_backward_plain(xb, wb, bt.detach(), lab, lse, wts)
    assert (dx.dtype, dw.dtype, db.dtype) == (torch.bfloat16, torch.bfloat16,
                                              torch.float32)


def test_kernel_wrapper_refuses_what_the_kernels_do_not_take():
    x, w = torch.zeros(4, 8), torch.zeros(10, 8)
    b, lab = torch.zeros(10), torch.zeros(4, dtype=torch.long)
    assert PF._check(x, w, b, lab) == 0
    assert PF._check(x.bfloat16(), w.bfloat16(), b, lab) == 1
    for args, msg in (((x, torch.zeros(10, 9), b, lab), "x \\(N, D\\)"),
                      ((torch.zeros(4, 800), torch.zeros(10, 800), b, lab),
                       "D <= 768"),
                      ((x.half(), w.half(), b, lab), "fp32 or bf16"),
                      ((x, w.bfloat16(), b, lab), "of one dtype"),
                      ((x, w, b.bfloat16(), lab), "bias must be fp32"),
                      ((x, w, b, lab[:3]), "labels must be"),
                      ((torch.zeros(8, 4).T, w, b, lab), "contiguous")):
        with pytest.raises(ValueError, match=msg):
            PF._check(*args)


# -- the tiny ECAMP with the fused CE ------------------------------------------

@pytest.fixture(scope="module")
def jax_fused():
    """The JAX tiny ECAMP's params, and its losses and gradients with the
    fused CE on (interpret mode) from NOISE: one compile for the module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JF, "BLOCK_N", 32)
        mp.setattr(JF, "BLOCK_V", 128)
        mp.setattr(JF, "fused_supported", lambda: True)
        uniform = jax.random.uniform

        def fake(key, shape=(), *args, **kwargs):
            if tuple(shape) == NOISE.shape:
                return jnp.asarray(NOISE)
            return uniform(key, shape, *args, **kwargs)

        mp.setattr(jax.random, "uniform", fake)
        cfg = _tiny(jcfg)
        task = JaxPretrainTask(cfg, mesh=make_mesh(cfg.mesh,
                                                   devices=jax.devices()[:1]))
        params = jax.jit(lambda r: task.model.init(
            {"params": r, "masking": jax.random.fold_in(r, 1)},
            task.fake_batch(2), mask_ratio=cfg.mask_ratio,
            deterministic=True))(jax.random.PRNGKey(0))["params"]
        jb = {k: jnp.asarray(v) for k, v in _batch().items()}

        def loss_fn(p):
            out = task.model.apply({"params": p}, jb, mask_ratio=0.75,
                                   deterministic=True,
                                   rngs={"masking": jax.random.PRNGKey(1)})
            return out["mim_loss"] + out["res_loss"] + out["mlm_loss"], out

        with pltpu.force_tpu_interpret_mode():
            (_, out), grads = jax.jit(jax.value_and_grad(
                loss_fn, has_aux=True))(params)
    assert "mlm_logits" not in out  # the JAX forward took the fused branch
    return (jax.tree_util.tree_map(np.asarray, params),
            {k: float(v) for k, v in out.items()}, grads)


def _fused_task(params, fused=True):
    import dataclasses

    task = PretrainTask(dataclasses.replace(_tiny(pcfg), fused_mlm_ce=fused),
                        device="cpu")
    task.model.load_state_dict(state_dict_from_flax(params), strict=True)
    return task


def test_fused_ecamp_losses_and_grads_match_jax(jax_fused):
    """Losses within 1e-5 relative, every parameter's gradient within
    rtol 1e-4 / atol 1e-6 of the JAX ECAMP with the fused CE."""
    params, want, jgrads = jax_fused
    model = _fused_task(params).model.eval()
    batch = {k: torch.as_tensor(v) for k, v in _batch().items()}
    out = model(batch, noise=torch.from_numpy(NOISE))
    assert "mlm_logits" not in out
    (out["mim_loss"] + out["res_loss"] + out["mlm_loss"]).backward()
    for k in ("mim_loss", "res_loss", "mlm_loss"):
        assert abs(float(out[k].detach()) - want[k]) / abs(want[k]) < 1e-5, k
    ref = state_dict_from_flax(jgrads)
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(ref)
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), ref[k].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_fused_task_steps_match_the_materialised_steps(jax_fused):
    """Three PretrainTask steps with `fused_mlm_ce` take the same losses as
    the materialised-logits steps (1e-5), and `set_plain` reaches the
    fused CE."""
    params = jax_fused[0]
    batch = {k: torch.as_tensor(v) for k, v in _batch().items()}
    losses = {}
    for fused in (True, False):
        task = _fused_task(params, fused)
        assert task.model.fused_mlm_ce is fused
        state = task.init_state()
        losses[fused] = []
        for _ in range(3):
            state, m = task.train_step(state, batch,
                                       noise=torch.from_numpy(NOISE))
            losses[fused].append({k: float(v) for k, v in m.items()})
    for got, want in zip(losses[True], losses[False]):
        for k in ("loss", "mim_loss", "res_loss", "mlm_loss"):
            assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]), k
    task.set_plain(True)
    assert task.model.plain is True
