"""The port's optimizers and LR schedules (ecamp_tpu_torch.train.optim,
kernels.fused_adamw on its plain path) against optax and the JAX
package's schedules, over several steps on a small parameter set."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

torch = pytest.importorskip("torch")

from ecamp_tpu.core import config as jcfg  # noqa: E402
from ecamp_tpu.train import optim as joptim  # noqa: E402
from ecamp_tpu_torch.core import config as pcfg  # noqa: E402
from ecamp_tpu_torch.kernels import fused_adamw as fa  # noqa: E402
from ecamp_tpu_torch.train import optim as poptim  # noqa: E402

SHAPES = {"dense.kernel": (24, 40), "dense.bias": (40,), "norm.scale": (24,),
          "vocab.kernel": (7, 13), "conv.kernel": (3, 3, 3, 3),
          "cls_token": (1, 1, 8)}


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=s).astype(np.float32)
            for k, s in SHAPES.items()}


def _grads(step):
    rng = np.random.default_rng(100 + step)
    return {k: (rng.normal(size=s) * (1 + step)).astype(np.float32)
            for k, s in SHAPES.items()}


@pytest.mark.parametrize("schedule", ["warmup_cosine_epoch",
                                      "warmup_cosine_step",
                                      "warmup_linear_step", "constant"])
def test_schedules_match_jax(schedule):
    kw = dict(schedule=schedule, lr=1e-3, min_lr=1e-5, warmup_epochs=2.0,
              warmup_steps=5, total_steps=40)
    want = joptim.make_schedule(jcfg.OptimizerConfig(**kw),
                                steps_per_epoch=4, max_epoch=10)
    got = poptim.make_schedule(pcfg.OptimizerConfig(**kw), steps_per_epoch=4,
                               max_epoch=10)
    for step in (0, 1, 3, 5, 8, 17, 39, 40, 55):
        g = got(torch.tensor(step, dtype=torch.int32))
        assert g.dtype == torch.float32
        np.testing.assert_allclose(float(g), float(want(jnp.int32(step))),
                                   rtol=2e-6, atol=1e-12, err_msg=str(step))


def _run(tx_port, tx_ref, steps=4):
    params = _params()
    ref_p = {k: jnp.asarray(v) for k, v in params.items()}
    ref_s = tx_ref.init(ref_p)
    port_p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = tx_port.init(port_p)
    for step in range(steps):
        g = _grads(step)
        upd, ref_s = tx_ref.update({k: jnp.asarray(v) for k, v in g.items()},
                                   ref_s, ref_p)
        ref_p = optax.apply_updates(ref_p, upd)
        state = tx_port.apply(port_p, {k: torch.from_numpy(v)
                                       for k, v in g.items()}, state)
    assert int(state.count) == steps
    return port_p, ref_p, state


@pytest.mark.parametrize("clip", [None, 0.5, 1e6])
@pytest.mark.parametrize("wd", [0.0, 0.05])
def test_fused_adamw_plain_matches_optax(clip, wd):
    """FusedAdamW on its plain path against optax.chain([clip], adamw with
    the ndim > 1 decay mask), over 4 steps of a schedule that changes per
    step (so the pre-increment count is exercised)."""
    def sched_j(step):
        return 1e-2 * (1.0 + 0.1 * jnp.asarray(step, jnp.float32))

    def sched_p(step):
        return 1e-2 * (1.0 + 0.1 * step.to(torch.float32))

    chain = ([optax.clip_by_global_norm(clip)] if clip else []) + [
        optax.adamw(sched_j, b1=0.9, b2=0.95, eps=1e-8, weight_decay=wd,
                    mask=joptim._decay_mask if wd > 0 else None)]
    port = fa.FusedAdamW(sched_p, 0.9, 0.95, 1e-8, wd,
                         mask_fn=poptim._decay_mask, grad_clip=clip)
    got, want, state = _run(port, optax.chain(*chain))
    for k in SHAPES:
        # fp32 elementwise ops in one order; pow and sqrt may differ by an
        # ulp between the two libraries
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    assert set(state.mu) == set(SHAPES)


def test_sgd_matches_optax():
    cfg = pcfg.OptimizerConfig(name="sgd", lr=3e-2, weight_decay=0.05,
                               grad_clip=1.0, schedule="warmup_cosine_step",
                               warmup_steps=2, total_steps=10)
    port = poptim.make_optimizer(cfg)
    ref = joptim.make_optimizer(jcfg.OptimizerConfig(
        name="sgd", lr=3e-2, weight_decay=0.05, grad_clip=1.0,
        schedule="warmup_cosine_step", warmup_steps=2, total_steps=10))
    got, want, _ = _run(port, ref)
    for k in SHAPES:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_make_optimizer_adamw_and_refusals():
    tx = poptim.make_optimizer(pcfg.OptimizerConfig(grad_clip=1.0))
    assert isinstance(tx, fa.FusedAdamW) and tx.grad_clip == 1.0
    assert (tx.b1, tx.b2, tx.eps, tx.weight_decay) == (0.9, 0.95, 1e-8, 0.05)
    # the wrappers compose as the JAX package's chain: the scales after the
    # optimizer, accumulation around them, the freeze mask outermost
    tx = poptim.make_optimizer(pcfg.OptimizerConfig(accum_steps=2),
                               freeze_mask={}, lr_scales={})
    assert isinstance(tx, poptim.Masked)
    assert isinstance(tx.inner, poptim.MultiSteps) and tx.inner.every_k == 2
    assert isinstance(tx.inner.inner, poptim.LayerwiseScaled)
    assert isinstance(tx.inner.inner.inner, fa.FusedAdamW)
    with pytest.raises(ValueError, match="unknown optimizer"):
        poptim.make_optimizer(pcfg.OptimizerConfig(name="lamb"))


MASK = {k: k.startswith(("dense", "conv")) for k in SHAPES}
SCALES = {k: 0.5 ** i for i, k in enumerate(SHAPES)}


@pytest.mark.parametrize("name", ["sgd", "adamw"])
@pytest.mark.parametrize("wrap", ["mask", "scales", "accum", "mask+accum",
                                  "scales+accum", "accum+epoch_cosine"])
def test_wrappers_match_optax(name, wrap):
    """The freeze mask, layer-wise lr scales and accumulation (3 micro-steps
    an update, 6 calls) around SGD and AdamW (its plain path, clip 1.0),
    against the JAX package's make_optimizer (optax.multi_transform,
    scale_by_layerwise_lr, optax.MultiSteps) on the same flat params. The
    schedule moves with the step, so counting updates and not micro-steps
    shows. (The JAX package cannot take a mask and scales together: its
    scales tree does not match multi_transform's masked updates.)"""
    kw = dict(name=name, lr=3e-2, weight_decay=0.05, grad_clip=1.0,
              schedule="warmup_cosine_step", warmup_steps=2, total_steps=10,
              accum_steps=3 if "accum" in wrap else 1)
    extra = {"freeze_mask": MASK if "mask" in wrap else None,
             "lr_scales": SCALES if "scales" in wrap else None}
    if "epoch_cosine" in wrap:  # read at each cycle's first micro-step
        kw.update(schedule="warmup_cosine_epoch", warmup_epochs=1.0)
        extra.update(steps_per_epoch=2, max_epoch=3)
    port = poptim.make_optimizer(pcfg.OptimizerConfig(**kw), **extra)
    ref = joptim.make_optimizer(jcfg.OptimizerConfig(**kw), **extra)
    params = _params()
    ref_p = {k: jnp.asarray(v) for k, v in params.items()}
    ref_s = ref.init(ref_p)
    port_p = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = port.init(port_p)
    for step in range(6):
        g = _grads(step)
        upd, ref_s = ref.update({k: jnp.asarray(v) for k, v in g.items()},
                                ref_s, ref_p)
        ref_p = optax.apply_updates(ref_p, upd)
        state = port.apply(port_p, {k: torch.from_numpy(v)
                                    for k, v in g.items()}, state)
        for k in SHAPES:
            np.testing.assert_allclose(port_p[k].numpy(), np.asarray(ref_p[k]),
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"{k} after call {step}")
    for k in SHAPES:
        if extra["freeze_mask"] is not None and not MASK[k]:
            np.testing.assert_array_equal(port_p[k].numpy(), params[k])


def test_adamw_leaf_table_layout():
    """The kernel's device tables, built on CPU tensors: one row of
    addresses per leaf, chunks of CHUNK elements per leaf, and the address
    row rebuilt only when a tensor is allocated anew."""
    sizes = [fa.CHUNK * 2 + 5, 3, fa.CHUNK]
    ps = [torch.zeros(n) for n in sizes]
    gs, ms, vs = ([torch.zeros(n) for n in sizes] for _ in range(3))
    t = fa._LeafTable(ps, gs, ms, vs, [0.05, 0.0, 0.05])
    assert t.chunk_leaf.tolist() == [0, 0, 0, 1, 2]
    assert t.chunk_start.tolist() == [0, fa.CHUNK, 2 * fa.CHUNK, 0, 0]
    assert t.numel.tolist() == sizes and t.n_chunks == 5
    assert t.ptrs.tolist()[:4] == [ps[0].data_ptr(), gs[0].data_ptr(),
                                   ms[0].data_ptr(), vs[0].data_ptr()]
    before = t.ptrs
    t.update(ps, gs, ms, vs)
    assert t.ptrs is before
    gs[1] = torch.zeros(3)
    t.update(ps, gs, ms, vs)
    assert t.ptrs is not before and t.ptrs.tolist()[5] == gs[1].data_ptr()
    with pytest.raises(ValueError, match="fp32"):
        fa._check_leaves([ps[1]], [gs[1].double()], [ms[1]], [vs[1]])
    with pytest.raises(ValueError, match="contiguous"):
        fa._check_leaves([torch.zeros(4, 2)], [torch.zeros(2, 4).t()],
                         [torch.zeros(4, 2)], [torch.zeros(4, 2)])
