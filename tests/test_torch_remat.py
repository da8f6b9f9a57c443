"""Activation checkpointing in the port (`ViTConfig.remat`,
`MAEDecoderConfig.remat`, `BertConfig.remat`; `nn/layers.py::remat`) on the
CPU, at the tiny size of tests/test_train_steps.py:140 (ViT 32 / 2 / 2,
decoder 16 / 1 / 2, BERT 2 layers, vocab 64, L = 8, fp32):

  * the port's remat pretraining step against the JAX package's remat step
    from the same weights (JAX init -> `state_dict_from_flax`), injected
    noise, dropout off; a JAX remat model's parameters are the plain
    model's, and load into a port remat model unchanged;
  * the port's remat step against its plain step with dropout on (BERT's
    hidden and attention dropout, `exact_attn_dropout`, the ViT trunk's
    dropout and drop-path): losses, gradients and parameters bit for bit,
    for pretraining and the classification, segmentation and detection
    tasks; a recompute that drew new masks would differ;
  * a remat module keeps fewer bytes for its backward;
  * `make_train_step_scan` with remat against sequential steps;
  * 2 gloo data-parallel ranks (plain and ZeRO-1) with remat against the
    same ranks without it, started beside the JAX compiles.

Torch runs at 2 threads. The JAX package runs its kernels' plain
references, the port its kernels' plain versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dp_ranks as ranks  # noqa: E402
from ecamp_tpu.core import config as jcfg  # noqa: E402
from ecamp_tpu.core.mesh import make_mesh  # noqa: E402
from ecamp_tpu.train.pretrain import PretrainTask as JaxPretrainTask  # noqa: E402
from ecamp_tpu.train.state import TrainState as JaxTrainState  # noqa: E402
from ecamp_tpu_torch.ckpt import state_dict_from_flax  # noqa: E402
from ecamp_tpu_torch.core import config as pcfg  # noqa: E402
from ecamp_tpu_torch.train.pretrain import PretrainTask  # noqa: E402
from test_torch_pretrain import (GRID, IMG, L, NOISE, _batch,  # noqa: E402
                                 _tiny, jax_noise)  # noqa: F401

STEPS = 3
WORLD = 2
DROP = 0.1  # every dropout and drop-path rate of the dropout-on runs


def _remat(cfg, on=True):
    """`cfg` with the remat flag of every config it holds set to `on`."""
    kw = {f.name: dataclasses.replace(getattr(cfg, f.name), remat=on)
          for f in dataclasses.fields(cfg)
          if hasattr(getattr(cfg, f.name), "remat")}
    return dataclasses.replace(cfg, **kw)


def _dropout(cfg, exact=False):
    """A tiny pretraining config with BERT's dropout on."""
    return dataclasses.replace(cfg, bert=dataclasses.replace(
        cfg.bert, hidden_dropout_prob=DROP,
        attention_probs_dropout_prob=DROP, exact_attn_dropout=exact))


def _dp_batch(seed=6):
    """A global batch of WORLD * 2 rows, as tests/test_torch_pretrain.py
    makes them."""
    one, two = _batch(seed), _batch(seed + 1)
    return {k: np.concatenate([one[k], two[k]]) for k in one}


@pytest.fixture(scope="module")
def dp_started(tmp_path_factory):
    """(v)'s 2 gloo ranks, started first so that they run while the JAX
    steps compile: plain and ZeRO-1 data parallelism, each with and
    without remat, dropout on, from the port's seeded weights."""
    torch.set_num_threads(2)
    cfg = _dropout(_tiny(pcfg))
    zero1 = dataclasses.replace(cfg, mesh=pcfg.MeshConfig(
        shard_optimizer=True))
    cfgs = {"plain": cfg, "plain_remat": _remat(cfg), "zero1": zero1,
            "zero1_remat": _remat(zero1)}
    weights = {k: v.numpy() for k, v in
               PretrainTask(cfg, device="cpu").model.state_dict().items()}
    noise = np.random.default_rng(12).uniform(
        size=(WORLD * 2, GRID)).astype(np.float32)
    run = ranks.start("remat_steps", WORLD, tmp_path_factory.mktemp("remat"),
                      cfgs=cfgs, weights=weights, batch=_dp_batch(),
                      noise=noise, steps=STEPS)
    yield run
    ranks.stop(run)  # ranks a failure left uncollected


@pytest.fixture(scope="module")
def jax_remat(dp_started):
    """The JAX remat task and the initial parameters of the remat and the
    plain model from one key (init jitted)."""
    cfg = _remat(_tiny(jcfg))
    task = JaxPretrainTask(cfg, mesh=make_mesh(cfg.mesh,
                                               devices=jax.devices()[:1]))
    fb = task.fake_batch(2)
    out = {}
    for on in (True, False):
        c = _remat(cfg, on)
        model = task.model.clone(vit=c.vit, decoder=c.decoder, bert=c.bert)
        params = jax.jit(lambda r, model=model: model.init(
            {"params": r, "masking": jax.random.fold_in(r, 1)}, fb,
            mask_ratio=cfg.mask_ratio, deterministic=True))(
                jax.random.PRNGKey(0))["params"]
        out[on] = jax.tree_util.tree_map(np.asarray, params)
    return task, out


def test_jax_remat_parameters_load_into_a_port_remat_model(jax_remat):
    """flax's `nn.remat(Block)(name=...)` keeps the parameter names: the
    JAX remat model's initial parameters are the plain model's, and
    `state_dict_from_flax` of them loads strictly into a port model built
    with the three remat flags, whose state dict has the plain one's
    keys."""
    _, params = jax_remat
    flat = {True: jax.tree_util.tree_leaves_with_path(params[True]),
            False: jax.tree_util.tree_leaves_with_path(params[False])}
    assert [p for p, _ in flat[True]] == [p for p, _ in flat[False]]
    for (path, a), (_, b) in zip(flat[True], flat[False]):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    port = PretrainTask(_remat(_tiny(pcfg)), device="cpu")
    sd = state_dict_from_flax(params[True])
    port.model.load_state_dict(sd, strict=True)
    plain = PretrainTask(_tiny(pcfg), device="cpu")
    assert set(port.model.state_dict()) == set(plain.model.state_dict())


def test_remat_pretrain_steps_match_jax_remat(jax_remat, jax_noise):
    """(i) Three remat steps (AdamW, constant lr 1e-3) of the port and of
    the JAX package from the same weights, batch and noise, dropout off:
    every loss within 1e-4 relative (as
    test_pretrain_task_three_steps_match_jax), the lr exact."""
    task, params = jax_remat
    jstate = task.place_state(JaxTrainState.create(
        jax.tree_util.tree_map(jnp.asarray, params[True]), task.tx))
    jbatch = task.shard_batch(_batch())
    want = []
    for _ in range(STEPS):
        jstate, m = task.train_step(jstate, jbatch, jax.random.PRNGKey(7))
        want.append({k: float(v) for k, v in m.items()})

    port = PretrainTask(_remat(_tiny(pcfg)), device="cpu")
    port.model.load_state_dict(state_dict_from_flax(params[True]),
                               strict=True)
    state, batch = port.init_state(), port.put_batch(_batch())
    for i in range(STEPS):
        state, m = port.train_step(state, batch,
                                   noise=torch.from_numpy(NOISE))
        for k in ("loss", "mim_loss", "res_loss", "mlm_loss"):
            got = float(m[k])
            assert abs(got - want[i][k]) <= 1e-4 * abs(want[i][k]), (i, k)
        assert float(m["lr"]) == pytest.approx(want[i]["lr"], rel=1e-7)


# -- (ii) remat against plain, dropout on, bit for bit ----------------------

def _steps(task, batches, step):
    """`step(task, state, batch)` over `batches` from a fresh state: the
    metrics, each step's gradients and the final state dict."""
    state = task.init_state()
    rows, grads = [], []
    for batch in batches:
        state, m = step(task, state, batch)
        rows.append({k: float(v) for k, v in m.items()})
        grads.append({k: p.grad.clone()
                      for k, p in task.model.named_parameters()
                      if p.grad is not None})
    return rows, grads, {k: v.clone()
                         for k, v in task.model.state_dict().items()}


def _equal(a, b):
    rows, grads, params = a
    assert rows == b[0]
    for g, h in zip(grads, b[1]):
        assert set(g) == set(h)
        for k in g:
            assert torch.equal(g[k], h[k]), k
    for k, v in params.items():
        assert torch.equal(v, b[2][k]), k


def _pretrain_case(exact):
    cfg = _dropout(_tiny(pcfg), exact)
    batches = [_batch(s) for s in (5, 6, 7)]

    def step(task, state, batch):
        return task.train_step(state, task.put_batch(batch))

    return cfg, PretrainTask, batches, step


def _vit(**kw):
    return pcfg.ViTConfig(img_size=32, patch_size=16, embed_dim=32, depth=2,
                          num_heads=2, **kw)


def _cls_case():
    from ecamp_tpu_torch.train.classification import ClassificationTask

    cfg = pcfg.ClassificationConfig(
        vit=_vit(drop_rate=DROP, attn_drop_rate=DROP, drop_path_rate=DROP),
        optimizer=pcfg.OptimizerConfig(
            name="sgd", lr=5e-2, momentum=0.9, schedule="warmup_cosine_step",
            warmup_steps=1, total_steps=8, grad_clip=1.0),
        num_classes=3, bf16=False, seed=5)
    rng = np.random.default_rng(21)
    batches = [(rng.normal(size=(4, 32, 32, 3)).astype(np.float32),
                (rng.random((4, 3)) < 0.4).astype(np.float32))
               for _ in range(STEPS)]

    def step(task, state, batch):
        return task.train_step(state, *(torch.from_numpy(a) for a in batch))

    return cfg, ClassificationTask, batches, step


def _seg_case():
    from ecamp_tpu_torch.train.segmentation import SegmentationTask

    cfg = pcfg.SegmentationConfig(
        vit=_vit(), optimizer=pcfg.OptimizerConfig(
            name="adamw", lr=1e-2, betas=(0.9, 0.999),
            schedule="warmup_cosine_step", warmup_steps=1, total_steps=8,
            grad_clip=1.0),
        decode_features=(16, 8, 8, 4), freeze_encoder=False, bf16=False,
        seed=5)
    rng = np.random.default_rng(22)
    batches = [(rng.normal(size=(4, 32, 32, 3)).astype(np.float32),
                (rng.random((4, 32, 32, 1)) < 0.3).astype(np.float32))
               for _ in range(STEPS)]

    def step(task, state, batch):
        return task.train_step(state, *(torch.from_numpy(a) for a in batch))

    return cfg, SegmentationTask, batches, step


def _det_case():
    from ecamp_tpu_torch.train.detection import DetectionTask

    cfg = pcfg.DetectionConfig(
        vit=_vit(), optimizer=pcfg.OptimizerConfig(
            name="adamw", lr=1e-4, betas=(0.9, 0.999),
            schedule="warmup_cosine_step", warmup_steps=0, total_steps=8,
            grad_clip=1.0),
        img_size=32, freeze_encoder=False, bf16=False, seed=5)
    rng = np.random.default_rng(23)
    batches = []
    for _ in range(STEPS):
        t = np.zeros((4, 10, 5), np.float32)
        t[:, :2, 1:3] = rng.uniform(0.1, 0.9, (4, 2, 2))
        t[:, :2, 3:] = rng.uniform(0.1, 0.6, (4, 2, 2))
        batches.append((rng.normal(size=(4, 32, 32, 3)).astype(np.float32),
                        t))

    def step(task, state, batch):
        return task.train_step(state, *(torch.from_numpy(a) for a in batch))

    return cfg, DetectionTask, batches, step


CASES = {"pretrain": lambda: _pretrain_case(False),
         "pretrain_exact_attn_dropout": lambda: _pretrain_case(True),
         "classification": _cls_case, "segmentation": _seg_case,
         "detection": _det_case}


@pytest.mark.parametrize("name", sorted(CASES))
def test_remat_step_equals_plain_step_with_dropout(name):
    """(ii) STEPS steps with the remat flags against the same steps
    without them, from the same weights and generators: metrics, every
    step's gradients and the parameters equal bit for bit in fp32. The
    pretraining and classification runs draw dropout (and drop-path) in
    the blocks that are recomputed; the segmentation and detection steps
    run their trunk deterministic, as JAX's do, and train it
    (freeze_encoder off), so remat runs there too."""
    torch.set_num_threads(2)
    cfg, cls, batches, step = CASES[name]()
    runs = {}
    for on in (False, True):
        task = cls(_remat(cfg, on), device="cpu")
        if on:
            task.model.load_state_dict(init, strict=True)
        else:
            init = {k: v.clone() for k, v in task.model.state_dict().items()}
        runs[on] = _steps(task, batches, step)
    _equal(runs[True], runs[False])
    if name.startswith("pretrain"):  # dropout moved the losses
        off = PretrainTask(_tiny(pcfg), device="cpu")
        off.model.load_state_dict(init, strict=True)
        rows = _steps(off, batches, step)[0]
        assert rows[0]["loss"] != runs[True][0][0]["loss"]


# -- (iii) what a remat module keeps for its backward ------------------------

def _saved_bytes(fn):
    """The bytes of the tensors that autograd saves while `fn` runs (those
    a checkpoint saves inside its own hooks are not seen), and fn's
    output."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return total[0], out


def _ecamp_run(on):
    from ecamp_tpu_torch.nn.mae import ECAMP

    c = _tiny(pcfg)
    model = ECAMP(dataclasses.replace(c.vit, remat=on),
                  dataclasses.replace(c.decoder, remat=on), c.bert,
                  c.sr_window, c.sr_scale,
                  generator=torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}

    def fn():
        out = model(batch, noise=torch.from_numpy(NOISE))
        return out["mim_loss"] + out["res_loss"] + out["mlm_loss"]

    return model, fn


def _vit_run(on):
    from ecamp_tpu_torch.nn.vit import ViTClassifier

    model = ViTClassifier(_vit(remat=on), 3,
                          generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(4, 32, 32, 3)).astype(np.float32))
    return model, lambda: model(x).square().sum()


def _bert_run(on):
    from ecamp_tpu_torch.nn.bert import MultimodalBert

    c = _tiny(pcfg).bert
    model = MultimodalBert(dataclasses.replace(c, remat=on))
    for m in model.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(torch.Generator().manual_seed(1))
    rng = np.random.default_rng(4)
    latent = torch.from_numpy(rng.normal(size=(2, 4, 32)).astype(np.float32))
    b = _batch()
    ids, mask = (torch.from_numpy(b[k]).long()
                 for k in ("ids", "attention_mask"))
    return model, lambda: model(latent, latent.mean(1, keepdim=True), ids,
                                attention_mask=mask).square().mean()


@pytest.mark.parametrize("name,run", [("ecamp", _ecamp_run),
                                      ("vit_classifier", _vit_run),
                                      ("multimodal_bert", _bert_run)])
def test_remat_module_keeps_fewer_bytes(name, run):
    """(iii) The forward of a module built with remat saves fewer bytes
    for its backward than the plain module (the encoder's and decoder's
    blocks of ECAMP, the ViT trunk of the classifier, the BERT layers),
    and its gradients equal the plain module's bit for bit."""
    torch.set_num_threads(2)
    got = {}
    for on in (False, True):
        model, fn = run(on)
        saved, loss = _saved_bytes(fn)
        loss.backward()
        got[on] = (saved, {k: p.grad for k, p in model.named_parameters()})
    assert got[True][0] < got[False][0], (got[True][0], got[False][0])
    for k, g in got[False][1].items():
        assert torch.equal(g, got[True][1][k]), k


# -- (iv) K steps a call ------------------------------------------------------

def test_remat_steps_per_call_equal_sequential_steps():
    """(iv) `make_train_step_scan` with K = 2 on the CPU (the K steps in
    order) with remat and dropout on equals two `train_step` calls."""
    torch.set_num_threads(2)
    cfg = _remat(_dropout(_tiny(pcfg)))
    batches = [_batch(s) for s in (5, 6)]
    seq = PretrainTask(cfg, device="cpu")
    init = {k: v.clone() for k, v in seq.model.state_dict().items()}
    state = seq.init_state()
    want = []
    for b in batches:
        state, m = seq.train_step(state, seq.put_batch(b))
        want.append({k: float(v) for k, v in m.items()})
    task = PretrainTask(cfg, device="cpu")
    task.model.load_state_dict(init, strict=True)
    state = task.init_state()
    scan = task.make_train_step_scan(state, 2)
    state, m = scan(state, task.put_superbatch(batches))
    assert [{k: float(v[i]) for k, v in m.items()} for i in range(2)] == want
    assert int(state.step) == task.step == 2
    for k, v in seq.model.state_dict().items():
        assert torch.equal(task.model.state_dict()[k], v), k


# -- (v) data parallelism -----------------------------------------------------

def test_remat_data_parallel_equals_plain(dp_started):
    """(v) On 2 gloo ranks, plain data parallelism and ZeRO-1 with remat
    equal the same runs without it bit for bit, dropout on: every step's
    metrics (the ranks' means), the last averaged gradients and the
    parameters, on every rank. The all-reduce runs after the backward's
    recompute, so remat needs nothing of `core/distributed.py`."""
    got = ranks.collect(dp_started)
    for rank in got:
        for base in ("plain", "zero1"):
            a, b = rank[base], rank[base + "_remat"]
            assert a["losses"] == b["losses"]
            for part in ("grads", "params"):
                for k, v in a[part].items():
                    assert torch.equal(v, b[part][k]), (base, part, k)
    assert got[0]["plain"]["params"].keys() == got[1]["plain"][
        "params"].keys()
    for k, v in got[0]["zero1_remat"]["params"].items():
        assert torch.equal(v, got[1]["zero1_remat"]["params"][k]), k
