"""The port's ECAMP embedding engine (ecamp_tpu_torch.serve.loaders::
embedding_engine, fp32 and int8) and its checkpoint export
(ecamp_tpu_torch.cli.export) against the JAX package, on the CPU, at the
tiny ECAMP of `tests/test_torch_quantize.py` (ViT img 32, patch 16, dim
64, depth 2; decoder 32/1; BERT 64 wide, 2 layers, vocab 128) and its
tiny classifier, SegViT and detector.

Weights go JAX init -> the JAX exporter's `.pth` (the embedding engine
reads it, as a user's reference checkpoint), or JAX init ->
`state_dict_from_flax` -> a `.pth` of the port's own layout, which
`cli.export` turns into the reference layout and the JAX exporter's file
is compared with.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_quantize import (IMG, MIN_ELEMS, _ecamp_cfgs,  # noqa: E402
                                 _init, _models, _vit)

from ecamp_tpu.ckpt import torch_export as jexport  # noqa: E402
from ecamp_tpu.ckpt import torch_import as jimport  # noqa: E402
from ecamp_tpu.serve import quantize as jq  # noqa: E402
from ecamp_tpu_torch.ckpt import state_dict_from_flax  # noqa: E402
from ecamp_tpu_torch.core import config as pcfg  # noqa: E402
from ecamp_tpu_torch.serve import quantize as pq  # noqa: E402

FEATURE_TOL = 1e-5  # fp32, unit vectors: absolute


@pytest.fixture(scope="module")
def ecamp_vars():
    v, _ = _init("ecamp")
    return v


def _jax_features(params, x):
    """JAX's embedding: `features_only` gap feature at mask ratio 0,
    L2-normalised, from `params` (a quantized tree is dequantized in the
    apply, as `wrap_apply_fn` does)."""
    jm = _models("ecamp")[0]

    def apply(p, xs):
        out = jm.apply({"params": p}, {"image": xs}, mask_ratio=0.0,
                       deterministic=True, features_only=True)
        f = out["gap_feature"].astype(jnp.float32)
        return f / jnp.linalg.norm(f, axis=-1, keepdims=True)

    if "scales" in params:
        apply = jq.wrap_apply_fn(apply)
        params = jax.tree_util.tree_map(jnp.asarray, params)
    return np.asarray(jax.jit(apply)(params, jnp.asarray(x)))


def _engine(path, **kw):
    from ecamp_tpu_torch.serve import embedding_engine

    vit, dec, bert = _ecamp_cfgs(pcfg)
    return embedding_engine(path, img_size=IMG, vit=vit, decoder=dec,
                            bert=bert, buckets=(4,), bf16=False,
                            device="cpu", **kw)


def _images(seed, n=3):
    return np.random.default_rng(seed).normal(size=(n, IMG, IMG, 3)).astype(
        np.float32)


def _pretrain_pth(tmp_path, variables, extra=None, drop=(), name="pre.pth"):
    """The JAX exporter's pretraining `.pth`, with `extra` entries added
    (a reference checkpoint's) and `drop` entries removed."""
    path = str(tmp_path / name)
    ckpt = jexport.export_ecamp_pretrain(variables, path, epoch=2)
    if extra or drop:
        state = {k: torch.tensor(v) for k, v in ckpt["model"].items()
                 if k not in drop}
        state.update(extra or {})
        torch.save({"model": state, "epoch": 2}, path)
    return path


def test_embedding_engine_matches_jax(tmp_path, ecamp_vars):
    """`embedding_engine` (fp32, CPU) on a JAX-exported pretraining `.pth`
    gives JAX's L2-normalised `features_only` gap feature within 1e-5, of
    unit norm; a reference checkpoint's extra entries (the two sin-cos
    tables and HF's tied MLM bias, under DDP's `module.`) change nothing."""
    x = _images(0)
    want = _jax_features(ecamp_vars["params"], x)
    got = _engine(_pretrain_pth(tmp_path, ecamp_vars))(x)
    assert got.shape == want.shape == (3, 64) and got.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=FEATURE_TOL)
    g = torch.Generator().manual_seed(0)
    extra = {"pos_embed": torch.randn(1, 5, 64, generator=g),
             "decoder_pos_embed": torch.randn(1, 5, 32, generator=g),
             "bert_encoder.model.cls.predictions.bias": torch.randn(128)}
    path = _pretrain_pth(tmp_path, ecamp_vars, extra=extra, name="ref.pth")
    ckpt = torch.load(path, weights_only=True)
    ckpt["model"] = {f"module.{k}": v for k, v in ckpt["model"].items()}
    torch.save(ckpt, path)
    np.testing.assert_array_equal(_engine(path)(x), got)


def test_int8_embedding_engine_matches_jax(tmp_path, ecamp_vars,
                                           monkeypatch):
    """`embedding_engine(quantize="int8")` against JAX's quantized apply
    (`quantize_params_int8` at the floor of 256, dequantized in the apply)
    within 1e-5; its int8 set is JAX's, the whole ECAMP's."""
    monkeypatch.setattr(pq, "MIN_ELEMS", MIN_ELEMS)
    qp = jq.quantize_params_int8(ecamp_vars["params"], min_elems=MIN_ELEMS)
    x = _images(1)
    engine = _engine(_pretrain_pth(tmp_path, ecamp_vars), quantize="int8")
    assert len(pq.quantized_modules(engine.model)) == len(qp["scales"])
    got = engine(x)
    np.testing.assert_allclose(got, _jax_features(qp, x), rtol=0,
                               atol=FEATURE_TOL)
    fp = _engine(_pretrain_pth(tmp_path, ecamp_vars, name="fp.pth"))(x)
    assert 0 < float(np.abs(got - fp).max()) < 2e-2


def test_embedding_engine_raises_on_a_missing_feature_key(tmp_path,
                                                          ecamp_vars):
    """A checkpoint without a parameter of the embedding's path raises and
    names it; one without a parameter off that path (the MAE decoder's)
    loads, and serves what the full checkpoint serves."""
    drop = ("blocks.1.attn.qkv.weight", "norm.bias", "bert_mlp.weight")
    path = _pretrain_pth(tmp_path, ecamp_vars, drop=drop, name="cut.pth")
    with pytest.raises(ValueError, match="lacks 3 parameters") as err:
        _engine(path)
    assert all(k in str(err.value) for k in drop)
    path = _pretrain_pth(tmp_path, ecamp_vars, drop=("decoder_pred.weight",),
                         name="nodec.pth")
    x = _images(2)
    np.testing.assert_array_equal(
        _engine(path)(x), _engine(_pretrain_pth(tmp_path, ecamp_vars))(x))


def test_embedding_service_answers(tmp_path, ecamp_vars):
    """`PredictionService(task="embedding")` answers a POST (one image,
    through the MicroBatcher) with `{"embedding": [...]}` of unit norm, the
    engine's embedding of the same decoded image."""
    import base64
    import io
    import json
    import urllib.request

    from PIL import Image

    from ecamp_tpu_torch.serve.http_server import PredictionService, serve

    engine = _engine(_pretrain_pth(tmp_path, ecamp_vars))
    service = PredictionService(engine, img_size=IMG, task="embedding")
    buf = io.BytesIO()
    Image.fromarray(np.random.default_rng(3).integers(
        0, 256, (40, 48, 3)).astype(np.uint8)).save(buf, "PNG")
    b64 = base64.b64encode(buf.getvalue()).decode()
    httpd = serve(service, port=0, background=True)
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/predict",
            data=json.dumps({"image": b64}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            reply = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()
    (pred,) = reply["predictions"]
    assert set(pred) == {"embedding"}
    emb = np.asarray(pred["embedding"])
    assert emb.shape == (64,)
    np.testing.assert_allclose(np.linalg.norm(emb), 1.0, atol=1e-6)
    np.testing.assert_allclose(emb, engine(service.decode([b64]))[0],
                               rtol=0, atol=1e-7)


# -- cli.export ----------------------------------------------------------

EXPORTERS = {"pretrain": "export_ecamp_pretrain",
             "classification": "export_vit_classifier",
             "segmentation": "export_seg_vit",
             "detection": "export_detector"}
KINDS = {"pretrain": "ecamp", "classification": "classifier",
         "segmentation": "segmenter", "detection": "detector"}


def _tiny_factories(monkeypatch, task):
    """`cli.export --model tiny` builds the tiny model of
    `_models(KINDS[task])`."""
    import dataclasses

    from ecamp_tpu_torch.cli import export

    vit, dec, bert = _ecamp_cfgs(pcfg)
    if task != "pretrain":
        vit = _vit(pcfg) if task == "classification" else _vit(pcfg, 32, 16)
    monkeypatch.setitem(export._VIT_FACTORY, "tiny",
                        lambda **kw: dataclasses.replace(vit, **kw))
    monkeypatch.setattr(export.cfg, "MAEDecoderConfig", lambda: dec)
    monkeypatch.setattr(export.cfg, "BertConfig", lambda: bert)


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


@pytest.mark.parametrize("task", list(EXPORTERS))
def test_export_writes_the_jax_exporters_layout(tmp_path, monkeypatch, task):
    """`cli.export` on a `.pth` of the port's own layout (the pretrain CLI's
    {'model', 'optimizer', 'epoch'}; a fine-tune CLI's {'model'}) writes
    what the JAX exporter writes from the same flax variables: the same
    top-level layout, key set, dtypes (fp32) and bit-equal values; the JAX
    importer reads it back to the original params and batch statistics."""
    from ecamp_tpu_torch.cli import export

    v, port = _init(KINDS[task])
    want_path = str(tmp_path / "jax.pth")
    getattr(jexport, EXPORTERS[task])(
        v, want_path, **({"epoch": 3} if task == "pretrain" else {}))
    src = str(tmp_path / "port.pth")
    state = state_dict_from_flax(v["params"], v.get("batch_stats"))
    torch.save({"model": state, "optimizer": {"state": {}}, "epoch": 3}
               if task == "pretrain" else {"model": state}, src)
    _tiny_factories(monkeypatch, task)
    out = str(tmp_path / "out.pth")
    n_classes = {"classification": "3", "detection": "1"}.get(task, "14")
    export.main(["--task", task, "--checkpoint", src, "--output", out,
                 "--model", "tiny", "--img_size", str(IMG),
                 "--num_classes", n_classes])
    got, want = _load(out), _load(want_path)
    if task == "pretrain":
        assert set(got) == set(want) == {"model", "epoch"}
        assert got["epoch"] == want["epoch"] == 3
        got, want = got["model"], want["model"]
    assert set(got) == set(want)
    for k, t in want.items():
        assert got[k].dtype == t.dtype == torch.float32, k
        assert torch.equal(got[k], t), k
    importer = {"pretrain": jimport.import_ecamp_pretrain,
                "classification": jimport.import_vit_classifier,
                "segmentation": lambda t, p: jimport.import_seg_vit(
                    t, p, from_pretrain=False),
                "detection": lambda t, p: jimport.import_detector(
                    t, p, from_pretrain=False)}[task]
    template = jax.tree_util.tree_map(np.zeros_like, v)
    back, _, _ = importer(template, out)
    flat_b, flat_v = jimport.flatten(back), jimport.flatten(v)
    assert set(flat_b) == set(flat_v)
    for path, val in flat_v.items():
        np.testing.assert_array_equal(np.asarray(flat_b[path]), val,
                                      err_msg=str(path))


def test_export_epoch_and_refusals(tmp_path, monkeypatch):
    """`--epoch` overrides the checkpoint's; a checkpoint without one
    writes none, as the JAX exporter with `epoch=None`; an orbax directory
    and a checkpoint of another model raise."""
    from ecamp_tpu_torch.cli import export

    vp, _ = _init("ecamp")
    state = state_dict_from_flax(vp["params"])
    src = str(tmp_path / "port.pth")
    out = str(tmp_path / "out.pth")
    _tiny_factories(monkeypatch, "pretrain")
    for saved, flag, want in (({"epoch": 3}, ["--epoch", "7"], 7),
                              ({}, [], None)):
        torch.save({"model": state, **saved}, src)
        export.main(["--task", "pretrain", "--checkpoint", src, "--output",
                     out, "--model", "tiny", *flag])
        assert _load(out).get("epoch") == want
        assert set(_load(out)) == ({"model", "epoch"} if want else {"model"})
    with pytest.raises(ValueError, match="orbax directory"):
        export.main(["--task", "pretrain", "--checkpoint", str(tmp_path),
                     "--output", out, "--model", "tiny"])
    torch.save({"model": state_dict_from_flax(_init("classifier")[0][
        "params"])}, src)
    with pytest.raises(RuntimeError, match="Missing key"):
        export.main(["--task", "pretrain", "--checkpoint", src, "--output",
                     out, "--model", "tiny"])
