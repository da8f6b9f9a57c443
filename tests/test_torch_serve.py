"""The port's serving layer (ecamp_tpu_torch.serve, .cli.serve) on the CPU:
bucketed engine, micro-batcher, HTTP front-end and CLI, compared with the
JAX engine's outputs on the same weights (mirrors tests/test_serve.py)."""

import base64
import io
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ecamp_tpu.core import config as jcfg  # noqa: E402
from ecamp_tpu.core.mesh import make_mesh  # noqa: E402
from ecamp_tpu.serve.engine import InferenceEngine as JaxEngine  # noqa: E402
from ecamp_tpu_torch.ckpt import state_dict_from_flax  # noqa: E402
from ecamp_tpu_torch.core import ViTConfig  # noqa: E402
from ecamp_tpu_torch.nn import ViTClassifier  # noqa: E402
from ecamp_tpu_torch.serve.engine import (InferenceEngine,  # noqa: E402
                                          MicroBatcher, sigmoid_np)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4)
N_CLASSES = 3


def _engines(buckets=(4, 8), postprocess=None):
    """(port engine on cpu, JAX engine) serving the same tiny classifier."""
    from ecamp_tpu.nn import ViTClassifier as JaxViTClassifier

    jm = JaxViTClassifier(jcfg.ViTConfig(**KW), N_CLASSES, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, 32, 32, 3)))["params"]
    rng = np.random.default_rng(11)  # widen the tiny head init
    params["head"]["kernel"] = jnp.asarray(
        rng.normal(0, 0.3, params["head"]["kernel"].shape), jnp.float32)
    jeng = JaxEngine(lambda p, x: jm.apply({"params": p}, x), params,
                     mesh=make_mesh(jcfg.MeshConfig(data=1),
                                    devices=jax.devices()[:1]),
                     buckets=buckets, postprocess=postprocess)
    model = ViTClassifier(ViTConfig(**KW), N_CLASSES)
    model.load_state_dict(state_dict_from_flax(params), strict=True)
    model.eval()
    eng = InferenceEngine(lambda x: model(x).float(), buckets=buckets,
                          postprocess=postprocess, device="cpu")
    return eng, jeng


def _x(seed, n):
    return np.random.default_rng(seed).normal(size=(n, 32, 32, 3)).astype(
        np.float32)


def test_engine_bucketing_matches_jax_engine():
    eng, jeng = _engines()
    for n in (1, 3, 4, 8, 19):  # pad, exact, chunked
        x = _x(n, n)
        np.testing.assert_allclose(eng(x), jeng(x), rtol=1e-4, atol=1e-5)
    s = eng.stats()
    assert s["requests"] == 1 + 3 + 4 + 8 + 19
    assert s["buckets"] == [4, 8]
    # n=1,3,4 -> bucket 4 (x3); n=8 -> 8; n=19 -> chunks 8+8+3 (8, 8, 4)
    assert s["bucket_hits"] == {"4": 4, "8": 3}
    assert s["calls"] == 5 and s["latency_ms_p99"] >= s["latency_ms_p50"] > 0


def test_engine_empty_batch_and_postprocess():
    eng, jeng = _engines(postprocess=sigmoid_np)
    out = eng(np.zeros((0, 32, 32, 3), np.float32))
    assert out.shape == (0, N_CLASSES) and out.dtype == np.float32
    x = _x(1, 2)
    np.testing.assert_allclose(eng(x), jeng(x), rtol=1e-4, atol=1e-5)
    assert ((eng(x) > 0) & (eng(x) < 1)).all()
    with pytest.raises(ValueError):
        InferenceEngine(lambda x: x, buckets=(), device="cpu")


def test_engine_bf16_input_cast():
    model = ViTClassifier(ViTConfig(**KW), N_CLASSES, dtype=torch.bfloat16,
                          generator=torch.Generator().manual_seed(0)).eval()
    seen = []

    def fn(x):
        seen.append(x.dtype)
        return model(x).float()

    eng = InferenceEngine(fn, buckets=(2, 4), input_dtype=torch.bfloat16,
                          device="cpu")
    eng.warmup(_x(2, 1))  # one call per bucket, not counted in the stats
    assert seen == [torch.bfloat16] * 2
    assert eng.stats()["calls"] == 0
    assert eng(_x(2, 3)).shape == (3, N_CLASSES)
    assert seen == [torch.bfloat16] * 3


def test_microbatcher_coalesces_and_matches():
    eng, jeng = _engines()
    mb = MicroBatcher(eng, max_batch=8, max_wait_ms=50.0)
    xs = _x(1, 6)
    futs = [mb.submit(x) for x in xs]
    outs = np.stack([f.result(timeout=30) for f in futs])
    np.testing.assert_allclose(outs, jeng(xs), rtol=1e-4, atol=1e-5)
    assert eng.stats()["calls"] < 6  # concurrent submits shared calls
    mb.close()
    assert not mb._worker.is_alive()
    with pytest.raises(RuntimeError):
        mb.submit(xs[0])


def test_microbatcher_survives_bad_sample():
    eng, jeng = _engines()
    mb = MicroBatcher(eng, max_batch=2, max_wait_ms=20.0)
    try:
        bad = mb.submit(np.zeros((7, 7), np.float32))
        with pytest.raises(Exception):
            bad.result(timeout=30)
        x = _x(3, 1)
        out = mb.submit(x[0]).result(timeout=30)
        np.testing.assert_allclose(out, jeng(x)[0], rtol=1e-4, atol=1e-5)
    finally:
        mb.close()


def _png(value, size=40):
    from PIL import Image

    buf = io.BytesIO()
    img = np.random.default_rng(value).integers(0, 256, (size, size + 8, 3))
    Image.fromarray(img.astype(np.uint8)).save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _post(base, body: bytes):
    req = urllib.request.Request(f"{base}/predict", data=body,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


def test_http_server_end_to_end():
    from ecamp_tpu.serve.http_server import PredictionService as JaxService
    from ecamp_tpu_torch.serve.http_server import PredictionService, serve

    eng, jeng = _engines(postprocess=sigmoid_np)
    service = PredictionService(eng, img_size=32,
                                class_names=["a", "b", "c"])
    jservice = JaxService(jeng, "classification", img_size=32,
                          micro_batch=False)
    httpd = serve(service, port=0, background=True)
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.load(r) == {"status": "ok"}
        # one image (through the MicroBatcher) and a batch of 5
        for imgs in ([_png(0)], [_png(i) for i in range(1, 6)]):
            body = ({"image": imgs[0]} if len(imgs) == 1
                    else {"images": imgs})
            code, reply = _post(base, json.dumps(body).encode())
            assert code == 200
            preds = reply["predictions"]
            assert len(preds) == len(imgs)
            assert all(set(p["labels"]) == {"a", "b", "c"} for p in preds)
            probs = np.asarray([p["probs"] for p in preds])
            want = np.asarray([p["probs"] for p in
                               jservice.predict_b64(imgs)])
            np.testing.assert_allclose(probs, want, rtol=1e-4, atol=1e-5)
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
            stats = json.load(r)
        assert stats["requests"] == 6
        assert sum(stats["bucket_hits"].values()) == 2
        # malformed request body / undecodable image -> 400 (client fault)
        assert _post(base, b"{not json")[0] == 400
        assert _post(base, json.dumps({"image": "AAAA"}).encode())[0] == 400
        with pytest.raises(urllib.error.HTTPError, match="404"):
            urllib.request.urlopen(f"{base}/nothing", timeout=30)
        # internal failure -> 500, error detail not leaked to the client
        service.predict = lambda xs: (_ for _ in ()).throw(
            RuntimeError("/secret/device/path exploded"))
        code, reply = _post(base, json.dumps({"image": _png(9)}).encode())
        assert code == 500 and "secret" not in json.dumps(reply)
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()
        jservice.close()


@pytest.mark.parametrize("bf16", [False, True])
def test_classifier_engine_from_pth_matches_jax(tmp_path, bf16):
    """A .pth written by the JAX exporter serves the same probabilities
    through both packages' classifier_engine."""
    from ecamp_tpu.ckpt.torch_export import export_vit_classifier
    from ecamp_tpu.nn import ViTClassifier as JaxViTClassifier
    from ecamp_tpu.serve.loaders import classifier_engine as jax_engine
    from ecamp_tpu_torch.serve import classifier_engine

    vcfg = jcfg.ViTConfig(**KW)
    variables = JaxViTClassifier(vcfg, N_CLASSES).init(
        jax.random.PRNGKey(3), jnp.zeros((2, 32, 32, 3)))
    variables["params"]["head"]["kernel"] = jnp.asarray(
        np.random.default_rng(12).normal(
            0, 0.3, variables["params"]["head"]["kernel"].shape), jnp.float32)
    pth = str(tmp_path / "cls.pth")
    export_vit_classifier(variables, pth)
    mesh = make_mesh(jcfg.MeshConfig(data=1), devices=jax.devices()[:1])
    want = jax_engine(pth, num_classes=N_CLASSES, img_size=32, vit=vcfg,
                      buckets=(4,), bf16=bf16, mesh=mesh)
    got = classifier_engine(pth, num_classes=N_CLASSES, img_size=32,
                            vit=ViTConfig(**KW), buckets=(4,), bf16=bf16,
                            device="cpu")
    assert got.model.dtype == (torch.bfloat16 if bf16 else torch.float32)
    x = _x(5, 6)
    tol = dict(atol=5e-2) if bf16 else dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got(x), want(x), **tol)
    single = classifier_engine(pth, num_classes=N_CLASSES, img_size=32,
                               vit=ViTConfig(**KW), buckets=(4,),
                               multilabel=False, bf16=bf16, device="cpu")
    np.testing.assert_allclose(single(x).sum(-1), 1.0, rtol=1e-5)


def test_classifier_engine_rejects_orbax_dir(tmp_path):
    from ecamp_tpu_torch.serve import classifier_engine

    with pytest.raises(ValueError, match="orbax"):
        classifier_engine(str(tmp_path), device="cpu")


def _cli(args, tmp_path):
    from ecamp_tpu_torch.cli.serve import main

    return main(["--task", "classification", "--num_classes", "3",
                 "--img_size", "32", "--buckets", "4", *args])


def test_cli_batch_mode_writes_jsonl(tmp_path):
    from PIL import Image

    from ecamp_tpu_torch.cli.serve import iter_paths

    imgdir = tmp_path / "imgs"
    imgdir.mkdir()
    for i in range(5):
        Image.fromarray(np.full((40, 44, 3), 40 * i, np.uint8)).save(
            imgdir / f"im{i}.png")
    (tmp_path / "list.txt").write_text(
        f"{imgdir}/im0.png extra cols\n\n{imgdir}/im2.png\n")
    assert len(list(iter_paths(str(imgdir)))) == 5
    assert list(iter_paths(str(tmp_path / "list.txt"))) == [
        f"{imgdir}/im0.png", f"{imgdir}/im2.png"]
    out = tmp_path / "preds.jsonl"
    _cli(["--device", "cpu", "--images", str(imgdir), "--output", str(out),
          "--batch_size", "3", "--class_names", "a", "b", "c"], tmp_path)
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [os.path.basename(r["path"]) for r in rows] == [
        f"im{i}.png" for i in range(5)]
    assert all(len(r["probs"]) == 3 and set(r["labels"]) == {"a", "b", "c"}
               and all(0.0 <= p <= 1.0 for p in r["probs"]) for r in rows)


def _tiny_loaders(monkeypatch):
    """The serve CLI's engines at a tiny size (ViT img 32, patch 16, dim
    64, depth 2; ECAMP with a 1-layer BERT), int8 at a floor of 256
    elements (the default 65536 picks nothing of them)."""
    from ecamp_tpu_torch.core import config as pc
    from ecamp_tpu_torch.serve import loaders, quantize

    monkeypatch.setattr(loaders, "ViTConfig", lambda img_size: ViTConfig(
        img_size=img_size, patch_size=16, embed_dim=64, depth=2, num_heads=4))
    monkeypatch.setattr(loaders, "MAEDecoderConfig", lambda: (
        pc.MAEDecoderConfig(embed_dim=32, depth=1, num_heads=2)))
    monkeypatch.setattr(loaders, "BertConfig", lambda: pc.BertConfig(
        vocab_size=128, hidden_size=64, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=128,
        max_position_embeddings=16))
    monkeypatch.setattr(quantize, "MIN_ELEMS", 256)


@pytest.mark.parametrize("task,quantize", [
    ("classification", "int8"), ("segmentation", "int8"),
    ("detection", "int8"), ("embedding", ""), ("embedding", "int8")])
def test_cli_int8_and_embedding_batch_mode(tmp_path, monkeypatch, task,
                                           quantize):
    """`--quantize int8` builds every task's engine with int8 weights and
    `--task embedding` the ECAMP embedding engine; batch mode writes one
    row an image: {"path", "embedding"} of unit norm for the embedding."""
    from PIL import Image

    from ecamp_tpu_torch.cli.serve import batch_predict, build_engine, get_args
    from ecamp_tpu_torch.serve.quantize import quantized_modules

    _tiny_loaders(monkeypatch)
    imgdir = tmp_path / "imgs"
    imgdir.mkdir()
    for i in range(3):
        Image.fromarray(np.full((40, 36, 3), 50 * i, np.uint8)).save(
            imgdir / f"im{i}.png")
    out = tmp_path / "rows.jsonl"
    args = get_args(["--task", task, "--img_size", "32", "--buckets", "4",
                     "--device", "cpu", "--images", str(imgdir), "--output",
                     str(out)] + (["--quantize", quantize] if quantize
                                  else []))
    engine = build_engine(args)
    assert bool(quantized_modules(engine.model)) == (quantize == "int8")
    batch_predict(args, engine)
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [os.path.basename(r["path"]) for r in rows] == [
        f"im{i}.png" for i in range(3)]
    key = {"classification": "probs", "segmentation": "area_fraction",
           "detection": "boxes", "embedding": "embedding"}[task]
    assert all(key in r for r in rows)
    if task == "embedding":
        emb = np.asarray([r["embedding"] for r in rows])
        assert emb.shape == (3, 64)
        np.testing.assert_allclose(np.linalg.norm(emb, axis=-1), 1.0,
                                   atol=1e-6)


def test_cli_embedding_service_answers(tmp_path, monkeypatch):
    """The serve CLI's int8 embedding engine behind the HTTP service
    answers a POST of two images with two unit-norm embeddings."""
    from ecamp_tpu_torch.cli.serve import build_engine, get_args
    from ecamp_tpu_torch.serve.http_server import PredictionService, serve

    _tiny_loaders(monkeypatch)
    engine = build_engine(get_args(["--task", "embedding", "--img_size",
                                    "32", "--buckets", "4", "--device",
                                    "cpu", "--quantize", "int8"]))
    service = PredictionService(engine, img_size=32, task="embedding")
    httpd = serve(service, port=0, background=True)
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        code, reply = _post(base, json.dumps(
            {"images": [_png(1), _png(2)]}).encode())
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()
    assert code == 200
    emb = np.asarray([p["embedding"] for p in reply["predictions"]])
    assert emb.shape == (2, 64)
    np.testing.assert_allclose(np.linalg.norm(emb, axis=-1), 1.0, atol=1e-6)


def test_cli_refuses_what_is_not_ported(tmp_path):
    for task in ("classification", "segmentation", "detection",
                 "embedding"):
        with pytest.raises(ValueError, match="orbax directory"):
            _cli(["--device", "cpu", "--checkpoint", str(tmp_path),
                  "--task", task], tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA card"):
            _cli([], tmp_path)  # --device cuda is the default


def test_port_imports_no_jax():
    """Every ecamp_tpu_torch module imports with jax, flax, the JAX package,
    pandas and cv2 (not among the card machine's packages) blocked."""
    code = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "flax", "optax", "orbax", "ecamp_tpu",
                   "pandas", "cv2"):
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, Block())
import ecamp_tpu_torch
names = [m.name for m in pkgutil.walk_packages(ecamp_tpu_torch.__path__,
                                               "ecamp_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "flax", "ecamp_tpu", "pandas", "cv2")]
assert not bad, bad
print(len(names), *names)
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    names = r.stdout.split()
    assert int(names[0]) >= 15
    assert {"ecamp_tpu_torch.nn.resnet", "ecamp_tpu_torch.nn.unet",
            "ecamp_tpu_torch.cli.visualize", "ecamp_tpu_torch.cli.export",
            "ecamp_tpu_torch.serve.quantize",
            "ecamp_tpu_torch.kernels.int8_linear",
            "ecamp_tpu_torch.core.presets", "ecamp_tpu_torch.core.preemption",
            "ecamp_tpu_torch.cli.run_preset", "ecamp_tpu_torch.cli.common",
            "ecamp_tpu_torch.data.preprocess",
            "ecamp_tpu_torch.data.split_tools"} <= set(names[1:])
