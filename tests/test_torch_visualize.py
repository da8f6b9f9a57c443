"""The port's visualizer (ecamp_tpu_torch.cli.visualize, and the
cross-attention probabilities it reads through `ECAMP(...,
return_cross_probs=True)`) against the JAX package's, on the CPU, at the
tiny configuration of `tests/test_ecamp_import.py` (ViT img 32, patch 16,
dim 64, depth 2; decoder 32/1; BERT 64 wide, 2 layers, 2 heads, 16
positions), fp32.

Weights go JAX init -> `state_dict_from_flax` -> `load_state_dict` for
the model (a JAX init at mask_ratio 0 has no decoder), and one seeded reference-layout `.pth` read by both CLIs
for the end-to-end run. The JAX package returns the probabilities through
its XLA attention (`return_probs=True`), the port through its plain
attention; every other attention and LayerNorm runs its plain version on
the CPU.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(__file__))

from test_cli_pretrain_viz import _make_tokenizer_json  # noqa: E402
from test_ecamp_import import (BERT, DEC, VIT,  # noqa: E402
                               _reference_state_dict)

from ecamp_tpu.cli import visualize as jax_viz  # noqa: E402
from ecamp_tpu.nn import ECAMP as JaxECAMP  # noqa: E402
from ecamp_tpu_torch.ckpt import state_dict_from_flax  # noqa: E402
from ecamp_tpu_torch.cli import visualize  # noqa: E402
from ecamp_tpu_torch.core import config as pcfg  # noqa: E402
from ecamp_tpu_torch.nn.mae import ECAMP  # noqa: E402

L = BERT.max_position_embeddings


def _port_cfgs():
    """The port's counterparts of the tiny VIT, DEC and BERT."""
    return tuple(
        cls(**{k: v for k, v in c.__dict__.items()
               if k in cls.__dataclass_fields__})
        for cls, c in ((pcfg.ViTConfig, VIT), (pcfg.MAEDecoderConfig, DEC),
                       (pcfg.BertConfig, BERT)))


def _batch(seed, n=2, img=32):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, BERT.vocab_size, (n, L)).astype(np.int32)
    mask = np.ones((n, L), np.int32)
    mask[0, 9:] = 0  # a padded report
    return {"image": rng.normal(size=(n, img, img, 3)).astype(np.float32),
            "ids": ids, "attention_mask": mask,
            "type_ids": np.zeros((n, L), np.int32)}


@pytest.fixture(scope="module")
def jax_params():
    model = JaxECAMP(vit=VIT, decoder=DEC, bert=BERT)
    b = _batch(0)
    v = jax.jit(lambda r: model.init(
        {"params": r}, {k: jnp.asarray(x) for k, x in b.items()},
        mask_ratio=0.0, deterministic=True))(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, v["params"])


def _port_from(params, **kw):
    """The port's ECAMP with JAX's weights; a JAX init at mask_ratio 0
    builds no decoder, mask token or SR head, so those keep the port's."""
    port = ECAMP(*_port_cfgs(), **kw)
    res = port.load_state_dict(state_dict_from_flax(params), strict=False)
    assert not res.unexpected_keys
    assert res.missing_keys and all(k.startswith(
        ("decoder_", "mask_token", "super_res.")) for k in res.missing_keys)
    return port.eval()


@pytest.mark.parametrize("img", [32, 64], ids=["encoder_size", "resized"])
def test_cross_probs_match_jax(jax_params, img):
    """`ECAMP(return_cross_probs=True)`'s cross_attention (N, H, L_text,
    grid^2) within 1e-6 of JAX's (probabilities, so absolute), each row
    summing to 1, and the MLM logits within 1e-5 of their scale: the
    image at the encoder's size (the visualizer's path, no resize) and
    one the model resizes."""
    batch = _batch(1, img=img)
    model = JaxECAMP(vit=VIT, decoder=DEC, bert=BERT)
    out_j = model.apply({"params": jax_params},
                        {k: jnp.asarray(x) for k, x in batch.items()},
                        mask_ratio=0.0, deterministic=True,
                        return_cross_probs=True)
    port = _port_from(jax_params)
    with torch.no_grad():
        out = port({k: torch.from_numpy(x) for k, x in batch.items()},
                   mask_ratio=0.0, return_cross_probs=True)
    probs, want = out["cross_attention"].numpy(), np.asarray(
        out_j["cross_attention"])
    assert probs.shape == want.shape == (2, BERT.num_attention_heads, L,
                                         VIT.grid_size ** 2)
    assert probs.dtype == np.float32
    np.testing.assert_allclose(probs, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=0, atol=1e-6)
    logits, want_l = out["mlm_logits"].numpy(), np.asarray(
        out_j["mlm_logits"])
    scale = float(np.abs(want_l).max())
    np.testing.assert_allclose(logits, want_l, rtol=0, atol=1e-5 * scale)


def test_fused_ce_is_off_with_the_probs(jax_params):
    """Asking for the probabilities turns the fused CE off: with labels
    and weights the MLM loss comes from the materialised logits (JAX's
    rule), equal to the run without the probabilities and the fused CE."""
    batch = _batch(2)
    rng = np.random.default_rng(3)
    batch["labels"] = rng.integers(0, BERT.vocab_size, (2, L))
    batch["weights"] = rng.random((2, L)).astype(np.float32)
    outs = []
    for fused, probs in ((True, True), (False, False)):
        port = _port_from(jax_params, fused_mlm_ce=fused)
        with torch.no_grad():
            outs.append(port({k: torch.from_numpy(x)
                              for k, x in batch.items()}, mask_ratio=0.0,
                             return_cross_probs=probs))
    assert "mlm_logits" in outs[0] and "cross_attention" in outs[0]
    assert float(outs[0]["mlm_loss"]) == float(outs[1]["mlm_loss"])


def test_heatmap_and_colormap_match_jax():
    """`heatmap_from_row` (max over heads, ^0.25, min-max, bilinear to
    224 with half-pixel centres) within 1e-5 of the JAX CLI's
    (`jax.image.resize`), at the full model's 14^2 grid and a 2^2 one;
    `jet_colormap` equal to the JAX CLI's."""
    rng = np.random.default_rng(4)
    for heads, grid in ((12, 14), (2, 2)):
        row = rng.dirichlet(np.ones(grid * grid), heads).astype(np.float32)
        got = visualize.heatmap_from_row(torch.from_numpy(row))
        want = np.asarray(jax_viz.heatmap_from_row(row))
        assert got.shape == want.shape == (224, 224)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        assert 0.0 <= got.min() < got.max() <= 1.0
    x = np.linspace(-0.1, 1.1, 1001).reshape(7, 143)
    np.testing.assert_array_equal(visualize.jet_colormap(x),
                                  jax_viz.jet_colormap(x))


def test_cli_matches_jax(tmp_path, monkeypatch, capsys):
    """Both CLIs end to end on one synthetic reference `.pth` (written with
    the visualization checkpoints' `cross_attn_layer` names), one PNG and
    one tokenizer, at the tiny configs: the gray originals equal, the
    blended heatmaps within 1 grey level."""
    tok = tmp_path / "wp.json"
    _make_tokenizer_json(tok)
    g = torch.Generator().manual_seed(0)
    sd = {k.replace("context_fusion_layer", "cross_attn_layer"): 0.2 * v
          for k, v in _reference_state_dict(g).items()}
    ckpt = str(tmp_path / "tiny.pth")
    torch.save({"model": sd}, ckpt)
    img = tmp_path / "x.png"
    Image.fromarray(np.random.default_rng(5).integers(
        0, 255, (100, 120, 3)).astype(np.uint8)).save(img)

    vit, dec, bert = _port_cfgs()
    for mod, (v, d, b) in ((jax_viz.cfg, (VIT, DEC, BERT)),
                           (visualize.cfg, (vit, dec, bert))):
        monkeypatch.setattr(mod, "ViTConfig", lambda v=v: v)
        monkeypatch.setattr(mod, "MAEDecoderConfig", lambda d=d: d)
        monkeypatch.setattr(mod, "BertConfig", lambda b=b: b)

    def args(tag):
        return ["--image", str(img), "--text", "no evidence of pneumonia",
                "--checkpoint", ckpt, "--tokenizer", str(tok),
                "--token_index", "3",
                "--output", str(tmp_path / f"{tag}_heat.png"),
                "--save_original", str(tmp_path / f"{tag}_orig.png")]

    monkeypatch.setattr(sys, "argv", ["visualize"] + args("jax"))
    jax_viz.main()
    amap = visualize.main(args("port") + ["--device", "cpu"])
    printed = capsys.readouterr().out
    assert f"wrote {tmp_path / 'port_heat.png'}" in printed
    # every tensor of the tiny model but the two sin-cos tables and HF's
    # tied decoder bias
    n_loaded = sum(1 for k in sd if k not in (
        "pos_embed", "decoder_pos_embed",
        "bert_encoder.model.cls.predictions.bias"))
    assert f"loaded {n_loaded} tensors from {ckpt}" in printed
    assert amap.shape == (224, 224) and 0.0 <= amap.min() <= amap.max() <= 1
    orig = [np.asarray(Image.open(tmp_path / f"{t}_orig.png"))
            for t in ("jax", "port")]
    np.testing.assert_array_equal(orig[0], orig[1])
    heat = [np.asarray(Image.open(tmp_path / f"{t}_heat.png")).astype(int)
            for t in ("jax", "port")]
    assert heat[0].shape == heat[1].shape == (224, 224, 3)
    assert int(np.abs(heat[0] - heat[1]).max()) <= 1
    assert heat[1].std() > 0  # a map, not a flat image


def test_cli_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        visualize.main(["--image", "x", "--text", "t", "--checkpoint", "c",
                        "--tokenizer", "w"])
