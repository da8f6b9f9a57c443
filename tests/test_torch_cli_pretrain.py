"""The port's pretraining entry point and what it needs, on the CPU:

  * the data pipeline (`PretrainReportDataset` + thread `DataLoader`)
    against `ecamp_tpu.data`'s on a seeded MIMIC-style corpus: every array
    of two epochs bit-identical (the JAX package's C++ host library is
    switched off, so both run their PIL / pure-Python paths);
  * `python -m ecamp_tpu_torch.cli.pretrain --device cpu --fused_mlm_ce`
    at a tiny size for 2 epochs, then resumed for a third from its
    `checkpoint-1.pth`;
  * that checkpoint read by the JAX package's reference-checkpoint
    importers into a tiny JAX ECAMP, with equal parameters and moments.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ecamp_tpu_torch.cli import pretrain as cli  # noqa: E402
from ecamp_tpu_torch.cli.common import pretrain_ckpt_epochs  # noqa: E402
from ecamp_tpu_torch.core import config as pcfg  # noqa: E402
from ecamp_tpu_torch.data.synthetic import write_mimic_corpus  # noqa: E402
from test_cli_pretrain_viz import _make_tokenizer_json  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = os.path.join(REPO, "ecamp_tpu", "assets", "mimic_wordpiece.json")


def _tiny_kw(lib):
    """The tiny model of the JAX package's pretrain CLI tests
    (tests/test_cli_pretrain_viz.py:89-96)."""
    return dict(
        vit=lib.ViTConfig(img_size=32, patch_size=16, embed_dim=32, depth=1,
                          num_heads=2),
        decoder=lib.MAEDecoderConfig(embed_dim=16, depth=1, num_heads=2),
        bert=lib.BertConfig(vocab_size=32, hidden_size=32,
                            num_hidden_layers=1, num_attention_heads=2,
                            intermediate_size=64, max_position_embeddings=16),
        sr_window=1, max_caption_length=16)


@pytest.mark.parametrize("u8", [False, True], ids=["f32", "u8_pipe"])
def test_data_pipeline_matches_jax_bitwise(tmp_path, monkeypatch, u8):
    from ecamp_tpu.data import native
    from ecamp_tpu.data.datasets import PretrainReportDataset as JaxDataset
    from ecamp_tpu.data.loader import DataLoader as JaxLoader
    from ecamp_tpu_torch.data.datasets import PretrainReportDataset
    from ecamp_tpu_torch.data.loader import DataLoader

    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", True)
    root = write_mimic_corpus(str(tmp_path / "mimic"), VOCAB, n_images=10,
                              img_size=80, max_window_start=2, seed=3)
    jds = JaxDataset(root, img_size=64, max_caption_length=64, seed=7,
                     image_dtype=np.uint8 if u8 else np.float32)
    pds = PretrainReportDataset(root, img_size=64, max_caption_length=64,
                                seed=7, output_u8=u8)
    jl = JaxLoader(jds, batch_size=3, seed=7, num_workers=2)
    pl = DataLoader(pds, batch_size=3, seed=7, num_workers=2)
    assert len(jl) == len(pl) == 3
    masked = 0
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        want, got = list(jl), list(pl)
        assert len(want) == len(got) == 3
        for a, b in zip(want, got):
            assert set(a) == set(b)
            for k in a:
                assert b[k].dtype == a[k].dtype, k
                np.testing.assert_array_equal(b[k], a[k], err_msg=k)
            masked += int((a["ids"] == 3).sum())
            assert a["image"].shape[1:] == ((64, 64, 1) if u8 else (64, 64, 3))
    assert masked > 0  # entity masking acted
    # the same loader again gives the same batches (a pure function of
    # seed, epoch, workers and index)
    again = list(pl)
    for a, b in zip(got, again):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """The CLI for 2 epochs, then resumed for a third; returns the output
    dir and what the resume printed."""
    tmp = tmp_path_factory.mktemp("cli")
    vocab = tmp / "tiny_wordpiece.json"
    _make_tokenizer_json(vocab)
    root = write_mimic_corpus(str(tmp / "mimic"), str(vocab), n_images=8,
                              img_size=96, max_window_start=1, seed=0)
    out = tmp / "out"
    orig = pcfg.PretrainConfig

    def tiny_config(**kw):
        return orig(**dict(kw, **_tiny_kw(pcfg)))

    base = ["--data_path", root, "--batch_size", "4", "--max_epoch", "4",
            "--warmup_epochs", "1", "--input_size", "64",
            "--max_caption_length", "16", "--num_workers", "2",
            "--output_dir", str(out), "--no_bf16", "--print_freq", "1",
            "--device", "cpu", "--fused_mlm_ce"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli.cfg, "PretrainConfig", tiny_config)
        cli.main(base + ["--epochs", "2"])
        first = (out / "log.txt").read_text()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(base + ["--epochs", "3", "--resume",
                             str(out / "checkpoint-1.pth")])
    return out, first, buf.getvalue()


def test_cli_trains_checkpoints_and_resumes(cli_run):
    out, first, printed = cli_run
    recs = [json.loads(line) for line in first.splitlines()]
    assert [r["epoch"] for r in recs] == [0, 1]
    for r in recs:
        for k in ("loss", "mim_loss", "res_loss", "mlm_loss", "lr"):
            assert np.isfinite(r[k]), k
        assert r["max_mem_mb"] == 0.0  # no card
        assert set(r["kernel_launches"]) >= {"fused_ce_fwd", "fused_ce_dx",
                                             "fused_ce_dw", "adamw"}
        assert not any(r["kernel_launches"].values())  # plain on the CPU
    assert (out / "args.json").exists()
    assert (out / "code" / "ecamp_tpu_torch" / "cli" / "pretrain.py").exists()

    # the resume: epoch, moments and step restored, one epoch trained
    assert "restored AdamW moments" in printed and "(torch step 4)" in printed
    assert "resuming at epoch 2" in printed
    epochs = [json.loads(line)["epoch"]
              for line in (out / "log.txt").read_text().splitlines()]
    assert epochs == [0, 1, 2]
    c1 = torch.load(out / "checkpoint-1.pth", weights_only=True)
    c2 = torch.load(out / "checkpoint-2.pth", weights_only=True)
    assert (c1["epoch"], c2["epoch"]) == (1, 2)
    assert (out / "checkpoint-0.pth").exists()  # the cadence's epoch 0
    steps = {int(s["step"]) for s in c2["optimizer"]["state"].values()}
    assert steps == {6}  # 4 restored + 2 of the third epoch
    assert set(c2["model"]) == set(c1["model"])
    assert any(not torch.equal(c1["model"][k], c2["model"][k])
               for k in c1["model"])


def test_cli_refuses_what_is_not_ported(tmp_path):
    base = ["--data_path", str(tmp_path), "--device", "cpu"]
    for extra, msg in ((["--accum_iter", "2"], "accum_iter"),
                       (["--steps_per_call", "2"], "steps_per_call"),
                       (["--shard_optimizer"], "shard_optimizer"),
                       (["--fsdp"], "fsdp"),
                       (["--rss_limit_gb", "8"], "rss_limit_gb"),
                       (["--resume", str(tmp_path)], "orbax")):
        with pytest.raises(NotImplementedError, match=msg):
            cli.main(base + extra)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            cli.main(["--data_path", str(tmp_path)])
    assert pretrain_ckpt_epochs(3) == {0, 2}
    assert pretrain_ckpt_epochs(120) == (
        {0, 60, 70, 80, 90} | set(range(100, 120, 5)) | {119})


def test_cli_checkpoint_reads_into_jax(cli_run):
    """checkpoint-2.pth through `import_ecamp_pretrain` and
    `import_ecamp_adamw_state` into a tiny JAX ECAMP: every parameter and
    both moments of every parameter equal the port's."""
    import jax

    from ecamp_tpu.ckpt.torch_import import (import_ecamp_adamw_state,
                                             import_ecamp_pretrain, load_pth)
    from ecamp_tpu.core import config as jcfg
    from ecamp_tpu.core.mesh import make_mesh
    from ecamp_tpu.train.pretrain import PretrainTask as JaxPretrainTask
    from ecamp_tpu_torch.ckpt import state_dict_from_flax

    out = cli_run[0]
    path = str(out / "checkpoint-2.pth")
    ckpt = torch.load(path, weights_only=True)
    cfg = jcfg.PretrainConfig(data=jcfg.DataConfig(img_size=64),
                              mesh=jcfg.MeshConfig(data=1), **_tiny_kw(jcfg))
    task = JaxPretrainTask(cfg, mesh=make_mesh(cfg.mesh,
                                               devices=jax.devices()[:1]))
    variables = jax.jit(lambda r: task.model.init(
        {"params": r, "masking": jax.random.fold_in(r, 1)},
        task.fake_batch(2), mask_ratio=cfg.mask_ratio,
        deterministic=True))(jax.random.PRNGKey(0))
    new_vars, loaded, missing = import_ecamp_pretrain(variables, path)
    assert not missing
    got = state_dict_from_flax(new_vars["params"])
    assert set(got) == set(ckpt["model"])
    for k, v in ckpt["model"].items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)

    opt_state, n, step = import_ecamp_adamw_state(
        task.tx.init(new_vars["params"]), new_vars["params"], load_pth(path))
    assert (n, step) == (len(ckpt["model"]), 6)
    adam = opt_state[0][0]
    order = list(ckpt["model"])  # the reference's index order, rebuilt
    no_decay = [k for k in order
                if ckpt["model"][k].ndim <= 1 or k.endswith(".bias")]
    order = no_decay + [k for k in order if k not in set(no_decay)]
    for tree, field in ((adam.mu, "exp_avg"), (adam.nu, "exp_avg_sq")):
        moments = state_dict_from_flax(tree)
        for i, k in enumerate(order):
            np.testing.assert_array_equal(
                moments[k].numpy(), ckpt["optimizer"]["state"][i][field]
                .numpy(), err_msg=f"{field} {k}")
