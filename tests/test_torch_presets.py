"""The port's recipe registry (`core/presets.py`) and launcher
(`cli/run_preset.py`) against the JAX package's: every preset renders
the argv of `ecamp_tpu/core/presets.py`, which the port's CLI for it
parses and runs without refusing anything; `run_preset` lists them,
dispatches each to its CLI's `main(argv)`, and runs `pretrain_mimic`
(accum 8) at a tiny size on the CPU.
"""

import sys

import pytest

torch = pytest.importorskip("torch")

from ecamp_tpu.core import presets as jax_presets  # noqa: E402
from ecamp_tpu_torch.cli import (finetune_cls, finetune_det,  # noqa: E402
                                 finetune_seg, pretrain, run_preset)
from ecamp_tpu_torch.core import presets  # noqa: E402
from test_torch_accum import _corpus, read_log, tiny_cli  # noqa: E402

CLIS = {"pretrain": pretrain, "finetune_cls": finetune_cls,
        "finetune_seg": finetune_seg, "finetune_det": finetune_det}
PATHS = {"pretrain": ["--data_path", "/data/mimic"],
         "finetune_cls": ["--dataset_path", "/data/cls"],
         "finetune_seg": ["--dataset_path", "/data/seg"],
         "finetune_det": ["--dataset_path", "/data/det"]}


def test_registry_is_the_jax_packages():
    assert presets.PRESETS == jax_presets.PRESETS
    assert presets.list_presets() == jax_presets.list_presets()
    names = presets.list_presets()
    assert len(names) == 37
    for prefix, n in (("pretrain_mimic", 1), ("cls_ft_", 12),
                      ("cls_lp_", 12), ("seg_", 9), ("det_RSNA_", 3)):
        assert sum(name.startswith(prefix) for name in names) == n, prefix


@pytest.mark.parametrize("name", sorted(jax_presets.PRESETS))
def test_preset_parses_in_the_port(name):
    """The argv equals JAX's; the port's CLI parses it with the required
    path added, every flag lands, and nothing is refused as unported."""
    argv = presets.preset_argv(name)
    assert argv == jax_presets.preset_argv(name)
    entry = presets.PRESETS[name]["entry"]
    mod = CLIS[entry]
    args = mod.get_args(argv + PATHS[entry])
    for k, v in presets.PRESETS[name]["args"].items():
        got = getattr(args, k)
        assert got == v or str(got) == str(v), (k, got, v)
    mod.refuse_what_is_not_ported(args)


def test_run_preset_lists_and_dispatches(monkeypatch, capsys):
    """`list` (and no argument) prints every preset and its entry; a name
    runs its CLI's `main` on the preset's argv with the extra flags after
    it, and leaves `sys.argv` alone; an unknown name exits."""
    for argv in (["list"], []):
        run_preset.main(argv)
        out = capsys.readouterr().out
        for name, p in presets.PRESETS.items():
            assert f"  {name}  ->  {p['entry']}" in out
    calls = []
    for entry, mod in CLIS.items():
        monkeypatch.setattr(mod, "main",
                            lambda argv, entry=entry: calls.append(
                                (entry, argv)) or entry)
    before = list(sys.argv)
    for name in presets.list_presets():
        entry = presets.PRESETS[name]["entry"]
        extra = PATHS[entry] + ["--device", "cpu"]
        assert run_preset.main([name] + extra) == entry
        assert calls[-1] == (entry, presets.preset_argv(name) + extra)
    assert len(calls) == 37 and sys.argv == before
    with pytest.raises(SystemExit, match="unknown preset"):
        run_preset.main(["no_such_recipe"])


def test_run_preset_pretrain_mimic_runs_its_accumulation(tmp_path):
    """`run_preset pretrain_mimic` reaches the pretrain CLI with the
    recipe's `--accum_iter 8`: one epoch of 2 micro-steps at B = 4 (the
    later `--batch_size` wins) logs 0 updates and writes checkpoint-0.pth
    with the open cycle of 2 micro-steps."""
    root = _corpus(tmp_path, 8)
    out = tmp_path / "out"
    with tiny_cli() as buf:
        run_preset.main(["pretrain_mimic", "--data_path", root,
                         "--batch_size", "4", "--epochs", "1",
                         "--max_epoch", "4", "--warmup_epochs", "1",
                         "--input_size", "64", "--max_caption_length", "16",
                         "--num_workers", "2", "--no_bf16",
                         "--device", "cpu", "--output_dir", str(out)])
    assert "saved" in buf.getvalue()
    (rec,) = read_log(out)
    assert (rec["micro_steps"], rec["updates"]) == (2, 0)
    assert rec["kernel_launches"]["adamw"] == 0
    ck = torch.load(out / "checkpoint-0.pth", weights_only=True)
    assert ck["accum_cycle"]["mini_step"] == 2
    assert {int(s["step"]) for s in ck["optimizer"]["state"].values()} == {0}
