#!/usr/bin/env python3
"""`chip_smoke.py`'s data-parallel phase (6e) alone, on the cards of this
machine:

    python3 tools/dp_phase.py [OUT.json]

Builds the kernel library of this checkout, writes the seeded MIMIC-style
corpus the phase's torchrun CLI runs read, starts `torchrun -m
ecamp_tpu_torch.cli.pretrain --fsdp --fused_mlm_ce` (`dp_cli_start`) and
runs `dp_phase`: one process at B = 32, then `dp_worker` under torchrun
(2 NCCL ranks on two or more cards; on one card NCCL at one rank and 2
gloo ranks sharing it, side by side; on NCCL ranks also the graphed
data-parallel step against the eager one, (f): plain, ZeRO-1 and FSDP
with accumulation 2; in every launch FSDP against plain data
parallelism), beside them a graphed call of FSDP in one process against
its eager micro-steps, and the CLI with `--shard_optimizer
--steps_per_call 3` and with `--fsdp --steps_per_call 3`, each on one
NCCL rank, and the former's refusal on 2 gloo ranks sharing the first
card. The launch counts it expects a step are the full-width
model's: 51 LayerNorm, 24 attention, 1 SR stack, 1 AdamW; with the fused
CE 1 + 1 forward and 8 dl, dx, dW. Prints the phase's lines and its JSON
(`data_parallel`), also written to OUT.json if given; a failed check
exits non-zero. Needs a CUDA card.
"""

import json
import os
import shutil
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402


def main(argv) -> int:
    import torch

    from ecamp_tpu_torch.core.config import PretrainConfig
    from ecamp_tpu_torch.data.synthetic import write_mimic_corpus
    from ecamp_tpu_torch.kernels import _build

    if not torch.cuda.is_available():
        print("tools/dp_phase.py needs a CUDA card", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    _build.library()
    cfg = PretrainConfig()
    per_step = {"layer_norm": 51, "attention": 24, "sr_conv_stack": 1,
                "sr_conv_stack_tma": 1, "adamw": 1}
    cli_per_step = dict(per_step, fused_ce_fwd=1, fused_ce_merge=1,
                        fused_ce_dl=8, fused_ce_dx=8, fused_ce_dw=8)
    work = tempfile.mkdtemp(prefix="ecamp_dp_")
    try:
        write_mimic_corpus(
            os.path.join(work, "mimic"),
            os.path.join(REPO, "ecamp_tpu", "assets", "mimic_wordpiece.json"),
            cs.CLI_IMAGES, cs.CLI_IMG, cfg.vit.grid_size - cfg.sr_window,
            seed=cs.SEED)
        out = cs.dp_phase(card, per_step, cli_per_step, work,
                          cs.dp_cli_start(work))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"data_parallel": out}))
    if argv:
        with open(argv[0], "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
