#!/usr/bin/env python3
"""`chip_smoke.py`'s graphed-step phase (g) alone, on the card of this
machine:

    python3 tools/graph_phase.py [OUT.json]

Builds the kernel library of this checkout and runs `graph_phase`: CUDA
graphs of the full-width pretraining step (B = 32, accumulation 2,
materialised and fused CE) against eager micro-steps from the same
weights, and their times. Then writes the seeded MIMIC-style corpus of
`chip_smoke.py`'s CLI phase and runs the pretrain CLI with
`--steps_per_call 3` and with 1 beside it (`--accum_iter 2 --fused_mlm_ce
--u8_pipe`, B = 16, one epoch, deterministic algorithms), their logs equal
bit for bit. The
launch counts it expects a micro-step are the full-width model's: 51
LayerNorm, 24 attention, 1 SR stack, with the fused CE 1 + 1 forward and
8 dl, dx, dW. Prints the phase's lines and its JSON (`graphed`), also
written to OUT.json if given; a failed check exits non-zero. Needs a CUDA
card.
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
        print("tools/graph_phase.py needs a CUDA card", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    _build.library()
    out = cs.graph_phase(card)
    cfg = PretrainConfig()
    cli_per_step = {"layer_norm": 51, "attention": 24, "sr_conv_stack": 1,
                    "sr_conv_stack_tma": 1, "adamw": 1, "fused_ce_fwd": 1,
                    "fused_ce_merge": 1, "fused_ce_dl": 8, "fused_ce_dx": 8,
                    "fused_ce_dw": 8}
    work = tempfile.mkdtemp(prefix="ecamp_graph_")
    try:
        write_mimic_corpus(
            os.path.join(work, "mimic"),
            os.path.join(REPO, "ecamp_tpu", "assets", "mimic_wordpiece.json"),
            cs.CLI_IMAGES, cs.CLI_IMG, cfg.vit.grid_size - cfg.sr_window,
            seed=cs.SEED)
        runs = cs.steps_per_call_cli_start(work)
        out["cli"] = cs.steps_per_call_cli_finish(card, runs, cli_per_step)
    finally:
        for p in cs._STARTED:
            cs._stop(p)
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"graphed": out}))
    if argv:
        with open(argv[0], "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
