#!/usr/bin/env python3
"""`chip_smoke.py`'s data-parallel fine-tune phase (9f) alone, on the cards
of this machine:

    python3 tools/dp_finetune_phase.py [OUT.json]

Builds the kernel library of this checkout, writes the seeded SIIM and
RSNA corpora of phases (8) and (9) (the same splits and image sizes) and
runs `dp_finetune_phase` without a pretrained checkpoint (the CLIs start
from the seeded init): (a) SegViT at 16 rows a rank and the ViT detector
at 32 under torchrun (2 NCCL ranks on two or more cards; on one card
NCCL at one rank and 2 gloo ranks sharing it) against one process at the
global batch, 24 LayerNorm, 12 attention and 1 AdamW launches a step on
every rank; (b) `torchrun --nproc_per_node=2 -m
ecamp_tpu_torch.cli.finetune_seg` and `... finetune_det` for an epoch,
their test metric against one process scoring the same best `.pth`.
Prints the phase's lines and its JSON (`data_parallel_finetune`), also
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

    from ecamp_tpu_torch.data.synthetic import (write_detection_corpus,
                                                write_segmentation_corpus)
    from ecamp_tpu_torch.kernels import _build

    if not torch.cuda.is_available():
        print("tools/dp_finetune_phase.py needs a CUDA card", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    _build.library()
    work = tempfile.mkdtemp(prefix="ecamp_dpf_")
    try:
        write_segmentation_corpus(os.path.join(work, "siim"), "SIIM",
                                  *cs.SEG_SPLITS, seed=cs.SEED,
                                  img_size=cs.SEG_IMG)
        write_detection_corpus(os.path.join(work, "rsna_det"), "RSNA",
                               *cs.DET_SPLITS, seed=cs.SEED,
                               img_size=cs.DET_IMG)
        out = cs.dp_finetune_phase(card, "", work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"data_parallel_finetune": out}))
    if argv:
        with open(argv[0], "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
