#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ecamp_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. Setup: print the card's `nvidia-smi` name and power limit, turn TF32
   off for the comparisons, build the CUDA library (one nvcc per source, in
   parallel).
2. Kernels against their plain PyTorch versions on the card, in fp32
   (|err| <= 1e-5, relative to the output's scale for a gradient) and bf16
   (atol = rtol = 1.6e-2, about one bf16 ulp of the output), with median
   CUDA-event times, the profiler's device time a call (where the profiler
   records nothing, CUDA events around calls queued behind a held
   stream; the `device_ms_by_events` line lists those), the kernel's bound
   (the least time the card could take: its operations over the H100's
   peak for their type or its bytes over the memory rate, whichever is
   longer) and, where one PyTorch call computes the same function
   (`F.scaled_dot_product_attention`, `F.layer_norm`), that call's times
   and the ratio of the two device times as a yardstick: LayerNorm and
   attention forward at the serving shapes and at the pretraining step's
   shapes (B = 32); there LayerNorm and attention forward + backward
   through their autograd Functions against autograd of the plain
   versions, and the SR conv stack forward (also at ragged, small and
   unaligned shapes, on both of its kernels). A kernel and its library
   call are timed on `rotated` copies of their inputs, twice the L2
   together, so neither finds its inputs in the L2. bf16 attention also
   runs with every odd batch*head's K and V NaN at a ragged Nk, each head
   dim and bias kind (the even heads must match).
3. The serving slice: a full-width ViT-B/16 classifier (224 px, 14
   classes, multilabel, buckets 8/32/64) with seeded random weights behind
   `classifier_engine` + `PredictionService` + the HTTP server. Three
   POSTs (1 image through the MicroBatcher, 5, and 40) must agree with a
   direct forward of the same model through the plain versions, and must
   have launched both kernels the expected number of times.
4. The pretraining slice: `PretrainTask` with a full-width ECAMP (ViT-B/16
   448 -> 224, decoder 512/4/16, 6-layer BERT, vocab 30000, L = 256,
   182.6M parameters), seeded weights and a seeded synthetic batch, B = 32,
   bf16 compute, AdamW at a constant lr 1.5e-4. (a) losses finite, mlm
   near ln 30000 at init; (b) the first step through the kernels against
   the same step through the plain versions (losses within 2e-2, grad
   norm within 5%), and the AdamW kernel against the per-leaf formula on
   the whole 182.6M-element parameter set; (c) the loss falls over 5
   steps; (d) exact launch counts per step; (e) step time, images/s and
   peak device memory; (f) the same with `fused_mlm_ce`: its first step
   against the materialised plain step of (b), the loss falling over 5
   steps, the fused-CE forward's tile and merge kernels once each and a
   dl, dx and dW launch for each of the 8 vocab chunks a step beside the
   others, step time, peak memory and device busy time (profiler) beside
   (e)'s.
4b. The recipe's micro-batch (pretrain_mimic: B = 256, accumulation 8),
   after the pretraining slice: `PretrainTask` at full width with
   `accum_steps` 8, (e) materialised and (f) fused CE, 8 micro-steps on
   seeded synthetic batches (one update), the counters set to 0 before
   and read after: every kernel's launches a micro-step as in 4 and
   AdamW once; the parameters bit-unchanged after micro-steps 1-7 and
   changed at 8; ms a micro-step, images/s, peak device memory; the host
   and device ms of `MultiSteps`' per-leaf fold of one micro-step. Then
   two micro-steps of B = 16 against one step of B = 32 on the same
   images and noise, dropout off, through the kernels: the mean gradient
   that reaches AdamW within 1e-2 of the whole batch's (relative L2).
5. The fused vocab-projection + CE kernels (in 2., after the SR stack)
   against their plain versions at the step's shape (B * 256, 768, 30000)
   in bf16, at a ragged fp32 shape, and at a ragged bf16 shape (V = 3001:
   a 57-wide last vocab tile) over three lowered vocab chunks; each
   tensor-core kernel (the forward's tiles and merge, the backward's dl,
   dx, dW) also alone against its plain version, timed by name at the
   main shape.
6. The pretraining CLI: `python -m ecamp_tpu_torch.cli.pretrain
   --fused_mlm_ce` at full width on a seeded MIMIC-style corpus written to
   a temporary directory, 2 epochs and a resume for a third. Then on the
   same corpus: (6b) `--accum_iter 2 --fused_mlm_ce` for 2 epochs (2
   micro-steps an epoch): each epoch's launches a micro-step as before
   and one AdamW launch an update, the log's micro-steps and updates,
   checkpoint-1.pth's AdamW step the updates; (6c) the same with
   ECAMP_PREEMPT_AT_STEP=3 (epoch 1, batch 1, mid-cycle): exit 0 with
   the preemption message and `checkpoint-step-3.pth` (its step and open
   cycle), then `--resume` on it to the end of epoch 1: the final
   checkpoint's epoch, AdamW step and open cycle equal (6b)'s, its
   parameters equal (6b)'s bit for bit or lie within 1e-3 of each leaf's
   movement from the initial weights (which of the two held is printed,
   with the max difference); (6d) `python -m
   ecamp_tpu_torch.cli.run_preset pretrain_mimic --batch_size 32 --epochs
   1 --fused_mlm_ce`: the preset's accumulation 8 over 2 micro-steps, 0
   updates, no AdamW launch; (6b), (6c)'s first run and (6d) side by
   side. The `pretrain_recipe` JSON line holds 4b's figures and these
   results.
6e. Data-parallel pretraining (`dp_phase`), at full width, bf16, dropout
   off, injected noise, AdamW lr 1.5e-4: one process at B = 32 on a seeded
   global batch for 3 steps (the reference), then `torchrun` of this
   script's `--dp-worker` mode: on two or more cards 2 NCCL ranks of B =
   16, on one card NCCL at world size 1 (B = 32) and 2 gloo ranks of B =
   16 sharing the card. Each: (a) every step's losses within 2e-2, the
   first averaged gradient's norm and the 3 steps' parameter update's norm
   within 5% of the reference's (the update's cosine printed), the
   materialised step's launches a step on every rank; (b) a ZeRO-1 AdamW
   fed the same averaged gradients after every step equal to plain data
   parallelism's parameters bit for bit; (c) the ranks' parameter
   checksums equal; at 2 ranks a ZeRO-1 run: (d) each rank's peak memory
   with and without ZeRO-1, the saving within 10% of the moments' share
   it drops; (e) ZeRO-1 preempted at step 2 (the ranks agree), saved,
   loaded by a new task on every rank (the loaded parameters, moment
   pieces and count equal the saved ones bit for bit) and resumed, its
   loss within 2e-2 of the uninterrupted run's; host ms a step. The step
   itself is not bit-reproducible on the card (its upsample and scatter
   backwards add atomically): ZeRO-1 is held to plain data parallelism
   bit for bit on the same averaged gradients, and two runs' parameters
   are compared by distance (printed). Beside those launches, `torchrun
   -m ecamp_tpu_torch.cli.pretrain --shard_optimizer --fused_mlm_ce` on 2
   ranks (gloo on one card) of B = 16 for an epoch of 6's corpus: one log
   line, rank 0's, with every kernel's launches a micro-step, and whole
   moments in its checkpoint.
   The `data_parallel` JSON line holds the figures.
7. The classification fine-tune at full width (ViT-B/16 at 224, 14
   multilabel classes, bf16, recipe cls_ft_ChestX-ray14_1: B = 96, SGD
   momentum 0.9, lr 3e-2, warmup 50, clip 1.0, drop-path 0.1), after the
   CLI: LayerNorm and attention against their plain versions at its shapes
   ((96 * 197, 768), (96, 768), (96, 12, 197, 64)); (a) the first step
   through the kernels against the same step through the plain versions
   (loss 2e-2, grad norm 5%), 5 steps on a fixed batch (the eval-mode loss
   falls), 25 LayerNorm and 12 attention launches a step, step time, device
   busy and peak memory; (b) a linear probe of 3 steps: trunk and fc_norm
   bit-unchanged, the head changed, the same launches; (c) `python -m
   ecamp_tpu_torch.cli.finetune_cls` from the pretrain CLI's checkpoint on
   a seeded 192/70/70 list corpus (eval batch 32, ragged), 2 epochs of
   updates, patience 1: validation and test lines, the best `.pth`; (d)
   `classifier_engine` on that `.pth` against `ClassificationTask.eval_step`
   plus a sigmoid (2e-2); (e) `preempt_drill`: (c)'s command in a fresh
   output directory with ECAMP_PREEMPT_AT_STEP at micro-step 3 (epoch 1,
   batch 1, after the first validation), started beside (c) (it reads
   nothing of (c)'s): exit 0, the message,
   `preempt/checkpoint-step-3.pth`, no test line; then again without the
   variable: the resume line, the test line, `preempt/` gone; the
   validations, the test metric and the best `.pth` against (c)'s: bit for
   bit, or, where they are not, within PREEMPT_SPREAD times the distance
   of (c)'s command run once more uninterrupted, run only where they are
   not (the segmentation and detection runs repeat bit for bit on the
   card since their align-corners upsample's backward is two products,
   not `F.interpolate`'s atomic adds: `tools/repeat_probe.py`); which
   held is printed; each validation's launches as (c) counts them (from the
   resume, after it), the save's, the resume's and the phase's seconds
   and the file's bytes.
8. The segmentation fine-tune at full width (SegViT: ViT-B/16 at 224,
   seg_head, decoder 512/256/128/64, bf16, the encoder frozen; recipe
   seg_SIIM_100: B = 512, AdamW lr 5e-4 wd 0.05, warmup 50 of 3000, clip
   1.0), after the fine-tune: LayerNorm and attention against their plain
   versions at (512 * 197, 768) and (512, 12, 197, 64); (a) the first
   step through the kernels against the plain step (loss 2e-2, grad norm
   5%, BatchNorm running statistics 2e-2), the AdamW kernel on the 20
   trainable leaves against the per-leaf formula at count 50 (the end of
   the warmup: every leaf moves), the device time of the
   last decoder upsample, 5 steps on a fixed seeded batch (the loss
   falls), 24 LayerNorm, 12 attention and 1 AdamW launches a step, the
   trunk bit-unchanged and seg_head and the decoder changed, step time,
   device busy and peak memory; (b) SegViTDual (RIGA, B = 56) for 3
   steps, the same launches, both decoders changed; (c) `python -m
   ecamp_tpu_torch.cli.finetune_seg --task SIIM` from the pretrain CLI's
   checkpoint on a seeded SIIM corpus (PNGs at 512 px, RLE masks at 1024,
   B = 32, eval batch 32, ragged), 2 epochs of updates, patience 1; (d)
   `segmenter_engine` on its best `.pth` against
   `SegmentationTask.eval_step` (2e-2) and one POST through the HTTP
   server with task segmentation; (e) (c) preempted at micro-step 4 (epoch
   1, batch 1) and resumed, as 7 (e).
9. The detection fine-tune at full width (the ViT-B/16 detector: det_head
   768 -> 768, the Bottleneck neck at expansion 4 to 28^2 x 512, 14^2 x
   1024 and 7^2 x 2048, the YOLOv3 head with 1 class; bf16, the encoder
   frozen; recipe det_RSNA_100: B = 1024, AdamW lr 5e-4 wd 0.05, warmup
   30 of 20000, clip 1.0), after the segmentation fine-tune: LayerNorm and
   attention against their plain versions at (1024 * 197, 768) and (1024,
   12, 197, 64); (a) on a fixed seeded u8 batch with 1-3 boxes an image,
   the first step through the kernels against the plain step (loss 2e-2,
   grad norm 5%, BatchNorm running statistics 2e-2), the AdamW kernel on
   the 100 trainable leaves against the per-leaf formula at count 30 (the
   end of the warmup: every leaf moves), 5 steps from count 30 (the peak
   lr, reached through the 30 warmup steps; the loss falls), 24 LayerNorm, 12 attention and 1 AdamW launches a
   step, the trunk bit-unchanged and det_head, the neck and the head
   changed, step time, images/s, device busy and peak memory; (b)
   det_RSNA_10 (expansion 8, B = 256) for 3 steps, the same launches; (c)
   `python -m ecamp_tpu_torch.cli.finetune_det --task RSNA` from the
   pretrain CLI's checkpoint on a seeded RSNA corpus (PNGs at 512 px, B =
   32, eval batch 32, ragged), 2 epochs of updates, patience 1,
   `--start_eval 1`: validation mAP lines, the best `.pth`, the test mAP
   line; (d) `detector_engine` on its best `.pth`: its decoded candidates
   against `DetectionTask.eval_step` (the boxes 2e-2 of their scale, the
   probabilities 2e-2 absolute), the same boxes from its NMS and the
   task's on one candidate set, and one POST through the HTTP server with
   task detection; (e) (c) preempted at micro-step 4 (epoch 1, batch 1)
   and resumed, as 7 (e). The phase prints its seconds.
9f. Data-parallel fine-tunes (`torchrun`; `core/distributed.py`, the
   global-batch BatchNorm and dice, `cli/common.py::ShardedEval`), full
   width, bf16, AdamW at a constant lr 5e-4: (a) SegViT (SIIM) at a
   global batch of DPF_SEG_B = 32 and the ViT detector at DPF_DET_B = 64
   (16 and 32 a rank at 2 ranks), 3 steps each from the seeded weights on
   the rank's rows of a seeded global batch, under torchrun
   (`chip_smoke.py --dp-ft-worker SPEC`): 2 NCCL ranks on two or more
   cards; on one card NCCL at one rank and 2 gloo ranks sharing it; each
   launch against one process at the global
   batch: every step's loss within LOSS_TOL, the first averaged
   gradient's norm within GNORM_TOL, the BatchNorm running statistics
   within DPF_BN_TOL, the ranks' parameter and BatchNorm-buffer checksums
   equal, 24 LayerNorm, 12 attention and 1 AdamW launches a step on every
   rank, host ms a step and each rank's peak memory printed; (b) started
   before (a) and running beside it: `torchrun --nproc_per_node=2 -m
   ecamp_tpu_torch.cli.finetune_seg --task SIIM` and `... finetune_det
   --task RSNA --start_eval 1` on (8)'s and (9)'s corpora from the
   pretrain CLI's checkpoint, DPF_CLI_B = 16 rows a rank, 1 epoch: one
   `log.txt` (one validation and one test line, from rank 0), a best
   `.pth`, and the test metric the 2 ranks' ShardedEval gave within
   DPF_TEST_TOL of the same CLI's `--stage test` in this process (one
   process) on that `.pth`, the difference printed; (c) the
   `data_parallel_finetune` JSON line; `dp_seg_launches` and
   `dp_det_launches` in the `kernels` line.
10. The ResNet-50 UNet segmentation baseline (`ResNetUNet`: torchvision
   ResNet-50 encoder, decoder 256/128/64/32/16, 224 px, bf16, trained end
   to end; seg_SIIM_100's AdamW lr 5e-4 wd 0.05 clip 1.0 with the warmup
   cut to 2 updates), after the
   detection fine-tune: B = 512 halved until a step fits in the card's
   memory (a B = 16 step's peak sets the first try; the B used is
   printed); (a) the first step through the kernels (here AdamW only)
   against the plain step (loss 2e-2, grad norm 5%, BatchNorm statistics
   2e-2), the AdamW kernel unmasked over all 191 leaves against the
   per-leaf formula at count 2, 4 steps on a fixed seeded batch after the
   2 warmup steps (the loss falls), 1 AdamW launch a step and no other,
   step time, images/s,
   device busy and peak memory; (b) `python -m
   ecamp_tpu_torch.cli.finetune_seg --task SIIM --model resnet50` on (8)'s
   SIIM corpus with its encoder from a seeded torchvision-layout `.pth`
   (265 tensors loaded), 1 epoch, patience 1: validation lines with their
   AdamW launches, the best `.pth`, the test dice line.
11. The ResNet-50 detector baseline (`DetectionModel(backbone="resnet50")`:
   the frozen ResNet-50's layer2/3/4 maps into the YOLOv3 head, 224 px,
   bf16; det_RSNA_100's AdamW, warmup 30): B = 1024 halved until a step
   fits; (a) the first step through the kernels against the plain step,
   the masked AdamW on the head's 66 leaves at count 30, 4 steps after the
   30 warmup steps (the loss falls), 1 AdamW launch a step and no other,
   the backbone's weights bit-unchanged while its BatchNorm statistics
   move, the head changed, step time, images/s, device busy and peak memory; (b) `python
   -m ecamp_tpu_torch.cli.finetune_det --task RSNA --model resnet50` on
   (9)'s RSNA corpus from the same `.pth`, 1 epoch, patience 1.
12. The visualizer: `cli.visualize.main` in this process at full width
   (ViT-B/16 and the 6-layer BERT, fp32, 224 px, L = 256) on the pretrain
   CLI's `checkpoint-2.pth`, a seeded PNG and
   `ecamp_tpu/assets/mimic_wordpiece.json` (read as a file): the PNGs
   written, 42 LayerNorm and 19 attention launches (every LayerNorm and
   self-attention; the cross attention that returns its probabilities runs
   the plain version, as in JAX), and the heatmap within VIZ_TOL of the
   one from the plain versions of every kernel on the same inputs; the
   LayerNorm and attention forwards at its fp32 shapes against their plain
   versions.
13. Serving's remaining paths: (a) the int8-weight linear kernel against
   its plain version (F.linear with the dequantised weight) in bf16 at the
   four ViT-B projections (N, K) = (2304, 768), (768, 768), (3072, 768),
   (768, 3072) for M = 197 x 1, 8 and 64 images, and at a ragged (37,
   200, 64), beside `F.linear` on the weight dequantised once (the
   library call) and the bound, each with the plan the wrapper took
   (`_plan`: token tile, work units, splits of K), after the int8
   kernels' `ptxas:` lines (registers, spills, any serialised `wgmma`);
   (b) `classifier_engine(quantize="int8")`
   at full width (the serving slice's model and seeded weights, its 49
   projections int8, the 768 x 14 head under the size floor) behind the
   HTTP server: one POST with 25 LayerNorm, 12 attention and 49 int8
   launches, its probabilities within 2e-2 of the bf16 engine on the same
   weights and within PROB_TOL of itself on the plain versions, the
   per-bucket p50, the weights' device bytes, the peak of a bucket-64 call
   and the device busy time of a bucket call beside the bf16 engine's;
   (c) `embedding_engine` on the pretrain CLI's `checkpoint-2.pth`: unit
   norm (1e-3), within 2e-2 of itself on the plain versions, 25 LayerNorm
   and 12 attention launches a forward, one POST with task embedding, the
   per-bucket p50; its int8 engine (50 int8 launches: the 49 and
   `bert_mlp`) at cosine >= 0.99 to it; (d) `python -m
   ecamp_tpu_torch.cli.export` (in this process, on the CPU) of that
   checkpoint and of the classification fine-tune's best `.pth`: the
   engines on the exported files serve the originals' outputs bit for
   bit.
14. Per-bucket p50 latency and the device time of a bucket-64 call, JSON
   lines of the results, of every kernel shape timed, of each phase's end
   (seconds after the build, `phase_end_seconds`; also printed as each
   phase ends) and of the kernels (with each kernel's launches in (6e)'s
   runs: `dp_launches`, `dp_zero1_launches`, `dp_cli_launches`, and in
   (9f)'s: `dp_seg_launches`, `dp_det_launches`) and, last, the device
   line.

Any failed check or exception exits non-zero. Without a CUDA card it fails
at once; it never runs on the CPU.
"""

from __future__ import annotations

import base64
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import urllib.request

SEED = 0
N_CLASSES = 14
IMG = 224
BUCKETS = (8, 32, 64)
REQUESTS = (1, 5, 40)  # 1 -> MicroBatcher -> bucket 8; 5 -> 8; 40 -> 64
PROB_TOL = 2e-2
FP32_TOL = 1e-5
BF16_TOL = 1.6e-2
TIMING_REPS = 20
PRE_B = 32           # the pretraining batch (fits one H100 with room)
PRE_STEPS = 5        # steps of (c); all but the first are timed
LOSS_TOL = 2e-2      # kernel vs plain step, relative
GNORM_TOL = 5e-2
LN_V = 10.308952660644293  # ln 30000
CLI_IMAGES = 64      # the CLI's corpus: 2 steps an epoch at PRE_B
CLI_IMG = 512
CLI_TIMEOUT = 400    # seconds for one CLI run
CLI_ACCUM = 2        # (6b), (6c): an update every 2 micro-steps
CLI_PREEMPT_AT = 3   # (6c): epoch 1, batch 1, the cycle's micro-step 1
PREEMPT_TOL = 1e-3   # (6c) against (6b) where not bit for bit: of each
                     # leaf's movement from the initial weights
PREEMPT_SPREAD = 3   # (7e)-(9e) where not bit for bit: the resumed run's
                     # distance from (c) against (c) repeated (best .pth L2,
                     # metrics)
# -- the recipe's micro-batch (pretrain_mimic: B = 256, accum 8) ----------
RECIPE_B = 256
RECIPE_ACCUM = 8     # micro-steps an update
ACCUM_HALF_B = 16    # two micro-steps of this against one step of PRE_B
ACCUM_TOL = 1e-2     # their mean gradient against the whole's, relative L2
DP_STEPS = 3         # data-parallel steps of (6e)
DP_PREEMPT_AT = 2    # (6e): the ranks stop after this step
DP_B = 16            # rows a rank of the torchrun CLI run
DP_TIMEOUT = 300     # seconds for one torchrun launch
# the fine-tune: recipe cls_ft_ChestX-ray14_1 (ecamp_tpu/core/presets.py:
# 32-48): batch 96, SGD momentum 0.9, lr 3e-2, warmup 50 of 3000 steps,
# clip 1.0, drop-path 0.1, ViT-B/16 at 224, 14 multilabel findings
FT_B = 96
FT_STEPS = 5         # steps of (a); all but the first are timed
FT_PROBE_STEPS = 3
FT_SPLITS = (192, 70, 70)  # the CLI's corpus: 2 updates an epoch at FT_B
FT_EVAL_B = 32       # 70 = 2 * 32 + 6: a ragged last eval batch
FT_IMG = 512         # the corpus's JPEG size
# -- the segmentation fine-tune (recipe seg_SIIM_100; RIGA seg_RIGA_10) ----
SEG_B = 512
SEG_STEPS = 5        # steps of (a); all but the first are timed
SEG_DUAL_B = 56
SEG_DUAL_STEPS = 3
SEG_SPLITS = (96, 70, 40)  # SIIM rows; train balances to ~2 x positives
SEG_CLI_B = 32
SEG_EVAL_B = 32      # 70 = 2 * 32 + 6: a ragged last eval batch
SEG_IMG = 512        # the corpus's PNG size (masks stay RLE at 1024)
# -- the detection fine-tune (recipe det_RSNA_100; det_RSNA_10) -----------
DET_B = 1024
DET_STEPS = 5        # steps of (a) from the end of the warmup; all but the
                     # first are timed
DET10_B = 256
DET10_STEPS = 3
DET_SPLITS = (96, 38, 40)  # RSNA rows; val and test read the 38
DET_CLI_B = 32
DET_EVAL_B = 32      # 38 = 32 + 6: a ragged last eval batch
DET_IMG = 512        # the corpus's PNG size
# -- the ResNet-50 baselines (seg_SIIM_100's and det_RSNA_100's batches) --
DPF_SEG_B = 32       # (9f) (a): the global batch of SegViT (16 a rank
DPF_DET_B = 64       # at 2 ranks) and of the ViT detector (32 a rank)
DPF_STEPS = 3
DPF_BN_TOL = 2e-2    # BatchNorm running statistics against one process
DPF_CLI_B = 16       # (b): rows a rank of the torchrun CLIs
DPF_TEST_TOL = 1e-3  # (b): the 2-rank test metric against one process's

RSEG_B = 512         # halved until a step fits
RDET_B = 1024
RESNET_PROBE_B = 16  # the batch whose peak memory sets the first try
RESNET_STEPS = 4     # steps of (a); all but the first are timed
RESNET_WARMUP = 2
RESNET50_TENSORS = 53 + 4 * 53  # a torchvision ResNet-50 (53 convs and BNs)
# -- the visualizer -------------------------------------------------------
VIZ_TOL = 2e-3       # max |heatmap with kernels - plain| on its [0, 1] map
# -- serving's remaining paths: int8 weights, embeddings, export ----------
I8_PROJECTIONS = ((2304, 768), (768, 768), (3072, 768), (768, 3072))  # (N, K)
I8_IMAGES = (1, 8, 64)           # M = 197 tokens an image
I8_RAGGED = (37, 200, 64)
I8_MAIN = (197 * 8, 3072, 768)   # the kernels line's row: fc1 at bucket 8
INT8_PROB_TOL = 2e-2  # int8 vs bf16 engine (JAX's test_int8_classifier_
                      # engine_via_loader bound)
EMB_BUCKETS = (8, 32)
EMB_NORM_TOL = 1e-3
EMB_PLAIN_TOL = 2e-2
EMB_COS = 0.99        # int8 against bf16 embeddings


class CheckFailed(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "--id=0"], capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def median_ms(fn, reps: int = TIMING_REPS, per_pair: int = 10) -> float:
    """Median over `reps` CUDA-event pairs, each around `per_pair`
    back-to-back calls, of the time per call. A kernel shorter than its
    host-side launch reads as the launch rate here; the profiler gives its
    device time."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per_pair):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_pair)
    times.sort()
    return times[len(times) // 2]


PROFILER_TRIES = 3
BY_EVENTS = []  # what device_ms timed by queued CUDA events instead
# The H100's L2 holds 50 MB: a kernel called again on the same inputs
# finds them there. Timed calls rotate over copies of their inputs that
# together reach twice that, so each reads its inputs from device memory,
# as a step does.
L2_BYTES = 50 * 2 ** 20
ROTATE_BYTES = 2 * L2_BYTES


def rotated(fn, inputs, floor: int = ROTATE_BYTES):
    """A function of no arguments that calls fn(*copy), each time on the
    next of enough copies of `inputs` (tensors cloned, anything else
    shared) that the copies' tensors together hold `floor` bytes; the
    first copy is `inputs` itself. Its `copies` attribute counts them."""
    import torch

    nbytes = sum(t.numel() * t.element_size() for t in inputs
                 if isinstance(t, torch.Tensor))
    n = max(1, -(-floor // max(nbytes, 1)))
    copies = [tuple(inputs)] + [
        tuple(t.clone() if isinstance(t, torch.Tensor) else t for t in inputs)
        for _ in range(n - 1)]
    turn = [0]

    def call():
        i = turn[0]
        turn[0] = (i + 1) % n
        return fn(*copies[i])

    call.copies = n
    return call


def queued_ms(fn, calls: int = 20) -> float:
    """Device time per call of `fn` by CUDA events around `calls` calls
    queued while a spin kernel (`torch.cuda._sleep`) holds the stream, so
    that they run back to back whatever the host's launch rate. The hold
    grows until the queueing ends before it does."""
    import torch

    fn()
    torch.cuda.synchronize()
    cycles = 1 << 22  # about 2 ms at the H100's clock
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        held = not a.query()  # every call was queued before the first ran
        b.synchronize()
        if held:
            return a.elapsed_time(b) / calls
        cycles *= 4
    raise CheckFailed("the calls outlasted every hold of the stream")


def device_ms(fn, match: str = "", calls: int = 20, label: str = "",
              alone: bool = True):
    """Device time per call of `fn`: the time of the kernels whose name
    holds `match` (every kernel if empty), summed by torch.profiler over
    `calls` calls. Unlike `median_ms` it does not see the host's launch
    rate. The profiler now and then records no kernel at all, or (with a
    `match`, a kernel each call launches) fewer of them than calls: after
    PROFILER_TRIES such tries, a function that launches nothing on the
    card but what is measured (`alone`) is timed by `queued_ms` (and
    `label` joins BY_EVENTS); any other reads None, not measured."""
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ecamp_tpu_torch.train.profile_step import _device_us

    fn()
    torch.cuda.synchronize()
    warnings.filterwarnings("ignore", "Profiler clears events")
    for _ in range(PROFILER_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages() if match in e.key]
        us = sum(_device_us(e) for e in hits)
        seen = sum(e.count for e in hits if _device_us(e) > 0)
        if us > 0 and (not match or seen >= calls):
            return us / calls / 1e3
        if us > 0:
            print(f"  '{label or match}': the profiler recorded {seen} of "
                  f"{calls} kernels ({us / seen / 1e3:.4f} ms each); session "
                  f"refused")
    what = f"'{label or match}': the profiler saw no kernel, or fewer " \
        f"than one a call, in {PROFILER_TRIES} tries"
    if not alone:
        print(f"  {what}; device time not measured")
        return None
    ms = queued_ms(fn, calls)
    BY_EVENTS.append(label or match)
    print(f"  {what}; {ms:.4f} ms a call by queued CUDA events")
    return ms


def _ms(t) -> str:
    return "not measured" if t is None else f"{t:.3f} ms"


# -- the least time the card could take -------------------------------------
# Published peaks of one H100 SXM (NVIDIA's data sheet, dense): bf16 on the
# tensor cores, fp32 on the FMA pipe, and device memory. A kernel's bound is
# the larger of its operations over the peak for their type (the inputs')
# and its bytes over the memory rate, counting each input read once and
# each output written once.
PEAK_OPS = {"bf16": 989e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound(work) -> tuple:
    """(bound_ms, "operations" or "bytes") of work = (flops, bytes, type)."""
    flops, nbytes, kind = work
    ops_ms = flops / PEAK_OPS[kind] * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms > bytes_ms else (bytes_ms, "bytes")


def _kind(itemsize: int) -> str:
    return "bf16" if itemsize == 2 else "fp32"


def attention_work(b, h, nq, nk, d, itemsize, bias_elems=0):
    """Q K^T and P V (2 flops a multiply-add); q, k, v read, o written, the
    fp32 bias read once at its stored size."""
    return (4 * b * h * nq * nk * d,
            itemsize * b * h * d * 2 * (nq + nk) + 4 * bias_elems,
            _kind(itemsize))


def layer_norm_work(rows, d, itemsize):
    """About 8 flops an element; x read, y written, fp32 weight and bias."""
    return 8 * rows * d, 2 * itemsize * rows * d + 2 * 4 * d, _kind(itemsize)


def sr_work(b, h, w, itemsize):
    """Two 3x3 convs of 3 -> 3 channels (81 multiply-adds a pixel each) with
    their biases, then the residual; the 3-channel image read and written."""
    px = b * h * w
    return (px * (2 * (2 * 81 + 3) + 3), 2 * itemsize * 3 * px,
            _kind(itemsize))


def adamw_work(n):
    """About 15 flops a parameter; p, g, m, v read and p, m, v written, fp32."""
    return 15 * n, 28 * n, "fp32"


def fused_ce_fwd_work(n, d, v, itemsize):
    """The (n, v) logits' product; x, w, fp32 bias and int64 labels read,
    fp32 lse and gold written."""
    return (2 * n * d * v, itemsize * (n + v) * d + 4 * v + 8 * n + 8 * n,
            _kind(itemsize))


def fused_ce_fwd_tiles_work(n, d, v, itemsize, tiles):
    """The forward's tile kernel: the logits' product; x, w, fp32 bias and
    int64 labels read, the fp32 (max, sum-exp) of each tile and row and the
    fp32 gold written."""
    return (2 * n * d * v,
            itemsize * (n + v) * d + 4 * v + 8 * n + 8 * tiles * n + 4 * n,
            _kind(itemsize))


def fused_ce_fwd_merge_work(n, tiles):
    """The forward's merge: about 4 fp32 flops a tile and row (max, exp,
    multiply-add); the tile stats and labels read, lse and gold written."""
    return 4 * tiles * n, 8 * tiles * n + 8 * n + 4 * n + 4 * n, "fp32"


def fused_ce_bwd_work(n, d, v, itemsize):
    """The logits once more and the dx and dW products; the forward's inputs
    plus fp32 lse and weights read, dx, dW and the fp32 db written."""
    return (3 * 2 * n * d * v,
            2 * itemsize * (n + v) * d + 2 * 4 * v + 8 * n + 8 * n,
            _kind(itemsize))


def int8_linear_work(m, n, k):
    """x · wᵀ, 2·M·N·K operations on the tensor cores (bf16); the bf16 x,
    int8 q, fp32 scales and bf16 bias read, the bf16 y written."""
    return 2 * m * n * k, 2 * m * k + n * k + 4 * n + 2 * n + 2 * m * n, \
        "bf16"


def _within(label, got, want, dtype, scaled: bool = False) -> float:
    """Check one output against its plain value at the tolerance of
    `dtype` (fp32 relative to the output's largest value if `scaled`);
    return the max |err|."""
    import torch

    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{label}: {tuple(got.shape)} {got.dtype} vs "
          f"{tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{label}: non-finite output")
    err = (g - w).abs()
    if dtype == torch.float32:
        tol = FP32_TOL * (float(w.abs().max()) if scaled else 1.0)
    else:
        tol = BF16_TOL * (float(w.abs().max()) if scaled else 1.0) \
            + BF16_TOL * w.abs()
    max_err = float(err.max())
    check(bool((err <= tol).all()), f"{label}: max |err| {max_err:.3e} over "
          f"tolerance")
    return max_err


def compare(label, kernel_fn, plain_fn, dtype, reps: int = TIMING_REPS,
            per_pair: int = 10, oracle_fn=None, library_fn=None, match=None,
            work=None, inputs=None, library_inputs=None,
            events: bool = False) -> dict:
    """Run a kernel wrapper and its plain version on the same inputs; check
    every output at the tolerance of `dtype` (a tuple of outputs are
    gradients, checked relative to their scale) against `oracle_fn` if
    given, else the plain version; time both. `library_fn`, one PyTorch
    call that computes the same function (a yardstick the port never
    calls), is timed beside them; `match`, the kernel's name, adds the
    profiler's device time of the kernel (and of the library call), both
    read by `queued_ms` instead if `events` or if the profiler failed
    either or read one under the bound; `work`, its (flops, bytes, type),
    adds its bound. With `inputs`, every
    function is one of those tensors (the library call's of
    `library_inputs` if given), and the kernel and the library call are
    timed on `rotated` copies of them. Returns what was measured:
    max_abs_err, ms, plain_ms and those."""
    import torch

    if inputs is not None:
        fns = (kernel_fn, plain_fn, oracle_fn)
        kernel_fn, plain_fn, oracle_fn = (
            None if f is None else (lambda f=f: f(*inputs)) for f in fns)
        timed_kernel = rotated(fns[0], inputs)
        if library_fn is not None:
            library_fn = rotated(library_fn, library_inputs or inputs)
    else:
        timed_kernel = kernel_fn
    got, want = kernel_fn(), (oracle_fn or plain_fn)()
    torch.cuda.synchronize()
    if isinstance(got, tuple):
        max_err = max(_within(f"{label} [{i}]", a, b, dtype, scaled=True)
                      for i, (a, b) in enumerate(zip(got, want)))
    else:
        max_err = _within(label, got, want, dtype)
    r = {"max_abs_err": max_err,
         "ms": median_ms(timed_kernel, reps, per_pair),
         "plain_ms": median_ms(plain_fn, reps, per_pair)}
    line = (f"  {label:58s} max|err| {max_err:.3e}  kernel {r['ms']:8.4f} ms"
            f"  plain {r['plain_ms']:8.4f} ms")
    if library_fn is not None:
        r["library_ms"] = median_ms(library_fn, reps, per_pair)
        line += f"  library {r['library_ms']:8.4f} ms"
    if match is not None:
        lib_label = f"library {label}"
        if events:
            r["device_ms"] = queued_ms(timed_kernel)
            BY_EVENTS.append(label)
        else:
            r["device_ms"] = device_ms(timed_kernel, match, label=label)
        if library_fn is not None:  # timed as the kernel was
            if label in BY_EVENTS:
                r["library_device_ms"] = queued_ms(library_fn)
                BY_EVENTS.append(lib_label)
            else:
                r["library_device_ms"] = device_ms(library_fn, label=lib_label)
                if lib_label in BY_EVENTS:
                    r["device_ms"] = queued_ms(timed_kernel)
                    BY_EVENTS.append(label)
        floor = None if work is None else bound(work)[0]
        if floor is not None and label not in BY_EVENTS and min(
                r["device_ms"], r.get("library_device_ms", floor)) < floor:
            # under the least time the card could take: the profiler kept
            # part of a session's kernels; both by queued events instead
            print(f"  '{label}': a profiler time under the bound "
                  f"{floor:.4f} ms ({r['device_ms']:.4f} / "
                  f"{r.get('library_device_ms')}); both by queued events")
            r["device_ms"] = queued_ms(timed_kernel)
            BY_EVENTS.append(label)
            if library_fn is not None:
                r["library_device_ms"] = queued_ms(library_fn)
                BY_EVENTS.append(lib_label)
        r["device_by"] = "queued events" if label in BY_EVENTS else "profiler"
        line += f"  device {r['device_ms']:8.4f} ms ({r['device_by']})"
        if library_fn is not None:
            r["vs_library"] = r["device_ms"] / r["library_device_ms"]
            line += (f" (library {r['library_device_ms']:8.4f} ms, "
                     f"{r['vs_library']:.2f}x)")
    if work is not None:
        r["bound_ms"], r["bound_by"] = bound(work)
        line += f"  bound {r['bound_ms']:8.4f} ms ({r['bound_by']})"
    print(line)
    return r


def _sdpa(q, k, v, mask):
    """The library yardstick for the attention kernel: one call of
    `F.scaled_dot_product_attention` on the same q, k, v and the bias as
    a mask of q's dtype (cast once, outside the call)."""
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                          scale=q.shape[-1] ** -0.5)


def _attention_fwd(rows, label, q, k, v, bias, dtype, events=False):
    """The attention forward at one shape: kernel against plain, with the
    library call, device time (by queued events if `events`) and bound;
    its row joins `rows`."""
    from ecamp_tpu_torch.kernels import flash_attention as fa

    b, h, nq, d = q.shape
    mask = None if bias is None else bias.to(q.dtype)
    r = compare(label, fa.flash_attention, fa._attention_reference, dtype,
                library_fn=_sdpa, match="attention_fwd",
                work=attention_work(b, h, nq, k.shape[2], d, q.element_size(),
                                    0 if bias is None else bias.numel()),
                inputs=(q, k, v, bias), library_inputs=(q, k, v, mask),
                events=events)
    rows.append({"kernel": "attention", "shape": label, **r})
    return r


def _layer_norm_fwd(rows, label, x, w, b, eps, dtype, events=False):
    """The LayerNorm forward at one shape, as `_attention_fwd`; the
    library call, `F.layer_norm`, takes its weight and bias in x's dtype
    (cast once, outside the call)."""
    import torch.nn.functional as F

    from ecamp_tpu_torch.kernels import layer_norm as ln

    r = compare(label, ln.fused_layer_norm, ln._ln_reference, dtype,
                library_fn=lambda x_, w_, b_, eps_: F.layer_norm(
                    x_, (x_.shape[-1],), w_, b_, eps_),
                match="ln_fwd",
                work=layer_norm_work(x.shape[0], x.shape[1],
                                     x.element_size()),
                inputs=(x, w, b, eps),
                library_inputs=(x, w.to(x.dtype), b.to(x.dtype), eps),
                events=events)
    rows.append({"kernel": "layer_norm", "shape": label, **r})
    return r


def _attention_next_head(card, dev, gen):
    """The bf16 attention kernel at Nq = Nk = 70 (ragged last query and key
    tiles) with every odd batch*head's K and V NaN, at each head dim and
    bias kind: the even heads, whose last key tile would reach into the
    next head's rows if a box crossed heads, against the plain version."""
    import torch

    from ecamp_tpu_torch.kernels import flash_attention as fa

    worst = 0.0
    for d in (32, 64, 128):
        for kind in ("none", "key_padding", "full"):
            b, h, n = 2, 4, 70
            q, k, v = (torch.randn(b, h, n, d, device=dev, generator=gen)
                       .bfloat16() for _ in range(3))
            k[:, 1::2] = float("nan")
            v[:, 1::2] = float("nan")
            bias = None
            if kind == "key_padding":
                keep = torch.arange(n, device=dev)[None, :] < torch.tensor(
                    [[n - 3], [n // 2]], device=dev)
                bias = torch.where(keep, 0.0, torch.finfo(torch.float32).min
                                   ).reshape(b, 1, 1, n)
            elif kind == "full":
                bias = torch.randn(b, h, n, n, device=dev, generator=gen)
            got = fa.flash_attention(q, k, v, bias)[:, ::2]
            even = bias if bias is None or bias.shape[1] == 1 else bias[:, ::2]
            worst = max(worst, _within(
                f"attention next head NaN d {d} bias {kind}", got,
                fa._attention_reference(q[:, ::2], k[:, ::2], v[:, ::2],
                                        even), torch.bfloat16))
    print(f"  attention, odd heads' K and V NaN, ragged Nk = 70, d 32/64/128,"
          f" every bias kind: even heads max|err| {worst:.3e} on {card}")


def kernel_phase(card: str, rows: list) -> None:
    """LayerNorm and attention forward at the serving slice's shapes, each
    beside its library call and bound; their rows join `rows`."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    print(f"kernels vs plain versions on {card} (median of {TIMING_REPS} "
          f"CUDA-event pairs around 10 calls each; device: the profiler's "
          f"time a call)")

    for n, d, eps in ((64 * 197, 768, 1e-6), (8 * 256, 768, 1e-12)):
        x32 = torch.randn(n, d, device=dev, generator=gen) * 2 + 0.5
        w = 1 + 0.1 * torch.randn(d, device=dev, generator=gen)
        b = 0.1 * torch.randn(d, device=dev, generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            _layer_norm_fwd(rows, f"layer_norm ({n}, {d}) eps {eps:g} "
                            f"{dtype}", x32.to(dtype), w, b, eps, dtype)

    def attention_cases():
        for shape in ((64, 12, 197, 64), (8, 12, 785, 64)):
            for bias in ("none", "key_padding", "full"):
                yield shape, bias
        yield (8, 16, 197, 32), "none"          # MAE decoder width
        yield (8, 6, 256, 128), "key_padding"   # BERT width

    for (bsz, h, n, d), bias_kind in attention_cases():
        q32, k32, v32 = (torch.randn(bsz, h, n, d, device=dev, generator=gen)
                         for _ in range(3))
        bias = None
        if bias_kind == "key_padding":
            # BERT-style additive mask: finfo.min on each row's padded tail
            keep = torch.arange(n, device=dev)[None, :] < torch.randint(
                n // 2, n + 1, (bsz, 1), device=dev, generator=gen)
            bias = torch.where(keep, 0.0, torch.finfo(torch.float32).min
                               ).reshape(bsz, 1, 1, n)
        elif bias_kind == "full":
            bias = torch.randn(bsz, h, n, n, device=dev, generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = q32.to(dtype), k32.to(dtype), v32.to(dtype)
            _attention_fwd(rows, f"attention ({bsz}, {h}, {n}, {d}) bias "
                           f"{bias_kind} {dtype}", q, k, v, bias, dtype)
    _attention_next_head(card, dev, gen)
    torch.cuda.synchronize()


def _grads_of(fwd, inputs, need, gout):
    """A function that runs fwd at fresh leaves sharing `inputs` (those
    flagged in `need` require grad) and returns their gradients for the
    output gradient `gout`."""
    import torch

    def run():
        leaves = [t.detach().requires_grad_(n) for t, n in zip(inputs, need)]
        out = fwd(*leaves)
        return torch.autograd.grad(out, [t for t, n in zip(leaves, need) if n],
                                   gout)

    return run


def train_kernel_phase(card: str, rows: list):
    """The kernels at the pretraining step's shapes (B = PRE_B): LayerNorm
    and attention forward (beside their library calls and bounds) and
    forward + backward through their autograd Functions against autograd
    of the plain versions, and the SR conv stack."""
    import torch

    from ecamp_tpu_torch.kernels import flash_attention as fa
    from ecamp_tpu_torch.kernels import layer_norm as ln
    from ecamp_tpu_torch.kernels import sr_head as sr

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    b = PRE_B
    main = {}
    print(f"kernels at the pretraining step's shapes (B = {b}) on {card}; "
          f"fwd+bwd = forward and backward through the Function")

    for n, d, eps in ((b * 50, 768, 1e-6), (b * 197, 512, 1e-6),
                      (b * 256, 768, 1e-12)):
        x32 = torch.randn(n, d, device=dev, generator=gen) * 2 + 0.5
        w = 1 + 0.1 * torch.randn(d, device=dev, generator=gen)
        bias = 0.1 * torch.randn(d, device=dev, generator=gen)
        g32 = torch.randn(n, d, device=dev, generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            x, g = x32.to(dtype), g32.to(dtype)
            r = _layer_norm_fwd(rows, f"layer_norm fwd ({n}, {d}) eps {eps:g} "
                                f"{dtype}", x, w, bias, eps, dtype)
            if (n, dtype) == (b * 256, torch.bfloat16):
                main["layer_norm"] = r
            compare(f"layer_norm fwd+bwd ({n}, {d}) {dtype}",
                    _grads_of(lambda *a: ln.fused_layer_norm(*a, eps),
                              (x, w, bias), (True,) * 3, g),
                    _grads_of(lambda *a: ln._ln_reference(*a, eps),
                              (x, w, bias), (True,) * 3, g),
                    dtype, reps=10, per_pair=3)

    for (h, nq, nk, d), kind in (((12, 50, 50, 64), "encoder"),
                                 ((16, 197, 197, 32), "decoder"),
                                 ((6, 256, 256, 128), "bert self"),
                                 ((6, 256, 49, 128), "cross")):
        q32 = torch.randn(b, h, nq, d, device=dev, generator=gen)
        k32, v32 = (torch.randn(b, h, nk, d, device=dev, generator=gen)
                    for _ in range(2))
        g32 = torch.randn(b, h, nq, d, device=dev, generator=gen)
        bias = None
        if kind == "bert self":  # the key-padding mask of the captions
            keep = torch.arange(nk, device=dev)[None, :] < torch.randint(
                nk // 2, nk + 1, (b, 1), device=dev, generator=gen)
            bias = torch.where(keep, 0.0, torch.finfo(torch.float32).min
                               ).reshape(b, 1, 1, nk)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, g = (t.to(dtype) for t in (q32, k32, v32, g32))
            label = f"attention {kind} ({b}, {h}, {nq}->{nk}, {d}) {dtype}"
            r = _attention_fwd(rows, f"{label} fwd", q, k, v, bias, dtype)
            if kind == "bert self" and dtype == torch.bfloat16:
                main["attention"] = r
            compare(f"{label} fwd+bwd",
                    _grads_of(lambda q_, k_, v_: fa.flash_attention(
                        q_, k_, v_, bias), (q, k, v), (True,) * 3, g),
                    _grads_of(lambda q_, k_, v_: fa._attention_reference(
                        q_, k_, v_, bias), (q, k, v), (True,) * 3, g),
                    dtype, reps=10, per_pair=3)

    x32 = torch.randn(b, 3, 448, 448, device=dev, generator=gen)
    w1, w2 = (0.2 * torch.randn(3, 3, 3, 3, device=dev, generator=gen)
              for _ in range(2))
    b1, b2 = (0.1 * torch.randn(3, device=dev, generator=gen)
              for _ in range(2))
    for dtype in (torch.float32, torch.bfloat16):
        x = x32.to(dtype)
        # the kernel accumulates both convs in fp32 and rounds once, as the
        # Pallas kernel does; the plain bf16 convs round every conv and add
        # to bf16 (up to 2 ulps off). So the check is against the plain
        # version in fp32 on the same bf16 inputs, rounded once; the time is
        # the plain bf16 version's, which the model would run.
        check(sr.sr_path(x) == "tma", "the 448^2 SR stack is not on the "
              "TMA kernel")
        r = compare(f"sr_conv_stack fwd ({b}, 3, 448, 448) {dtype} "
                    f"[{sr.sr_path(x)}]",
                    sr.sr_conv_stack, sr._sr_reference, dtype,
                    oracle_fn=lambda x_, *w: sr._sr_reference(
                        x_.float(), *w).to(x_.dtype),
                    match="sr_conv_stack",
                    work=sr_work(b, 448, 448, x.element_size()),
                    inputs=(x, w1, b1, w2, b2))
        if dtype == torch.bfloat16:
            main["sr_conv_stack"] = r
    _sr_edges(card, dev, gen, (w1, b1, w2, b2))
    torch.cuda.synchronize()
    return main


def _sr_edges(card, dev, gen, weights):
    """The SR kernels where a tile's edges can break: ragged last row and
    column tiles, an image smaller than a tile (both on the TMA kernel),
    and the generic kernel's shapes: W * itemsize not a multiple of 16, and
    an input whose data starts one element (2 or 4 bytes) past a 16-byte
    boundary; each in fp32 and bf16, against the plain version in fp32
    rounded once, with the path each took."""
    import torch

    from ecamp_tpu_torch.kernels import sr_head as sr

    cases = (((2, 3, 33, 136), False, "tma"), ((1, 3, 8, 8), False, "tma"),
             ((2, 3, 33, 129), False, "generic"),
             ((2, 3, 33, 136), True, "generic"))
    for shape, offset, path in cases:
        for dtype in (torch.float32, torch.bfloat16):
            n = torch.Size(shape).numel()
            base = torch.randn(n + 1, device=dev, generator=gen).to(dtype)
            x = (base[1:] if offset else base[:n]).view(shape)
            label = (f"sr_conv_stack fwd {shape}"
                     f"{' at storage offset 1' if offset else ''} {dtype}")
            check(sr.sr_path(x) == path, f"{label}: path {sr.sr_path(x)}, "
                  f"not {path}")
            before = sr.launches_tma.value
            got = sr.sr_conv_stack(x, *weights)
            torch.cuda.synchronize()
            check(sr.launches_tma.value - before == (path == "tma"),
                  f"{label}: the TMA kernel's launches")
            err = _within(label, got, sr._sr_reference(
                x.float(), *weights).to(dtype), dtype)
            print(f"  {label:58s} [{path}] max|err| {err:.3e} on {card}")


def _lib_call(name, *args) -> None:
    """One C entry point of the kernel library on the current stream."""
    import torch

    from ecamp_tpu_torch.kernels import _build

    _build.check(getattr(_build.library(), name)(
        *args, torch.cuda.current_stream().cuda_stream), name)


def chunk_kernels(x, w, b, labels, lse, wg, chunk, shape, timed):
    """Each kernel of the tensor-core backward alone, on the first vocab
    chunk, against its plain version on the same inputs: dl (dl' and the
    partial column sums), then dx and dW + db fed the plain dl' and
    partials. With `timed`, each one's times, device time and bound too.
    Returns {"dl" | "dx" | "dw": what compare() measured}."""
    import torch

    from ecamp_tpu_torch.kernels import fused_mlm_loss as mlm

    n, d = x.shape
    v = w.shape[0]
    width = min(chunk, v)
    ld = -(-width // 8) * 8
    dev, size = x.device, x.element_size()
    lab = labels.to(torch.int64).contiguous()
    dl = torch.empty(n, ld, dtype=x.dtype, device=dev)
    partials = torch.empty(-(-n // mlm.TILE_M), ld, device=dev)
    dx = torch.empty_like(x)
    dw = torch.zeros_like(w)
    db = torch.zeros(v, device=dev)
    want_dl, want_partials = mlm._dl_chunk_plain(x, w, b, labels, lse, wg, 0,
                                                 width)
    dlc = torch.zeros_like(dl)
    dlc[:, :width] = want_dl
    pc = torch.zeros_like(partials)
    pc[:, :width] = want_partials

    def dl_kernel():
        _lib_call("ecamp_fused_ce_bwd_dl", x.data_ptr(), w.data_ptr(),
                  b.data_ptr(), lab.data_ptr(), lse.data_ptr(), wg.data_ptr(),
                  dl.data_ptr(), partials.data_ptr(), n, v, d, 0, width, ld)
        return dl[:, :width], partials[:, :width]

    def dx_kernel():  # one chunk, first and last: dx in bf16 at once
        _lib_call("ecamp_fused_ce_bwd_dx_chunk", dlc.data_ptr(), w.data_ptr(),
                  dx.data_ptr(), dx.data_ptr(), n, v, d, 0, width, ld, 1, 1)
        return (dx,)

    def dw_kernel():
        _lib_call("ecamp_fused_ce_bwd_dw_chunk", dlc.data_ptr(), x.data_ptr(),
                  pc.data_ptr(), dw.data_ptr(), db.data_ptr(), n, v, d, 0,
                  width, ld)
        return dw[:width], db[:width]

    product = 2 * n * d * width
    parts = (
        ("dl", dl_kernel,
         lambda: mlm._dl_chunk_plain(x, w, b, labels, lse, wg, 0, width),
         (product, size * (n * d + width * d + n * width) + 16 * n
          + 4 * width * (1 + partials.shape[0]), "bf16")),
        ("dx", dx_kernel,
         lambda: (mlm._dx_chunk_plain(want_dl, w, 0).to(x.dtype),),
         (product, size * (n * width + width * d + n * d), "bf16")),
        ("dw", dw_kernel,
         lambda: mlm._dw_chunk_plain(want_dl, x, want_partials),
         (product, size * (n * width + n * d + width * d)
          + 4 * width * (1 + partials.shape[0]), "bf16")))
    out = {}
    for name, kernel_fn, plain_fn, work in parts:
        label = f"fused CE bwd {name} kernel, chunk 0 of {width}, {shape}"
        out[name] = compare(label, kernel_fn, plain_fn, x.dtype, reps=5,
                            per_pair=2,
                            match=f"fused_ce_bwd_{name}" if timed else None,
                            work=work if timed else None)
    return out


def fwd_kernels(x, w, b, labels, shape, timed):
    """The tensor-core forward's two kernels, each alone against its plain
    version on the same inputs: the tile kernel (every row's (max,
    sum-exp) of every 128-wide vocab tile, and the gold logits of the rows
    whose label is in range), then the merge fed the plain stats. With
    `timed`, each one's times (on rotated copies of its inputs), device
    time and bound too. Returns {"tiles" | "merge": what compare()
    measured}."""
    import torch

    from ecamp_tpu_torch.kernels import fused_mlm_loss as mlm

    n, d = x.shape
    v = w.shape[0]
    tiles = -(-v // mlm.TILE_V)
    lab = labels.to(torch.int64).contiguous()
    want_stats, want_gold = mlm._fwd_tiles_plain(x, w, b, lab)

    def tiles_kernel(x_, w_, b_, lab_):
        # gold of a label out of range is the merge's: 0 here as there
        stats = torch.empty(tiles, n, 2, device=x_.device)
        gold = torch.zeros(n, device=x_.device)
        _lib_call("ecamp_fused_ce_fwd_tiles", x_.data_ptr(), w_.data_ptr(),
                  b_.data_ptr(), lab_.data_ptr(), stats.data_ptr(),
                  gold.data_ptr(), n, v, d, tiles)
        return stats, gold

    def merge_kernel(stats, lab_, gold):
        lse = torch.empty(n, device=stats.device)
        gold = gold.clone()
        _lib_call("ecamp_fused_ce_fwd_merge", stats.data_ptr(),
                  lab_.data_ptr(), lse.data_ptr(), gold.data_ptr(), n, v,
                  tiles)
        return lse, gold

    def merge_plain(stats, lab_, gold):
        return mlm._fwd_merge_plain(stats, lab_, gold, v)

    parts = (("tiles", tiles_kernel, mlm._fwd_tiles_plain, (x, w, b, lab),
              fused_ce_fwd_tiles_work(n, d, v, x.element_size(), tiles)),
             ("merge", merge_kernel, merge_plain, (want_stats, lab, want_gold),
              fused_ce_fwd_merge_work(n, tiles)))
    out = {}
    for name, kernel_fn, plain_fn, inputs, work in parts:
        # outputs of fp32 math, held at the fp32 tolerance of their scale
        out[name] = compare(f"fused CE fwd {name} kernel, {shape}", kernel_fn,
                            plain_fn, torch.float32, reps=5, per_pair=2,
                            match=f"fused_ce_fwd_{name}" if timed else None,
                            work=work if timed else None, inputs=inputs)
    return out


def mainloop_rows(n, d, chunk, gen):
    """The tensor-core backward's mainloop alone (`wgmma_gemm`, fp32 out)
    at the shapes of one chunk's three products, beside `torch.matmul` of
    the same bf16 operands (a yardstick the port never calls): device ms
    a call and TFLOP/s of each."""
    import torch

    from ecamp_tpu_torch.kernels import fused_mlm_loss as mlm

    rows = []
    for layout, (m, nn, k) in (("dl", (n, chunk, d)), ("dx", (n, d, chunk)),
                               ("dw", (chunk, d, n))):
        a = torch.randn(m, k, device="cuda", generator=gen).bfloat16()
        b = torch.randn(k, nn, device="cuda", generator=gen).bfloat16()
        code = ("dl", "dx", "dw").index(layout)
        ka, kb = {0: (a, b.T.contiguous()), 1: (a, b),
                  2: (a.T.contiguous(), b)}[code]
        ms = device_ms(lambda: mlm.wgmma_gemm(ka, kb, code), "wgmma_gemm", 10,
                       f"mainloop {layout}")
        lib = device_ms(lambda: a @ b, "", 10, f"matmul {layout}")
        flops = 2 * m * nn * k
        rows.append({"layout": layout, "m": m, "n": nn, "k": k,
                     "device_ms": ms, "tflops": flops / ms / 1e9,
                     "matmul_device_ms": lib,
                     "matmul_tflops": flops / lib / 1e9})
        print(f"  mainloop {layout} ({m} x {nn} over {k}): {ms:.4f} ms "
              f"{flops / ms / 1e9:.1f} TFLOP/s; torch.matmul bf16 {lib:.4f} "
              f"ms {flops / lib / 1e9:.1f} TFLOP/s")
        del a, b, ka, kb
    return rows


def fused_ce_phase(card: str):
    """The fused vocab-projection + CE kernels against their plain versions
    on the same inputs: at the pretraining step's shape (PRE_B * 256 rows,
    768, 30000) in bf16, checked against the plain math in fp32 on the same
    bf16 inputs (loss within 1e-3 relative, dx / dW / db at atol = rtol =
    1.6e-2 of their scale), at a ragged fp32 shape (1e-5; the FMA
    backward), and at a ragged bf16 shape with the vocab chunk lowered to
    1024 (three chunks, the last ragged, a label in each). Times the
    forward (against the materialised `_fused_reference`), forward +
    backward through the Function, the backward alone, and at the main
    shape each of the tensor-core backward's three kernels by name."""
    import torch

    from ecamp_tpu_torch.kernels import fused_mlm_loss as mlm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    main = {}
    print(f"fused vocab projection + weighted CE on {card}")
    default_chunk = mlm.CHUNK_V
    try:
        for case in (((PRE_B * 256, 768, 30000), torch.bfloat16, 1e-3,
                      default_chunk),
                     ((1000, 96, 3001), torch.float32, FP32_TOL,
                      default_chunk),
                     ((1000, 96, 3001), torch.bfloat16, 1e-3, 1024)):
            mlm.CHUNK_V = case[3]  # lowered for the last case only
            main.update(_fused_ce_case(card, gen, *case,
                                       main_shape=case[3] == default_chunk
                                       and case[1] == torch.bfloat16))
    finally:
        mlm.CHUNK_V = default_chunk
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return main


def _fused_ce_case(card, gen, nvd, dtype, loss_tol, chunk, main_shape):
    """One shape of `fused_ce_phase`, with mlm.CHUNK_V set to `chunk`;
    returns the main shape's forward and backward times by kernel name."""
    import torch

    from ecamp_tpu_torch.kernels import fused_mlm_loss as mlm

    dev = torch.device("cuda")
    main = {}
    n, d, v = nvd
    x = (torch.randn(n, d, device=dev, generator=gen)).to(dtype)
    w = (0.05 * torch.randn(v, d, device=dev, generator=gen)).to(dtype)
    b = 0.1 * torch.randn(v, device=dev, generator=gen)
    labels = torch.randint(0, v, (n,), device=dev, generator=gen)
    chunks = mlm._chunks(v, chunk)
    for i, (v0, width) in enumerate(chunks):
        labels[i] = v0 + width - 1  # a label in every chunk, the last too
    labels[len(chunks)] = v - 1  # in the last, ragged vocab tile
    weights = 2 * torch.rand(n, device=dev, generator=gen)
    gout = torch.full((), 1.0 / n, device=dev)  # the caller's mean
    shape = f"({n}, {d}, {v}) {dtype}"
    if not main_shape and dtype == torch.bfloat16:
        shape += f" chunk {chunk}"
    tensor_cores = mlm._tensor_core_path(x, w)

    def ref():
        return mlm._fused_reference(x, w, b, labels, weights)

    fwd = rotated(mlm.fused_mlm_loss_sum, (x, w, b, labels, weights))
    got, want = float(mlm.fused_mlm_loss_sum(x, w, b, labels, weights)), \
        float(ref())
    rel = abs(got - want) / abs(want)
    check(rel <= loss_tol, f"fused CE fwd {shape}: {got:.7g} vs "
          f"{want:.7g} (rel {rel:.3e})")
    fwd_times = {"max_abs_err": abs(got - want), "rel_err": rel,
                 "ms": median_ms(fwd, 10, 3),
                 "plain_ms": median_ms(ref, 10, 3),
                 "device_ms": device_ms(fwd, "fused_ce_fwd", 5,
                                        f"fused CE fwd {shape}")}
    fwd_times["bound_ms"], fwd_times["bound_by"] = bound(
        fused_ce_fwd_work(n, d, v, x.element_size()))
    print(f"  {'fused CE fwd ' + shape:58s} rel err {rel:.3e}  kernel "
          f"{fwd_times['ms']:8.4f} ms  plain {fwd_times['plain_ms']:8.4f}"
          f" ms  device {fwd_times['device_ms']:8.4f} ms  bound "
          f"{fwd_times['bound_ms']:8.4f} ms ({fwd_times['bound_by']})")

    compare(f"fused CE fwd+bwd {shape}",
            _grads_of(lambda *a: mlm.fused_mlm_loss_sum(
                *a, labels, weights), (x, w, b), (True,) * 3, gout),
            _grads_of(lambda *a: mlm.fused_mlm_loss_sum(
                *a, labels, weights, plain=True), (x, w, b), (True,) * 3,
                gout), dtype, reps=5, per_pair=2)
    lse, _ = mlm._forward_plain(x, w, b, labels)
    wg = gout * weights
    if main_shape or dtype == torch.float32:
        plain_bwd = lambda: mlm._fused_backward_plain(  # noqa: E731
            x, w, b, labels, lse, wg)
    else:
        plain_bwd = lambda: mlm._backward_chunked_plain(  # noqa: E731
            x, w, b, labels, lse, wg)
    before = mlm.launches_dl.value
    bwd_times = compare(
        f"fused CE bwd (dx, dW, db) {shape}", mlm._backward_cuda,
        lambda *a: plain_bwd(), dtype, reps=5, per_pair=2,
        match="fused_ce_bwd",
        work=fused_ce_bwd_work(n, d, v, x.element_size()),
        inputs=(x, w, b, labels, lse, wg))
    check(tensor_cores == (dtype == torch.bfloat16), f"{shape}: "
          f"tensor-core path {tensor_cores}")
    if tensor_cores:
        check(mlm.launches_dl.value > before,
              f"{shape}: the dl kernel did not run")
        fparts = fwd_kernels(x, w, b, labels, shape, timed=main_shape)
        parts = chunk_kernels(x, w, b, labels, lse, wg, chunk, shape,
                              timed=main_shape)
    if main_shape:
        total = sum(parts[k]["device_ms"] or 0.0 for k in parts)
        print(f"  fused CE bwd at {shape}: dl {_ms(parts['dl']['device_ms'])}"
              f" + dx {_ms(parts['dx']['device_ms'])} + dW "
              f"{_ms(parts['dw']['device_ms'])} on one {chunk}-row chunk "
              f"= {total:.4f} ms; {len(chunks)} chunks a call; the whole "
              f"backward {_ms(bwd_times['device_ms'])} device, bound "
              f"{bwd_times['bound_ms']:.4f} ms")
        bwd_times.update(chunk=chunk, chunks=len(chunks),
                         parts_first_chunk=parts,
                         parts_first_chunk_device_ms=total,
                         mainloop=mainloop_rows(n, d, chunk, gen))
        print(f"  fused CE fwd at {shape}: tiles "
              f"{_ms(fparts['tiles']['device_ms'])} (bound "
              f"{fparts['tiles']['bound_ms']:.4f} ms) + merge "
              f"{_ms(fparts['merge']['device_ms'])} (bound "
              f"{fparts['merge']['bound_ms']:.4f} ms); the whole forward "
              f"{_ms(fwd_times['device_ms'])} device")
        fwd_times["parts"] = fparts
        main["fused_ce_fwd"], main["fused_ce_bwd"] = fwd_times, bwd_times
    del x, w, lse
    return main


def pretrain_phase(card: str):
    import dataclasses
    import gc

    import numpy as np
    import torch

    from ecamp_tpu_torch.core.config import OptimizerConfig, PretrainConfig
    from ecamp_tpu_torch.kernels import flash_attention as fa
    from ecamp_tpu_torch.kernels import fused_adamw as adamw
    from ecamp_tpu_torch.kernels import fused_mlm_loss as mlm
    from ecamp_tpu_torch.kernels import layer_norm as ln
    from ecamp_tpu_torch.kernels import sr_head as sr
    from ecamp_tpu_torch.train.pretrain import PretrainTask, synthetic_batch

    counters = {"layer_norm": ln.launches, "attention": fa.launches,
                "sr_conv_stack": sr.launches,
                "sr_conv_stack_tma": sr.launches_tma, "adamw": adamw.launches}
    # what earlier phases left in reference cycles (the serving model, held
    # by the profiler's frames) stays out of the steps' device memory
    gc.collect()
    torch.cuda.empty_cache()
    cfg = PretrainConfig(optimizer=OptimizerConfig(schedule="constant",
                                                   lr=1.5e-4), seed=SEED)
    t0 = time.perf_counter()
    task = PretrainTask(cfg, device="cuda")
    model = task.model
    n_params = sum(p.numel() for p in model.parameters())
    c, dc, bc = cfg.vit, cfg.decoder, cfg.bert
    # launches a step, from the module tree: two LayerNorms a block plus the
    # final norm (encoder, decoder); BERT embeddings 1 + fusion layer 3 + 2 a
    # layer + MLM head 1; one attention a block, fusion self + cross, one a
    # BERT layer; one SR conv stack, by the TMA kernel (448^2 bf16 images);
    # one AdamW update
    per_step = {"layer_norm": (2 * c.depth + 1) + (2 * dc.depth + 1)
                + (1 + 3 + 2 * bc.num_hidden_layers + 1),
                "attention": c.depth + dc.depth + 2 + bc.num_hidden_layers,
                "sr_conv_stack": 1, "sr_conv_stack_tma": 1, "adamw": 1}
    gen = torch.Generator(device=task.device).manual_seed(SEED + 3)
    batch = synthetic_batch(cfg, PRE_B, gen)
    noise = torch.rand(PRE_B, c.num_patches, device=task.device,
                       generator=gen)
    # the initial weights wait on the host, out of the steps' peak memory
    init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    torch.cuda.synchronize()
    print(f"pretrain slice on {card}: ECAMP ViT-B/16 {cfg.data.img_size} -> "
          f"{c.img_size}, decoder {dc.embed_dim}/{dc.depth}/{dc.num_heads}, "
          f"BERT {bc.num_hidden_layers} layers hidden {bc.hidden_size} vocab "
          f"{bc.vocab_size}, L = {cfg.max_caption_length}, {n_params} "
          f"parameters, B = {PRE_B}, bf16 compute, AdamW lr "
          f"{cfg.optimizer.lr:g} constant; built in "
          f"{time.perf_counter() - t0:.1f} s")
    check(n_params == 182_582_488, f"{n_params} parameters")

    def first_step(plain: bool):
        model.load_state_dict(init)
        task.set_plain(plain)
        state = task.init_state()
        for ctr in counters.values():
            ctr.reset()
        state, m = task.train_step(state, batch, noise=noise,
                                   deterministic=True)
        gnorm = adamw.global_norm([p.grad for p in state.params.values()])
        torch.cuda.synchronize()
        n = {k: ctr.value for k, ctr in counters.items()}
        return state, {k: float(v) for k, v in m.items()}, float(gnorm), n

    # (a), (b): the first step through the kernels, then the plain versions
    state, loss_k, gnorm_k, n_k = first_step(False)
    print(f"  (b) kernel step: {json.dumps(loss_k)} grad norm {gnorm_k:.6g} "
          f"launches {n_k}")
    check(all(np.isfinite(v) for v in loss_k.values()), "non-finite loss")
    check(abs(loss_k["mlm_loss"] - LN_V) < 0.5,
          f"(a) mlm {loss_k['mlm_loss']:.4f} not within 0.5 of ln 30000")
    check(n_k == per_step, f"(d) launches {n_k} != {per_step}")

    # the AdamW kernel on the whole parameter set, from the moments and
    # grads of that step, against the per-leaf formula
    grads = {k: p.grad for k, p in state.params.items()}
    opt = state.opt_state

    def adamw_copy():
        return ({k: p.detach().clone() for k, p in state.params.items()},
                adamw.AdamWState(count=opt.count.clone(),
                                 mu={k: t.clone() for k, t in opt.mu.items()},
                                 nu={k: t.clone() for k, t in opt.nu.items()}))

    task.tx.plain = False
    pk, sk = adamw_copy()
    task.tx.apply(pk, grads, sk)
    task.tx.plain = True
    pp, sp = adamw_copy()
    task.tx.apply(pp, grads, sp)
    torch.cuda.synchronize()
    err = 0.0
    for k in pk:
        for got, want in ((pk[k], pp[k]), (sk.mu[k], sp.mu[k]),
                          (sk.nu[k], sp.nu[k])):
            d = (got - want).abs()
            check(bool((d <= 1e-6 * want.abs() + 1e-12).all()),
                  f"adamw {k}: max |err| {float(d.max()):.3e}")
        err = max(err, float((pk[k] - pp[k]).abs().max()))
    task.tx.plain = False
    adamw_times = {"max_abs_err": err,
                   "ms": median_ms(lambda: task.tx.apply(pk, grads, sk), 10,
                                   2),
                   "device_ms": device_ms(lambda: task.tx.apply(pk, grads,
                                                                sk),
                                          "adamw_multi", 5, "adamw")}
    task.tx.plain = True
    adamw_times["plain_ms"] = median_ms(lambda: task.tx.apply(pp, grads, sp),
                                        10, 2)
    task.tx.plain = False
    adamw_times["bound_ms"], adamw_times["bound_by"] = bound(
        adamw_work(n_params))
    print(f"  {'adamw update, ' + str(n_params) + ' fp32 parameters':58s} "
          f"max|err| {err:.3e}  kernel {adamw_times['ms']:8.4f} ms  plain "
          f"{adamw_times['plain_ms']:8.4f} ms  device "
          f"{adamw_times['device_ms']:8.4f} ms  bound "
          f"{adamw_times['bound_ms']:8.4f} ms ({adamw_times['bound_by']})")
    del pk, sk, pp, sp, grads, opt, state

    pstate, loss_p, gnorm_p, n_p = first_step(True)
    del pstate  # its moments would count in the steps' peak memory
    print(f"  (b) plain step:  {json.dumps(loss_p)} grad norm {gnorm_p:.6g} "
          f"launches {n_p}")
    check(all(v == 0 for v in n_p.values()), f"plain step launched {n_p}")
    for k in ("mim_loss", "res_loss", "mlm_loss"):
        rel = abs(loss_k[k] - loss_p[k]) / abs(loss_p[k])
        check(rel <= LOSS_TOL, f"(b) {k}: kernel {loss_k[k]:.6g} vs plain "
              f"{loss_p[k]:.6g} (rel {rel:.3e})")
    check(abs(gnorm_k - gnorm_p) <= GNORM_TOL * gnorm_p,
          f"(b) grad norm {gnorm_k:.6g} vs plain {gnorm_p:.6g}")

    def steps(task, counters):
        """PRE_STEPS steps (dropout on) from `init`, counters set to 0 just
        before and read just after; returns (losses, step ms, launches,
        peak device memory)."""
        task.model.load_state_dict(init)
        task.set_plain(False)
        state = task.init_state()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        print(f"  allocated before the steps: "
              f"{torch.cuda.memory_allocated()} bytes")
        for ctr in counters.values():
            ctr.reset()
        losses, times = [], []
        for _ in range(PRE_STEPS):
            t = time.perf_counter()
            state, m = task.train_step(state, batch, noise=noise)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            losses.append(float(m["loss"]))
        launches = {k: ctr.value for k, ctr in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        # the device's busy time in a step, and the fused CE's and
        # attention's parts of it (the profiler over 3 more steps; outside
        # the counts above)
        box = [state]

        def one_step():
            box[0], _ = task.train_step(box[0], batch, noise=noise)

        busy = {k: device_ms(one_step, match, 3, f"step {k}", alone=False)
                for k, match in (("busy", ""), ("fused_ce", "fused_ce"),
                                 ("attention", "attention_fwd"))}
        return losses, times, launches, peak, busy

    def report(tag, per_step, losses, times, launches, peak, busy):
        print(f"  ({tag}) loss over {PRE_STEPS} steps (dropout on): "
              f"{[round(x, 5) for x in losses]}")
        check(all(np.isfinite(losses)), f"({tag}) non-finite loss")
        check(losses[-1] < losses[0], f"({tag}) loss did not fall: {losses}")
        want = {k: v * PRE_STEPS for k, v in per_step.items()}
        print(f"  ({tag}) launches in {PRE_STEPS} steps {launches} (per step "
              f"{per_step})")
        check(launches == want, f"({tag}) launches {launches} != {want}")
        step_ms = float(np.median(times[1:]))
        print(f"  ({tag}) step {step_ms:.3f} ms median of steps "
              f"2-{PRE_STEPS} (host clock, synchronised), "
              f"{PRE_B / step_ms * 1e3:.2f} images/s, peak device memory "
              f"{peak / 2 ** 30:.3f} GiB on {card}")
        print(f"  ({tag}) device busy {_ms(busy['busy'])} a step, fused CE "
              f"kernels {_ms(busy['fused_ce'])}, attention kernel "
              f"{_ms(busy['attention'])} (profiler, 3 steps)")
        return {"step_ms_median": step_ms, "step_ms": times,
                "images_per_s": PRE_B / step_ms * 1e3,
                "max_memory_allocated_bytes": peak, "losses": losses,
                "device_busy_ms": busy["busy"],
                "fused_ce_device_ms": busy["fused_ce"],
                "attention_device_ms": busy["attention"]}

    # (c), (d), (e): PRE_STEPS training steps through the kernels
    losses, times, launches, peak, busy = steps(task, counters)
    result = {"batch": PRE_B, "loss_first_step": loss_k,
              "loss_plain_step": loss_p, "grad_norm": gnorm_k,
              "grad_norm_plain": gnorm_p, "card": card,
              **report("c-e", per_step, losses, times, launches, peak, busy)}
    del task, model
    torch.cuda.empty_cache()

    # (f): the fused-CE configuration from the same weights, batch and
    # noise: its first step against the materialised plain step of (b),
    # then PRE_STEPS steps
    # the bf16 backward runs dl, dx and dW once a vocab chunk
    n_chunks = len(mlm._chunks(cfg.bert.vocab_size, mlm.CHUNK_V))
    fcounters = dict(counters, fused_ce_fwd=mlm.launches_fwd,
                     fused_ce_merge=mlm.launches_merge,
                     fused_ce_dl=mlm.launches_dl, fused_ce_dx=mlm.launches_dx,
                     fused_ce_dw=mlm.launches_dw)
    # the bf16 forward: its tile kernel and its merge once each
    fper_step = dict(per_step, fused_ce_fwd=1, fused_ce_merge=1,
                     fused_ce_dl=n_chunks, fused_ce_dx=n_chunks,
                     fused_ce_dw=n_chunks)
    ftask = PretrainTask(dataclasses.replace(cfg, fused_mlm_ce=True),
                         device="cuda")
    ftask.model.load_state_dict(init)
    fstate = ftask.init_state()
    for ctr in fcounters.values():
        ctr.reset()
    fstate, m = ftask.train_step(fstate, batch, noise=noise,
                                 deterministic=True)
    gnorm_f = float(adamw.global_norm([p.grad for p in
                                       fstate.params.values()]))
    n_f = {k: ctr.value for k, ctr in fcounters.items()}
    loss_f = {k: float(v) for k, v in m.items()}
    del fstate, m
    print(f"  (f) fused-CE kernel step: {json.dumps(loss_f)} grad norm "
          f"{gnorm_f:.6g} launches {n_f}")
    check(n_f == fper_step, f"(f) launches {n_f} != {fper_step}")
    for k in ("mim_loss", "res_loss", "mlm_loss"):
        rel = abs(loss_f[k] - loss_p[k]) / abs(loss_p[k])
        check(rel <= LOSS_TOL, f"(f) {k}: fused {loss_f[k]:.6g} vs "
              f"materialised plain {loss_p[k]:.6g} (rel {rel:.3e})")
    check(abs(gnorm_f - gnorm_p) <= GNORM_TOL * gnorm_p,
          f"(f) grad norm {gnorm_f:.6g} vs plain {gnorm_p:.6g}")
    flosses, ftimes, flaunches, fpeak, fbusy = steps(ftask, fcounters)
    result["fused_ce"] = {"loss_first_step": loss_f, "grad_norm": gnorm_f,
                          **report("f", fper_step, flosses, ftimes, flaunches,
                                   fpeak, fbusy)}
    print(f"  (f) against (e): step {result['fused_ce']['step_ms_median']:.3f}"
          f" vs {result['step_ms_median']:.3f} ms, peak device memory "
          f"{fpeak} vs {peak} bytes ({(fpeak - peak) / 2 ** 30:+.3f} GiB), "
          f"device busy {_ms(fbusy['busy'])} vs {_ms(busy['busy'])}")
    del ftask, init
    torch.cuda.empty_cache()
    return launches, flaunches, adamw_times, result


def recipe_phase(card: str) -> dict:
    """The recipe's micro-batch (pretrain_mimic: B = RECIPE_B, accumulation
    over RECIPE_ACCUM micro-steps; `PretrainTask` at full width, bf16, AdamW
    at a constant lr): (e) the materialised MLM loss and (f) the fused CE,
    each RECIPE_ACCUM micro-steps on seeded synthetic batches, one update.
    The counters are set to 0 before the micro-steps and read after them:
    LayerNorm, attention, SR (and the fused CE) a micro-step as in the
    pretraining slice, AdamW once. The parameters stay bit-unchanged
    through micro-steps 1 to RECIPE_ACCUM - 1 and change at the last. Per
    micro-step ms (host clock, synchronised), images/s, peak device
    memory; the host ms of `MultiSteps`' per-leaf fold of one micro-step's
    gradients and its device time. Then the accumulation through the
    kernels: two micro-steps of ACCUM_HALF_B against one step of PRE_B on
    the same images and noise, dropout off: the mean gradient that reaches
    AdamW within ACCUM_TOL (relative L2) of the whole batch's."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from ecamp_tpu_torch.core.config import OptimizerConfig, PretrainConfig
    from ecamp_tpu_torch.kernels import flash_attention as fa
    from ecamp_tpu_torch.kernels import fused_adamw as adamw
    from ecamp_tpu_torch.kernels import fused_mlm_loss as mlm
    from ecamp_tpu_torch.kernels import layer_norm as ln
    from ecamp_tpu_torch.kernels import sr_head as sr
    from ecamp_tpu_torch.train.optim import MultiStepsState
    from ecamp_tpu_torch.train.pretrain import PretrainTask, synthetic_batch
    from ecamp_tpu_torch.train.state import adamw_state

    gc.collect()
    torch.cuda.empty_cache()
    cfg = PretrainConfig(optimizer=OptimizerConfig(
        schedule="constant", lr=1.5e-4, accum_steps=RECIPE_ACCUM), seed=SEED)
    c, dc, bc = cfg.vit, cfg.decoder, cfg.bert
    n_chunks = len(mlm._chunks(bc.vocab_size, mlm.CHUNK_V))
    counters = {"layer_norm": ln.launches, "attention": fa.launches,
                "sr_conv_stack": sr.launches,
                "sr_conv_stack_tma": sr.launches_tma, "adamw": adamw.launches,
                "fused_ce_fwd": mlm.launches_fwd,
                "fused_ce_merge": mlm.launches_merge,
                "fused_ce_dl": mlm.launches_dl, "fused_ce_dx": mlm.launches_dx,
                "fused_ce_dw": mlm.launches_dw}
    # a micro-step's launches (as `pretrain_phase` counts them), AdamW aside
    micro = {"layer_norm": (2 * c.depth + 1) + (2 * dc.depth + 1)
             + (1 + 3 + 2 * bc.num_hidden_layers + 1),
             "attention": c.depth + dc.depth + 2 + bc.num_hidden_layers,
             "sr_conv_stack": 1, "sr_conv_stack_tma": 1}
    fused_micro = {"fused_ce_fwd": 1, "fused_ce_merge": 1,
                   "fused_ce_dl": n_chunks, "fused_ce_dx": n_chunks,
                   "fused_ce_dw": n_chunks}
    print(f"the recipe's micro-batch on {card}: B = {RECIPE_B}, accumulation "
          f"over {RECIPE_ACCUM} micro-steps (one update), AdamW lr "
          f"{cfg.optimizer.lr:g} constant")
    result = {"batch": RECIPE_B, "accum": RECIPE_ACCUM, "card": card}
    for tag, fused in (("e", False), ("f", True)):
        task = PretrainTask(dataclasses.replace(cfg, fused_mlm_ce=fused),
                            device="cuda")
        state = task.init_state()
        before = {k: p.detach().cpu().clone() for k, p in state.params.items()}
        want = {k: 0 for k in counters}
        want.update({k: v * RECIPE_ACCUM for k, v in micro.items()})
        if fused:
            want.update({k: v * RECIPE_ACCUM for k, v in fused_micro.items()})
        want["adamw"] = 1
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for ctr in counters.values():
            ctr.reset()
        times, losses, unchanged = [], [], []
        for i in range(RECIPE_ACCUM):
            batch = synthetic_batch(cfg, RECIPE_B, torch.Generator(
                device="cuda").manual_seed(SEED + 100 + i))
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = task.train_step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            losses.append(float(m["loss"]))
            del batch, m
            unchanged.append(all(torch.equal(p.detach().cpu(), before[k])
                                 for k, p in state.params.items()))
        launches = {k: ctr.value for k, ctr in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        print(f"  ({tag}) {RECIPE_ACCUM} micro-steps: losses "
              f"{[round(x, 5) for x in losses]}, parameters unchanged after "
              f"each {unchanged}, launches {launches}")
        check(all(np.isfinite(losses)), f"({tag}) non-finite loss")
        check(unchanged == [True] * (RECIPE_ACCUM - 1) + [False],
              f"({tag}) parameters unchanged after the micro-steps: "
              f"{unchanged}")
        check(launches == want, f"({tag}) launches {launches} != {want}")
        count = int(adamw_state(state.opt_state).count)
        check(count == 1 and state.opt_state.mini_step == 0,
              f"({tag}) AdamW count {count}, cycle at "
              f"{state.opt_state.mini_step}")
        step_ms = float(np.median(times[1:]))
        print(f"  ({tag}) micro-step {step_ms:.3f} ms median of micro-steps "
              f"2-{RECIPE_ACCUM} (host clock, synchronised; the last, with "
              f"the update, {times[-1]:.3f} ms), "
              f"{RECIPE_B / step_ms * 1e3:.2f} images/s, peak device memory "
              f"{peak / 2 ** 30:.3f} GiB on {card}")
        run = {"micro_step_ms_median": step_ms, "micro_step_ms": times,
               "images_per_s": RECIPE_B / step_ms * 1e3,
               "max_memory_allocated_bytes": peak,
               "peak_gib": peak / 2 ** 30, "losses": losses,
               "launches": launches}
        if not fused:
            # MultiSteps' fold of one micro-step's gradients into the
            # running mean, alone: the host's time to issue it (the stream
            # drained first) and the device's
            params = state.params
            grads = {k: p.grad for k, p in params.items()}
            cycle = MultiStepsState(0, state.opt_state.inner_opt_state,
                                    state.opt_state.acc_grads)

            def fold():
                task.tx.apply(params, grads, cycle)

            host = []
            for _ in range(TIMING_REPS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                fold()
                host.append((time.perf_counter() - t) * 1e3)
            torch.cuda.synchronize()
            run["fold_host_ms"] = float(np.median(host))
            run["fold_device_ms"] = device_ms(fold, "", 5, "multisteps fold")
            print(f"  ({tag}) MultiSteps fold of {len(grads)} leaves: host "
                  f"{run['fold_host_ms']:.3f} ms (median of {TIMING_REPS}), "
                  f"device {_ms(run['fold_device_ms'])}")
            del params, grads, cycle
        result[tag] = run
        del task, state, before
        gc.collect()
        torch.cuda.empty_cache()

    # the mean of two micro-steps' gradients against one step's on the
    # same images: the fold is the whole batch's mean gradient
    acfg = dataclasses.replace(cfg, optimizer=dataclasses.replace(
        cfg.optimizer, accum_steps=2))
    task = PretrainTask(acfg, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    batch = synthetic_batch(acfg, PRE_B, gen)
    noise = torch.rand(PRE_B, c.num_patches, device="cuda", generator=gen)
    state = task.init_state()
    state, _ = task.train_step(state, batch, noise=noise, deterministic=True)
    whole = {k: p.grad.detach().clone() for k, p in state.params.items()}
    seen = {}
    inner_apply = task.tx.inner.apply

    def capture(params, grads, st):
        seen.update({k: g.detach().clone() for k, g in grads.items()})
        return inner_apply(params, grads, st)

    task.tx.inner.apply = capture
    state = task.init_state()  # no update yet: the same weights
    for ctr in counters.values():
        ctr.reset()
    h = ACCUM_HALF_B
    for part in (slice(0, h), slice(h, 2 * h)):
        state, _ = task.train_step(state, {k: v[part] for k, v in
                                           batch.items()},
                                   noise=noise[part], deterministic=True)
    torch.cuda.synchronize()
    n_half = {k: ctr.value for k, ctr in counters.items()}
    num = sum(float(((seen[k].double() - w.double()) ** 2).sum())
              for k, w in whole.items())
    den = sum(float((w.double() ** 2).sum()) for w in whole.values())
    rel = (num / den) ** 0.5
    print(f"  accumulation: the mean gradient of 2 micro-steps of B = {h} "
          f"against one step of B = {2 * h} on the same images: relative "
          f"L2 {rel:.3e} (tolerance {ACCUM_TOL:g}); launches {n_half}")
    check(set(seen) == set(whole), "the update saw other leaves")
    check(rel <= ACCUM_TOL, f"accumulated gradient rel L2 {rel:.3e}")
    check(n_half["adamw"] == 1 and n_half["layer_norm"] == 2 * micro[
        "layer_norm"], f"accumulation check launches {n_half}")
    result["accum_check"] = {"half_batch": h, "rel_l2": rel}
    del task, state, whole, seen, batch, noise
    gc.collect()
    torch.cuda.empty_cache()
    return result


def _png_b64(rng, h, w) -> str:
    from PIL import Image
    import numpy as np

    # smooth gradients plus noise: an image EvalTransform resizes and crops
    yy, xx = np.mgrid[0:h, 0:w]
    base = 128 + 60 * np.sin(xx / rng.uniform(5, 40) + yy / rng.uniform(5, 40))
    img = np.clip(base[..., None] + rng.normal(0, 25, (h, w, 3)), 0, 255)
    buf = io.BytesIO()
    Image.fromarray(img.astype(np.uint8)).save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _http(url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        check(r.status == 200, f"{url}: HTTP {r.status}")
        return json.load(r)


def slice_phase(card: str):
    import numpy as np
    import torch

    from ecamp_tpu_torch.kernels import flash_attention as fa
    from ecamp_tpu_torch.kernels import layer_norm as ln
    from ecamp_tpu_torch.nn import set_plain
    from ecamp_tpu_torch.serve import classifier_engine
    from ecamp_tpu_torch.serve.engine import sigmoid_np
    from ecamp_tpu_torch.serve.http_server import PredictionService, serve

    engine = classifier_engine(num_classes=N_CLASSES, img_size=IMG,
                               multilabel=True, buckets=BUCKETS,
                               device="cuda", seed=SEED)
    model = engine.model
    # The JAX head init (std 2e-5) puts every probability at 0.5000, where
    # a 2e-2 check would pass for any trunk. Redraw the head from the seed
    # at std 0.05 so the logits spread to about +-2 and the check sees the
    # trunk's output.
    with torch.no_grad():
        g = torch.Generator().manual_seed(SEED + 1)
        model.head.weight.copy_(0.05 * torch.randn(
            model.head.weight.shape, generator=g))
    depth = len(model.blocks)
    t0 = time.perf_counter()
    engine.warmup(np.zeros((1, IMG, IMG, 3), np.float32))
    torch.cuda.synchronize()
    print(f"slice: ViT-B/16 cls, {IMG} px, {N_CLASSES} classes, depth "
          f"{depth}, buckets {BUCKETS}; warm-up of all buckets "
          f"{time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(SEED)
    bodies = []
    for n in REQUESTS:
        imgs = [_png_b64(rng, int(rng.integers(240, 320)),
                         int(rng.integers(240, 320))) for _ in range(n)]
        bodies.append({"image": imgs[0]} if n == 1 else {"images": imgs})

    service = PredictionService(engine, img_size=IMG)
    httpd = serve(service, port=0, background=True)
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        check(_http(f"{base}/healthz") == {"status": "ok"}, "/healthz")
        hits0 = sum(engine.stats()["bucket_hits"].values())
        ln.launches.reset()
        fa.launches.reset()
        replies = [_http(f"{base}/predict", body) for body in bodies]
        n_ln, n_attn = ln.launches.value, fa.launches.value
        stats = _http(f"{base}/stats")
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()
    runs = sum(stats["bucket_hits"].values()) - hits0
    print(f"  main path: {runs} bucket calls, layer_norm launches {n_ln}, "
          f"attention launches {n_attn}")
    check(runs == len(REQUESTS), f"expected {len(REQUESTS)} bucket calls")
    check(n_ln == (2 * depth + 1) * runs,
          f"layer_norm launches {n_ln} != {(2 * depth + 1) * runs}")
    check(n_attn == depth * runs,
          f"attention launches {n_attn} != {depth * runs}")
    check(stats["requests"] >= sum(REQUESTS), f"/stats {stats}")

    # the same model, LayerNorm and attention through the plain versions
    # called directly, on the same preprocessed inputs
    worst = 0.0
    set_plain(model, True)
    try:
        for n, body, reply in zip(REQUESTS, bodies, replies):
            probs = np.asarray([p["probs"] for p in reply["predictions"]],
                               np.float64)
            check(probs.shape == (n, N_CLASSES), f"shape {probs.shape}")
            check(bool(np.isfinite(probs).all()), "non-finite probabilities")
            check(bool(((probs >= 0) & (probs <= 1)).all()),
                  "probabilities outside [0, 1]")
            xs = service.decode(body.get("images") or [body["image"]])
            with torch.inference_mode():
                logits = model(torch.as_tensor(xs, device="cuda")
                               .to(torch.bfloat16)).float().cpu().numpy()
            err = float(np.abs(probs - sigmoid_np(logits)).max())
            worst = max(worst, err)
            print(f"  request of {n:2d}: probs in [{probs.min():.3f}, "
                  f"{probs.max():.3f}], max |served - plain forward| "
                  f"{err:.3e}")
            check(err <= PROB_TOL, f"request of {n}: {err:.3e} > {PROB_TOL}")
    finally:
        set_plain(model, False)
    torch.cuda.synchronize()

    print(f"per-bucket engine latency on {card} (host clock, "
          f"{TIMING_REPS} calls each, ends in the host copy)")
    p50 = {}
    for b in BUCKETS:
        xs = rng.normal(size=(b, IMG, IMG, 3)).astype(np.float32)
        engine(xs)
        lat = []
        for _ in range(TIMING_REPS):
            t = time.perf_counter()
            engine(xs)
            lat.append((time.perf_counter() - t) * 1e3)
        p50[b] = float(np.median(lat))
        print(f"  bucket {b:2d}: p50 {p50[b]:.3f} ms  "
              f"({b / p50[b] * 1e3:.1f} img/s)")
    # where the card's time goes in a call of the largest bucket
    # (the engine copies to the host, so only the profiler can read it)
    busy = {name: device_ms(lambda: engine(xs), match, 5,
                            f"serve bucket {b} {name}", alone=False)
            for name, match in (("busy", ""), ("attention", "attention_fwd"),
                                ("layer_norm", "ln_fwd"))}
    print(f"  bucket {b:2d}: device busy {_ms(busy['busy'])} a call, "
          f"attention {_ms(busy['attention'])}, layer_norm "
          f"{_ms(busy['layer_norm'])} (profiler, 5 calls)")
    torch.cuda.synchronize()
    return {"layer_norm": n_ln, "attention": n_attn}, worst, p50, busy


def cli_phase(card: str, per_step, work: str):
    """The pretraining entry point at full width: a seeded MIMIC-style
    corpus (CLI_IMAGES gray PNGs at CLI_IMG px, reports of words of the
    repository's 30000-word vocabulary) in `work`, then `python -m
    ecamp_tpu_torch.cli.pretrain --fused_mlm_ce` for 2 epochs at B = PRE_B
    and a resume from its checkpoint-1.pth for a third. Each epoch's log
    line must be finite and count `per_step` launches of every kernel a
    step; the resume must restore the epoch and the AdamW moments and
    step. Returns the epochs' log lines and the path of the last
    checkpoint, which the fine-tune starts from."""
    import numpy as np
    import torch

    from ecamp_tpu_torch.core.config import PretrainConfig
    from ecamp_tpu_torch.data.synthetic import write_mimic_corpus

    cfg = PretrainConfig()  # the CLI's model
    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    data = write_mimic_corpus(
        os.path.join(work, "mimic"),
        os.path.join(repo, "ecamp_tpu", "assets", "mimic_wordpiece.json"),
        CLI_IMAGES, CLI_IMG, cfg.vit.grid_size - cfg.sr_window, seed=SEED)
    out = os.path.join(work, "out")
    print(f"CLI on {card}: {CLI_IMAGES} images at {CLI_IMG} px written "
          f"in {time.perf_counter() - t0:.1f} s")
    base = [sys.executable, "-m", "ecamp_tpu_torch.cli.pretrain",
            "--data_path", data, "--fused_mlm_ce", "--batch_size",
            str(PRE_B), "--output_dir", out, "--seed", str(SEED),
            "--print_freq", "1"]

    def run(extra):
        t = time.perf_counter()
        r = subprocess.run(base + extra, cwd=repo, capture_output=True,
                           text=True, timeout=CLI_TIMEOUT)
        check(r.returncode == 0, f"CLI {extra} exited {r.returncode}:\n"
              f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
        with open(os.path.join(out, "log.txt")) as f:
            recs = [json.loads(line) for line in f]
        print(f"  {' '.join(extra)}: {time.perf_counter() - t:.1f} s")
        return r.stdout, recs

    steps = CLI_IMAGES // PRE_B
    want = {k: v * steps for k, v in per_step.items()}
    _, recs = run(["--epochs", "2"])
    printed, recs = run(["--epochs", "3", "--resume",
                         os.path.join(out, "checkpoint-1.pth")])
    check([r["epoch"] for r in recs] == [0, 1, 2],
          f"epochs logged {[r['epoch'] for r in recs]}")
    for r in recs:
        print(f"  epoch {r['epoch']}: loss {r['loss']:.5f} (mim "
              f"{r['mim_loss']:.5f} res {r['res_loss']:.5f} mlm "
              f"{r['mlm_loss']:.5f}) lr {r['lr']:.3e}, max_mem_mb "
              f"{r['max_mem_mb']:.1f}, launches {r['kernel_launches']}")
        check(all(np.isfinite(r[k]) for k in ("loss", "mim_loss",
                                              "res_loss", "mlm_loss")),
              f"epoch {r['epoch']}: non-finite loss")
        check(r["max_mem_mb"] > 0, "no device memory reported")
        check(r["kernel_launches"] == want,
              f"epoch {r['epoch']}: launches {r['kernel_launches']} != "
              f"{want}")
    n_params = len(torch.load(os.path.join(out, "checkpoint-1.pth"),
                              weights_only=True)["optimizer"]["state"])
    restored = (f"restored AdamW moments for {n_params} params (torch "
                f"step {2 * steps})")
    check(restored in printed and "resuming at epoch 2" in printed,
          f"resume did not report '{restored}' and epoch 2")
    last = torch.load(os.path.join(out, "checkpoint-2.pth"),
                      weights_only=True)
    after = {int(st["step"]) for st in last["optimizer"]["state"].values()}
    check(last["epoch"] == 2 and after == {3 * steps},
          f"checkpoint-2: epoch {last['epoch']}, steps {after}")
    print(f"  resume: {restored}, epoch 2 trained, checkpoint-2.pth at "
          f"AdamW step {3 * steps}")
    return recs, os.path.join(out, "checkpoint-2.pth")


def cli_accum_phase(card: str, per_step, work: str) -> dict:
    """The pretraining CLI's accumulation, preemption and preset launcher
    at full width on `cli_phase`'s corpus (in `work`): (6b) `--accum_iter
    CLI_ACCUM --fused_mlm_ce` for 2 epochs: each epoch's log line counts
    `per_step` launches a micro-step of every kernel but AdamW, and one
    AdamW launch an update; checkpoint-1.pth's AdamW step is the updates.
    (6c) the same with ECAMP_PREEMPT_AT_STEP=CLI_PREEMPT_AT (mid-epoch,
    mid-cycle): exit 0, the message, the step file, then `--resume` on it
    to the end of epoch 1; the final checkpoint's epoch, AdamW step and
    open cycle equal (6b)'s, and its parameters equal them bit for bit or
    lie within PREEMPT_TOL of each leaf's movement from the initial
    weights. (6d) `python -m ecamp_tpu_torch.cli.run_preset pretrain_mimic`
    with B = PRE_B, 1 epoch: the preset's accumulation (8) over 2
    micro-steps, 0 updates, no AdamW launch. (6b), (6c)'s preempted run
    and (6d) start together, (6c)'s resume once its preempted run has
    ended: each process counts its own launches."""
    import numpy as np
    import torch

    from ecamp_tpu_torch.core.config import PretrainConfig
    from ecamp_tpu_torch.core.presets import PRESETS
    from ecamp_tpu_torch.train.pretrain import PretrainTask

    repo = os.path.dirname(os.path.abspath(__file__))
    data = os.path.join(work, "mimic")  # cli_phase's corpus
    steps = CLI_IMAGES // PRE_B         # micro-steps an epoch
    env = {k: v for k, v in os.environ.items()
           if k not in ("ECAMP_PREEMPT_AT_STEP", "ECAMP_RSS_LIMIT_GB")}

    procs = []

    def start(args, extra_env=None):
        """`python -m args` in the background, its output in a file."""
        f = tempfile.TemporaryFile("w+")
        p = subprocess.Popen([sys.executable, "-m", *args], cwd=repo,
                             stdout=f, stderr=subprocess.STDOUT, text=True,
                             env={**env, **(extra_env or {})})
        procs.append(p)
        return args, p, f, time.perf_counter()

    def finish(tag, run, out):
        """Wait for a `start`ed run (CLI_TIMEOUT from its start); its
        output and the records of `out`/log.txt."""
        args, p, f, t = run
        try:
            p.wait(timeout=max(1.0, CLI_TIMEOUT - (time.perf_counter() - t)))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        f.seek(0)
        printed = f.read()
        f.close()
        check(p.returncode == 0, f"({tag}) {args} exited {p.returncode}:\n"
              f"{printed[-6000:]}")
        log = os.path.join(out, "log.txt")
        recs = []
        if os.path.exists(log):
            with open(log) as fl:
                recs = [json.loads(line) for line in fl]
        print(f"  ({tag}) {' '.join(args[1:])}: "
              f"{time.perf_counter() - t:.1f} s")
        return printed, recs

    def pretrain(out, *extra):
        return ["ecamp_tpu_torch.cli.pretrain", "--data_path", data,
                "--fused_mlm_ce", "--batch_size", str(PRE_B), "--output_dir",
                out, "--seed", str(SEED), "--print_freq", "1",
                "--accum_iter", str(CLI_ACCUM), "--epochs", "2", *extra]

    def check_epochs(tag, recs, epochs, accum, start=0):
        """Each epoch's line against the micro-steps it ran (from micro-step
        `start` for the first); returns the updates at the end."""
        check([r["epoch"] for r in recs] == epochs,
              f"({tag}) epochs logged {[r['epoch'] for r in recs]}")
        done = start
        for r in recs:
            micro = (r["epoch"] + 1) * steps
            want = {k: v * (micro - done) for k, v in per_step.items()}
            want["adamw"] = micro // accum - done // accum
            done = micro
            print(f"  ({tag}) epoch {r['epoch']}: loss {r['loss']:.5f} lr "
                  f"{r['lr']:.3e}, micro-steps {r['micro_steps']}, updates "
                  f"{r['updates']}, launches {r['kernel_launches']}")
            check(all(np.isfinite(r[k]) for k in ("loss", "mim_loss",
                                                  "res_loss", "mlm_loss")),
                  f"({tag}) epoch {r['epoch']}: non-finite loss")
            check((r["micro_steps"], r["updates"]) == (micro,
                                                       micro // accum),
                  f"({tag}) epoch {r['epoch']}: micro-steps "
                  f"{r['micro_steps']}, updates {r['updates']}")
            check(r["kernel_launches"] == want,
                  f"({tag}) epoch {r['epoch']}: launches "
                  f"{r['kernel_launches']} != {want}")
        return done // accum

    def load(path):
        return torch.load(path, map_location="cpu", weights_only=True)

    out_b = os.path.join(work, "accum_out")
    out_c = os.path.join(work, "preempt_out")
    out_d = os.path.join(work, "preset_out")
    at = CLI_PREEMPT_AT
    try:
        run_b = start(pretrain(out_b))
        run_c = start(pretrain(out_c), {"ECAMP_PREEMPT_AT_STEP": str(at)})
        run_d = start(["ecamp_tpu_torch.cli.run_preset", "pretrain_mimic",
                       "--data_path", data, "--batch_size", str(PRE_B),
                       "--epochs", "1", "--fused_mlm_ce", "--output_dir",
                       out_d])

        # (6b)
        _, recs_b = finish("6b", run_b, out_b)
        updates = check_epochs("6b", recs_b, [0, 1], CLI_ACCUM)
        final_b = load(os.path.join(out_b, "checkpoint-1.pth"))
        steps_b = {int(s["step"])
                   for s in final_b["optimizer"]["state"].values()}
        check(final_b["epoch"] == 1 and steps_b == {updates},
              f"(6b) checkpoint-1: epoch {final_b['epoch']}, AdamW steps "
              f"{steps_b} for {updates} updates")
        cycle_b = final_b.get("accum_cycle")

        # (6c)
        printed, recs_c = finish("6c", run_c, out_c)
        mid = os.path.join(out_c, f"checkpoint-step-{at}.pth")
        epoch, skip = divmod(at, steps)
        msg = (f"preemption checkpoint saved @ step {at} (epoch {epoch}); "
               f"resume with --resume {mid} [injected @ {at}]")
        check(msg in printed, f"(6c) no '{msg}' in:\n{printed[-2000:]}")
        check_epochs("6c", recs_c, list(range(epoch)), CLI_ACCUM)
        saved = load(mid)
        check(saved["step"] == at and "epoch" not in saved
              and saved["accum_cycle"]["mini_step"] == at % CLI_ACCUM,
              f"(6c) {mid}: step {saved.get('step')}, cycle "
              f"{saved.get('accum_cycle', {}).get('mini_step')}")
        del saved
        run_c = start(pretrain(out_c, "--resume", mid))

        # (6d), beside (6c)'s resume
        _, recs_d = finish("6d", run_d, out_d)
        accum = PRESETS["pretrain_mimic"]["args"]["accum_iter"]
        check_epochs("6d", recs_d, [0], accum)
        check(recs_d[0]["updates"] == 0
              and recs_d[0]["kernel_launches"]["adamw"] == 0,
              f"(6d) {recs_d[0]['updates']} updates")
        shutil.rmtree(out_d, ignore_errors=True)

        printed, recs_c = finish("6c resume", run_c, out_c)
    finally:
        for p in procs:  # a failed check leaves no run behind
            if p.poll() is None:
                p.kill()
                p.wait()
    check(f"resuming at epoch {epoch}, batch {skip}" in printed,
          f"(6c) the resume did not report epoch {epoch}, batch {skip}")
    check_epochs("6c resume", recs_c[epoch:], list(range(epoch, 2)),
                 CLI_ACCUM, start=at)
    final_c = load(os.path.join(out_c, "checkpoint-1.pth"))
    steps_c = {int(s["step"]) for s in final_c["optimizer"]["state"].values()}
    check(final_c["epoch"] == 1 and steps_c == steps_b
          and final_c.get("accum_cycle") == cycle_b,
          f"(6c) final checkpoint: epoch {final_c['epoch']}, AdamW steps "
          f"{steps_c}, cycle {final_c.get('accum_cycle')} against (6b)'s "
          f"{steps_b}, {cycle_b}")
    # the initial weights, made as the CLI makes them from --seed
    task = PretrainTask(PretrainConfig(seed=SEED, fused_mlm_ce=True),
                        device="cuda")
    init = {k: v.detach().cpu() for k, v in task.model.state_dict().items()}
    del task
    torch.cuda.empty_cache()
    diff = move = 0.0
    within = True
    for k, b in final_b["model"].items():
        d = float((final_c["model"][k] - b).abs().max())
        mv = float((b - init[k]).abs().max())
        diff, move = max(diff, d), max(move, mv)
        within = within and d <= PREEMPT_TOL * mv
    bitwise = diff == 0.0
    held = ("bit for bit" if bitwise else
            f"within {PREEMPT_TOL:g} of each leaf's movement" if within
            else "neither")
    print(f"  (6c) preempted at step {at} (epoch {epoch}, batch {skip}, "
          f"cycle micro-step {at % CLI_ACCUM}) and resumed: parameters "
          f"against (6b)'s {held}, max |diff| {diff:.3e}, largest movement "
          f"from init {move:.3e}; AdamW steps {steps_c}, cycle {cycle_b}")
    check(move < 1e-3, f"(6c) movement from init {move:.3e}: not the CLI's "
          f"initial weights")
    check(bitwise or within, f"(6c) parameters differ from (6b)'s by "
          f"{diff:.3e}")
    del final_b, final_c, init
    shutil.rmtree(out_b, ignore_errors=True)
    shutil.rmtree(out_c, ignore_errors=True)
    return {"accum": {"epochs": recs_b, "updates": updates},
            "preemption": {"at_step": at, "epoch": epoch, "batch": skip,
                           "cycle_micro_step": at % CLI_ACCUM,
                           "held": held, "max_abs_diff": diff,
                           "max_movement": move},
            "preset": {"name": "pretrain_mimic", "accum_iter": accum,
                       "epochs": recs_d}}


_STARTED = []  # processes started to run beside a phase; main stops any


def _start_group(cmd, env):
    """Start `cmd` (a launcher and its ranks) from the repository root in a
    process group of its own, its output piped."""
    repo = os.path.dirname(os.path.abspath(__file__))
    p = subprocess.Popen(cmd, cwd=repo, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True,
                         start_new_session=True)
    _STARTED.append(p)
    return p


def _stop(p) -> None:
    """Kill a started process (its whole group) if it still runs."""
    import signal

    if p.poll() is None:
        os.killpg(p.pid, signal.SIGKILL)
        p.wait()


def _wait_group(p, what: str, timeout: float):
    """Wait for a `_start_group` process; on a timeout kill its group.
    Returns its stdout and stderr; a non-zero exit fails the check."""
    try:
        out, err = p.communicate(timeout=max(1.0, timeout))
    except subprocess.TimeoutExpired:
        _stop(p)
        out, err = p.communicate()
        check(False, f"{what} outlived its {timeout:.0f} s:\n"
              f"{out[-3000:]}\n{err[-3000:]}")
    check(p.returncode == 0, f"{what} exited {p.returncode}:\n"
          f"{out[-3000:]}\n{err[-3000:]}")
    return out, err


def _run_group(cmd, env, timeout, what):
    """`cmd` started (`_start_group`) and waited for (`_wait_group`)."""
    return _wait_group(_start_group(cmd, env), what, timeout)


def _torchrun(n: int, port: int) -> list:
    return [sys.executable, "-m", "torch.distributed.run",
            f"--nproc_per_node={n}", "--master_addr=127.0.0.1",
            f"--master_port={port}"]


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dp_config(shard: bool):
    from ecamp_tpu_torch.core.config import (MeshConfig, OptimizerConfig,
                                             PretrainConfig)

    return PretrainConfig(optimizer=OptimizerConfig(schedule="constant",
                                                    lr=1.5e-4),
                          mesh=MeshConfig(shard_optimizer=shard), seed=SEED)


def _dp_inputs(cfg, device):
    """The global batch of PRE_B rows and its masking noise, from a seed:
    the same on every rank and in the one-process reference."""
    import torch

    from ecamp_tpu_torch.train.pretrain import synthetic_batch

    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    batch = synthetic_batch(cfg, PRE_B, gen)
    noise = torch.rand(PRE_B, cfg.vit.num_patches, device=device,
                       generator=gen)
    return batch, noise


def _not_key_bias(name: str, p):
    """False on the attention key biases' elements (BERT's `key.bias`, the
    middle third of a fused `qkv.bias`): softmax is invariant to them, so
    their gradient is rounding noise that AdamW turns into lr-sized steps
    of either sign on any two runs that round differently."""
    import torch

    keep = torch.ones_like(p, dtype=torch.bool)
    if name.endswith("key.bias"):
        keep[:] = False
    elif name.endswith("qkv.bias"):
        d = p.numel() // 3
        keep[d:2 * d] = False
    return keep


def dp_worker(spec: dict) -> int:
    """One rank of `dp_phase`'s torchrun launch (`chip_smoke.py --dp-worker
    SPEC`): the full-width `PretrainTask` on this rank's PRE_B / ranks rows
    of the seeded global batch, injected noise, dropout off, bf16, AdamW
    lr 1.5e-4, DP_STEPS steps a run, the kernel launch counters set to 0
    before a run and read after it, host ms a step, each run's peak
    device memory. Run "plain": plain data parallelism, the first averaged
    gradient's norm, the parameter update against the one-process
    reference's (spec["ref"]); beside it a ZeRO-1 AdamW over a copy of the
    parameters takes the same averaged gradients after every step, and
    its parameters are compared with the task's bit for bit (b) (its copy
    and optimizer state, allocated before the steps, are left out of the
    peak, as is what the comparisons hold). The step's backward is not
    bit-reproducible on the card (its upsample and scatter backwards add
    atomically), so two runs are compared by distance. Run "zero1", at two
    or more ranks (at one, ZeRO-1 keeps every moment): ZeRO-1 with
    ECAMP_PREEMPT_AT_STEP = DP_PREEMPT_AT and the ranks agreeing every step
    (e): the guard stops
    every rank there, `save_preemption_checkpoint` (rank 0 writes the
    gathered moments), a new task on every rank loads the file (its share
    of the moments), the loaded state is compared with the saved one, and
    the run takes its remaining steps; its parameters' distance from
    "plain" is the spread of two runs. Writes its results as JSON to
    spec["out"] with the rank's number; a failed check exits non-zero."""
    import gc

    import torch

    from ecamp_tpu_torch.ckpt.checkpoint import (load_checkpoint,
                                                 load_model_state,
                                                 save_preemption_checkpoint)
    from ecamp_tpu_torch.core import distributed
    from ecamp_tpu_torch.core.preemption import PreemptionGuard
    from ecamp_tpu_torch.kernels import flash_attention as fa
    from ecamp_tpu_torch.kernels import fused_adamw as adamw
    from ecamp_tpu_torch.kernels import layer_norm as ln
    from ecamp_tpu_torch.kernels import sr_head as sr
    from ecamp_tpu_torch.train.optim import make_optimizer
    from ecamp_tpu_torch.train.pretrain import PretrainTask

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(distributed.initialize_distributed("cuda"),
          "no launcher environment")
    rank, world = distributed.rank(), distributed.world_size()
    dev = distributed.rank_device("cuda")
    b = PRE_B // world
    counters = {"layer_norm": ln.launches, "attention": fa.launches,
                "sr_conv_stack": sr.launches,
                "sr_conv_stack_tma": sr.launches_tma, "adamw": adamw.launches}
    batch, noise = _dp_inputs(_dp_config(False), dev)
    local = {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}
    ref = torch.load(spec["ref"], map_location=dev, weights_only=True)

    def build(shard):
        gc.collect()
        torch.cuda.empty_cache()
        return PretrainTask(_dp_config(shard), device=dev)

    class Shadow:
        """A copy of the task's parameters in its flat layout, and a ZeRO-1
        AdamW over it that takes the task's averaged gradients."""

        def __init__(self, task):
            self.layout = task.dp.layout
            self.params_flat = task.dp.params_flat.clone()
            self.params = {k: self.layout.view(self.params_flat, k)
                           for k, _ in task.model.named_parameters()}
            self.tx = make_optimizer(
                task.cfg.optimizer, zero1=distributed.Zero1(
                    self.layout, rank, self))
            self.state = self.tx.init(self.params)

        def exchange_params_(self):
            distributed.broadcast_spans_(self.params_flat, self.layout)

        def step(self, task):
            before = adamw.launches.value
            self.state = self.tx.apply(
                self.params, {k: p.grad for k, p in
                              task.model.named_parameters()}, self.state)
            return adamw.launches.value - before

    def steps(task, state, n, guard=None, shadow=None):
        times, losses, gnorm, equal, extra = [], [], None, [], 0
        for _ in range(n):
            t = time.perf_counter()
            state, m = task.train_step(state, local, noise=noise,
                                       deterministic=True)
            torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t) * 1e3)
            losses.append({k: float(v) for k, v in m.items()})
            if gnorm is None:
                gnorm = float(adamw.global_norm(
                    [p.grad for p in state.params.values()]))
            if shadow is not None:
                extra += shadow.step(task)
                equal.append(bool(torch.equal(shadow.params_flat,
                                              task.dp.params_flat)))
            if guard is not None and guard.should_save(task.step):
                break
        return state, {"losses": losses, "step_ms": times,
                       "grad_norm": gnorm, "zero1_bit_equal": equal,
                       "shadow_launches": extra}

    def snap(params):
        """A copy on the card (the comparisons run there, not on the
        host's cores, which the ranks share)."""
        return {k: p.detach().clone() for k, p in params.items()}

    def finish(out):
        with open(f"{spec['out']}{rank}.json", "w") as f:
            json.dump(out, f)
        distributed.shutdown_distributed()
        return 0

    def distance(a, c):
        """(max |a - c|, L2 of a - c) over every parameter."""
        mx = l2 = 0.0
        for k, p in a.items():
            d = (p - c[k]).double().abs()
            if d.numel():  # a moment piece is empty outside the rank's span
                mx, l2 = max(mx, float(d.max())), l2 + float((d * d).sum())
        return mx, l2 ** 0.5

    out = {"rank": rank, "world": world,
           "backend": torch.distributed.get_backend(),
           "rows": b, "card": torch.cuda.get_device_name(dev),
           "leaves": len(ref)}

    def start(task):
        """Reset the peak memory and the launch counters."""
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        for ctr in counters.values():
            ctr.reset()

    # "plain": plain data parallelism with the ZeRO-1 shadow beside it; the
    # memory the comparisons hold outside the task stays out of its peak
    outside = torch.cuda.memory_allocated(dev)
    task = build(False)
    state = task.init_state()
    before = torch.cuda.memory_allocated(dev)
    init = snap(state.params)
    shadow = Shadow(task)
    aside = torch.cuda.memory_allocated(dev) - before  # the copy, the shadow
    start(task)
    state, res = steps(task, state, DP_STEPS, shadow=shadow)
    launches = {k: ctr.value for k, ctr in counters.items()}
    launches["adamw"] -= res.pop("shadow_launches")
    plain = snap(state.params)
    # (a): the update against the one-process run's
    dot = nd = nr = diff = 0.0
    for k, p in plain.items():
        keep = _not_key_bias(k, p)
        du = (p - init[k])[keep].double()
        dr = (ref[k] - init[k])[keep].double()
        dot += float((du * dr).sum())
        nd += float((du * du).sum())
        nr += float((dr * dr).sum())
        diff += float(((du - dr) ** 2).sum())
    out["plain"] = dict(
        res, launches=launches, aside_bytes=aside,
        peak_bytes=torch.cuda.max_memory_allocated(dev) - outside - aside,
        moment_elements=sum(t.numel() for t in state.opt_state.mu.values()),
        update_norm=nd ** 0.5, ref_update_norm=nr ** 0.5,
        update_cosine=dot / (nd * nr) ** 0.5, update_rel_l2=(diff / nr) ** 0.5,
        bit_equal_to_one_process=all(torch.equal(p, ref[k])
                                     for k, p in plain.items()))
    out["checksum"] = float(sum(p.double().sum() for p in plain.values()))
    del task, state, shadow
    gc.collect()
    if world == 1:  # one rank: ZeRO-1 keeps every moment; (e) runs at 2
        return finish(out)

    # "zero1": ZeRO-1, preempted at DP_PREEMPT_AT (e), resumed from the file
    outside = torch.cuda.memory_allocated(dev)
    os.environ["ECAMP_PREEMPT_AT_STEP"] = str(DP_PREEMPT_AT)
    guard = PreemptionGuard(sync_every=1)
    del os.environ["ECAMP_PREEMPT_AT_STEP"]
    try:
        task = build(True)
        state = task.init_state()
        start(task)
        state, res = steps(task, state, DP_STEPS, guard)
    finally:
        guard.uninstall()
    check(task.step == DP_PREEMPT_AT,
          f"(e) rank {rank} stopped at step {task.step}")
    peak = torch.cuda.max_memory_allocated(dev) - outside
    moments = sum(t.numel() for t in state.opt_state.mu.values())
    saved = [snap(state.params), snap(state.opt_state.mu),
             snap(state.opt_state.nu)]
    t = time.perf_counter()
    path = save_preemption_checkpoint(spec["work"], task.step, task.model,
                                      state, task.cfg.optimizer.weight_decay)
    save_s = time.perf_counter() - t
    del task, state
    task = build(True)
    state = task.init_state()
    t = time.perf_counter()
    ck = load_checkpoint(path)
    load_model_state(task.model, ck["model"])
    state = state.load_optimizer_state_dict(ck["optimizer"])
    state.step = torch.full_like(state.step, int(ck["step"]))
    task.step = int(ck["step"])
    load_s = time.perf_counter() - t
    # the resume restores what was saved: the parameters, this rank's
    # moment pieces and the count, bit for bit
    loaded = [snap(state.params), snap(state.opt_state.mu),
              snap(state.opt_state.nu)]
    restored = [distance(a, c) for a, c in zip(loaded, saved)]
    count = int(state.opt_state.count)
    state, after = steps(task, state, DP_STEPS - task.step)
    out["zero1"] = {
        "losses": res["losses"] + after["losses"],
        "step_ms": res["step_ms"] + after["step_ms"],
        "grad_norm": res["grad_norm"],
        "launches": {k: ctr.value for k, ctr in counters.items()},
        "peak_bytes": peak, "moment_elements": moments}
    # the resumed run against the plain one: the spread of two runs of the
    # same function on the card (ZeRO-1 changes no bit of it, (b))
    out["repeat_distance"] = distance(snap(state.params), plain)
    out["preempt"] = {"at": DP_PREEMPT_AT, "reason": guard.reason,
                      "save_s": save_s, "load_s": load_s,
                      "restored_distance": restored, "count": count}
    del task, state
    return finish(out)


def dp_zero1_checks(r: dict, who: str, n: int, launches: dict,
                    moment_bytes: int) -> None:
    """`dp_phase`'s checks of one rank's ZeRO-1 run (preempted at
    DP_PREEMPT_AT and resumed): its launches, its share of the moments,
    (d) its peak against plain's, (e) the restored state and the losses."""
    from ecamp_tpu_torch.core.distributed import ALIGN

    z, plain = r["zero1"], r["plain"]
    check(z["launches"] == launches,
          f"{who} ZeRO-1 launches {z['launches']} != {launches}")
    # a rank's span is 1/n of the flat layout, which pads every leaf to
    # ALIGN elements
    check(abs(z["moment_elements"] * n - plain["moment_elements"])
          <= n * ALIGN * r["leaves"],
          f"(b) {who}: {z['moment_elements']} moment elements of "
          f"{plain['moment_elements']}")
    saving = plain["peak_bytes"] - z["peak_bytes"]
    want = moment_bytes * (1 - 1 / n)
    check(abs(saving - want) <= 0.1 * moment_bytes,
          f"(d) {who}: ZeRO-1 saved {saving} bytes of peak, expected "
          f"{want:.0f}")
    # (e): the resume restores the saved state bit for bit; the steps are
    # (a)'s, whose runs on the card differ by a repeat's spread (printed),
    # so the losses are held to plain's by (a)'s bound
    pre = r["preempt"]
    check(pre["restored_distance"] == [[0.0, 0.0]] * 3
          and pre["count"] == DP_PREEMPT_AT,
          f"(e) {who}: restored (params, mu, nu) {pre['restored_distance']} "
          f"from the saved state, count {pre['count']}")
    for i, (got, ref) in enumerate(zip(z["losses"], plain["losses"])):
        check(abs(got["loss"] - ref["loss"]) <= LOSS_TOL * abs(ref["loss"]),
              f"(e) {who}: step {i} of the preempted and resumed ZeRO-1 "
              f"run, loss {got['loss']:.6g} against plain "
              f"{ref['loss']:.6g}")


def dp_phase(card: str, per_step: dict, cli_per_step: dict,
             work: str) -> dict:
    """Data-parallel pretraining (`torchrun`, `core/distributed.py`) at full
    width. First one process at B = PRE_B on the seeded global batch
    (DP_STEPS steps, the reference); then `dp_worker` under torchrun: on
    two or more cards 2 NCCL ranks, on one card NCCL at world size 1 and 2
    gloo ranks sharing the card (NCCL takes one rank a card). Each launch:
    (a) the losses of every step within LOSS_TOL and the first averaged
    gradient's norm within GNORM_TOL of the reference's, the parameter
    update's norm within GNORM_TOL of its, `per_step` launches a step of
    every kernel on every rank; (b) a ZeRO-1 AdamW on plain data
    parallelism's averaged gradients equal to its update bit for bit after
    every step; (c) the ranks' parameter checksums equal; at two ranks a
    ZeRO-1 run too (`dp_zero1_checks`): 1/ranks of the moment elements a
    rank, (d) each rank's peak memory with and without ZeRO-1, the saving
    within 10% of the moments' share it drops, (e) the run stopped at
    DP_PREEMPT_AT on every rank, its resume restoring the saved
    parameters, moment pieces and count bit for bit, every step's loss
    within LOSS_TOL of plain's (the step is not bit-reproducible on the
    card; the runs' distance is printed).
    Beside the launches, `torchrun -m ecamp_tpu_torch.cli.pretrain
    --shard_optimizer --fused_mlm_ce` on 2 ranks (gloo on one card) at DP_B
    a rank for an epoch of `cli_phase`'s corpus: one log line, from rank
    0, with `cli_per_step` launches a micro-step, and a checkpoint whose
    moments are whole. Returns the `data_parallel` JSON line's content."""
    import gc

    import numpy as np
    import torch

    from ecamp_tpu_torch.kernels import fused_adamw as adamw
    from ecamp_tpu_torch.train.pretrain import PretrainTask

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    task = PretrainTask(_dp_config(False), device="cuda")
    n_params = sum(p.numel() for p in task.model.parameters())
    batch, noise = _dp_inputs(task.cfg, task.device)
    state = task.init_state()
    ref = {"losses": [], "step_ms": []}
    for i in range(DP_STEPS):
        t = time.perf_counter()
        state, m = task.train_step(state, batch, noise=noise,
                                   deterministic=True)
        torch.cuda.synchronize()
        ref["step_ms"].append((time.perf_counter() - t) * 1e3)
        ref["losses"].append({k: float(v) for k, v in m.items()})
        if i == 0:
            ref["grad_norm"] = float(adamw.global_norm(
                [p.grad for p in state.params.values()]))
    ref_path = os.path.join(work, "dp_reference.pt")
    torch.save({k: p.detach().cpu() for k, p in state.params.items()},
               ref_path)
    del task, state, batch, noise
    gc.collect()
    torch.cuda.empty_cache()
    print(f"data parallel on {card}: one process at B = {PRE_B} (the "
          f"reference), {DP_STEPS} steps: losses "
          f"{[round(r['loss'], 5) for r in ref['losses']]}, grad norm "
          f"{ref['grad_norm']:.6g}, step ms "
          f"{[round(t, 1) for t in ref['step_ms']]}")

    cards = torch.cuda.device_count()
    # the backend follows from ranks and cards: NCCL where every rank has a
    # card of its own, gloo where ranks share one
    plan = [2] if cards >= 2 else [1, 2]
    env = {k: v for k, v in os.environ.items()
           if k not in ("ECAMP_PREEMPT_AT_STEP", "ECAMP_RSS_LIMIT_GB")}
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host
    # the entry point itself, torchrun -m ecamp_tpu_torch.cli.pretrain,
    # runs beside the launches (their step times are taken beside it)
    n_cli = 2
    cli_backend = "nccl" if n_cli <= cards else "gloo"
    out = os.path.join(work, "dp_cli")
    t_cli = time.perf_counter()
    cli = _start_group(
        _torchrun(n_cli, _free_port())
        + ["-m", "ecamp_tpu_torch.cli.pretrain", "--data_path",
           os.path.join(work, "mimic"), "--fused_mlm_ce",
           "--shard_optimizer", "--batch_size", str(DP_B), "--epochs", "1",
           "--output_dir", out, "--seed", str(SEED), "--print_freq", "1"],
        env)
    try:
        runs = _dp_launches(plan, cards, env, work, ref_path, ref,
                            per_step, moment_bytes=2 * 4 * n_params)
        _wait_group(cli, "torchrun cli.pretrain",
                    DP_TIMEOUT - (time.perf_counter() - t_cli))
    finally:
        _stop(cli)
    cli_s = time.perf_counter() - t_cli
    with open(os.path.join(out, "log.txt")) as f:
        recs = [json.loads(line) for line in f]
    steps = CLI_IMAGES // (n_cli * DP_B)
    want = {k: v * steps for k, v in cli_per_step.items()}
    check(len(recs) == 1 and recs[0]["epoch"] == 0,
          f"CLI log lines {recs}: rank 0 alone writes one an epoch")
    rec = recs[0]
    check(all(np.isfinite(rec[k]) for k in ("loss", "mim_loss", "res_loss",
                                             "mlm_loss")),
          f"CLI: non-finite loss {rec}")
    check(rec["kernel_launches"] == want,
          f"CLI launches {rec['kernel_launches']} != {want}")
    check(rec["micro_steps"] == steps and rec["updates"] == steps,
          f"CLI micro-steps {rec['micro_steps']}, updates {rec['updates']}")
    ck = torch.load(os.path.join(out, "checkpoint-0.pth"), weights_only=True)
    whole = sum(st["exp_avg"].numel() for st in ck["optimizer"]["state"]
                .values())
    check(whole == n_params, f"CLI checkpoint: {whole} moment elements")
    del ck
    shutil.rmtree(out, ignore_errors=True)
    os.remove(ref_path)
    print(f"  torchrun --nproc_per_node={n_cli} -m "
          f"ecamp_tpu_torch.cli.pretrain --shard_optimizer --fused_mlm_ce "
          f"({cli_backend}), {DP_B} a rank: "
          f"loss {rec['loss']:.5f}, launches {rec['kernel_launches']}, "
          f"max_mem_mb {rec['max_mem_mb']:.1f}, whole moments in "
          f"checkpoint-0.pth; {cli_s:.1f} s beside the launches; phase "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {"reference": ref, "runs": runs,
            "predicted_saving_bytes": 4 * n_params,
            "cli": {"backend": cli_backend, "ranks": n_cli,
                    "rows_a_rank": DP_B, "log": rec, "seconds": cli_s},
            "seconds": time.perf_counter() - t_phase}


def _dp_launches(plan, cards, env, work, ref_path, ref, per_step,
                 moment_bytes):
    """(6e)'s `dp_worker` launches, one a world size of `plan`, each held
    against the one-process reference `ref`; returns their figures."""
    import numpy as np

    runs = {}
    for n in plan:
        backend = "nccl" if n <= cards else "gloo"
        tag = f"{backend}{n}"
        spec = {"work": os.path.join(work, tag),
                "ref": ref_path, "out": os.path.join(work, f"dp_{tag}_rank")}
        os.makedirs(spec["work"], exist_ok=True)
        t = time.perf_counter()
        _run_group(_torchrun(n, _free_port())
                   + [os.path.abspath(__file__), "--dp-worker",
                      json.dumps(spec)], env, DP_TIMEOUT,
                   f"torchrun {n} x {backend}")
        wall = time.perf_counter() - t
        res = []
        for r in range(n):
            with open(f"{spec['out']}{r}.json") as f:
                res.append(json.load(f))
        for r in res:
            who = f"{tag} rank {r['rank']}"
            check(r["backend"] == backend,
                  f"{who}: backend {r['backend']}, expected {backend}")
            for i, (got, want) in enumerate(zip(r["plain"]["losses"],
                                                ref["losses"])):
                for k in ("loss", "mim_loss", "res_loss", "mlm_loss"):
                    rel = abs(got[k] - want[k]) / abs(want[k])
                    check(np.isfinite(got[k]) and rel <= LOSS_TOL,
                          f"(a) {who} step {i} {k} {got[k]:.6g} against "
                          f"{want[k]:.6g}")
            g = r["plain"]["grad_norm"]
            check(abs(g - ref["grad_norm"]) <= GNORM_TOL * ref["grad_norm"],
                  f"(a) {who} grad norm {g:.6g} against "
                  f"{ref['grad_norm']:.6g}")
            u, ur = r["plain"]["update_norm"], r["plain"]["ref_update_norm"]
            check(abs(u - ur) <= GNORM_TOL * ur,
                  f"(a) {who} update norm {u:.6g} against {ur:.6g}")
            want = {k: v * DP_STEPS for k, v in per_step.items()}
            check(r["plain"]["launches"] == want,
                  f"{who} launches {r['plain']['launches']} != {want}")
            check(r["plain"]["zero1_bit_equal"] == [True] * DP_STEPS,
                  f"(b) {who}: ZeRO-1 on the same gradients differs from "
                  f"plain DP after steps {r['plain']['zero1_bit_equal']}")
            if "zero1" in r:
                dp_zero1_checks(r, who, n, want, moment_bytes)
        check(len({r["checksum"] for r in res}) == 1,
              f"(c) {tag}: checksums {[r['checksum'] for r in res]}")
        shutil.rmtree(spec["work"], ignore_errors=True)
        r0 = res[0]
        runs[tag] = {
            "backend": backend, "ranks": n, "rows_a_rank": r0["rows"],
            "launch_s": wall,
            "losses": [x["loss"] for x in r0["plain"]["losses"]],
            "grad_norm": r0["plain"]["grad_norm"],
            "update_cosine": r0["plain"]["update_cosine"],
            "update_rel_l2": r0["plain"]["update_rel_l2"],
            "bit_equal_to_one_process":
                r0["plain"]["bit_equal_to_one_process"],
            "zero1_shadow_bit_equal": r0["plain"]["zero1_bit_equal"],
            "checksum": r0["checksum"]}
        runs[tag].update({f: {run: [x[run][f] for x in res]
                              for run in ("plain", "zero1") if run in r0}
                          for f in ("step_ms", "peak_bytes", "launches")})
        if "zero1" in r0:
            runs[tag].update(repeat_distance=r0["repeat_distance"],
                             preempt=r0["preempt"])
        scaling = ("" if backend == "nccl" and n > 1 else
                   "; no scaling figure: "
                   + ("one rank" if n == 1 else "the ranks share one card"))
        print(f"  {n} rank(s), {backend}, {r0['rows']} rows a rank: step ms "
              f"{runs[tag]['step_ms']}{scaling}; losses "
              f"{[round(x, 5) for x in runs[tag]['losses']]}, grad norm "
              f"{r0['plain']['grad_norm']:.6g}, update cosine "
              f"{r0['plain']['update_cosine']:.6f} (rel L2 "
              f"{r0['plain']['update_rel_l2']:.4g}), bit-equal to one "
              f"process: {r0['plain']['bit_equal_to_one_process']}; peak "
              f"bytes {runs[tag]['peak_bytes']}; ZeRO-1 on the same "
              f"gradients bit-equal; checksums equal; {wall:.1f} s")
        if "zero1" in r0:
            pre = r0["preempt"]
            print(f"    ZeRO-1 preempted at {DP_PREEMPT_AT} ({pre['reason']}; "
                  f"save {pre['save_s']:.2f} s, load {pre['load_s']:.2f} s), "
                  f"the saved state restored bit for bit, resumed: (max, "
                  f"L2) {r0['repeat_distance']} from the plain run")

    return runs


def _start_run(cmd: list, where: str, extra_env: dict):
    """A fine-tune CLI command `cmd` with --output_dir `where` started in
    the background, its output in `where`.stdout, the preemption variables
    cleared but for `extra_env`; (process, file, path, start time)."""
    repo = os.path.dirname(os.path.abspath(__file__))
    i = cmd.index("--output_dir")
    env = {k: v for k, v in os.environ.items()
           if k not in ("ECAMP_PREEMPT_AT_STEP", "ECAMP_RSS_LIMIT_GB")}
    f = open(where + ".stdout", "w")
    p = subprocess.Popen(cmd[:i + 1] + [where] + cmd[i + 2:], cwd=repo,
                         stdout=f, stderr=subprocess.STDOUT, text=True,
                         env={**env, **extra_env}, start_new_session=True)
    _STARTED.append(p)
    return p, f, where + ".stdout", time.perf_counter()


def start_preempted(cmd: list, ref_out: str, per_epoch: int):
    """(7e)-(9e)'s preempted run, started beside (c)'s run of `cmd`, which
    it does not read: `cmd` in `ref_out`_preempt with ECAMP_PREEMPT_AT_STEP
    at the second epoch's second micro-step."""
    return _start_run(cmd, ref_out + "_preempt",
                      {"ECAMP_PREEMPT_AT_STEP": str(per_epoch + 1)})


def preempt_drill(tag: str, cmd: list, ref_out: str, per_epoch: int,
                  per_step: dict, n_eval: int, metric: str,
                  test_key: str, marker: str, first) -> dict:
    """(7e), (8e), (9e): the (c) step's fine-tune command `cmd` again in a
    fresh --output_dir with ECAMP_PREEMPT_AT_STEP at the second epoch's
    second micro-step (mid-epoch, after the first validation, so the early
    stopper's state and the best .pth are part of what is restored; the
    run `first`, which `start_preempted` started beside (c)): exit
    0, JAX's message, the file, no test line; then the same command
    without the variable: the resume line, the test line, `preempt/` gone.
    Held against (c)'s uninterrupted run in `ref_out`: the validation
    steps equal; the best .pth and the validation and test metrics equal
    bit for bit, or, where they are not, no farther from (c)'s than
    PREEMPT_SPREAD times the spread of `cmd` run once more uninterrupted
    (the best .pth's L2 distance; the largest metric difference of that
    repeat and of (e)'s validations before the save): a run whose
    gradients go through an atomic backward (`F.interpolate`'s, or a
    nondeterministic cuDNN algorithm's) does not repeat itself. The launches
    of each validation line as (c) counts them, the first after the resume
    counting from the resume. Returns the figures, the save's and the
    resume's seconds and the file's bytes among them."""
    import torch

    t_phase = time.perf_counter()
    at = per_epoch + 1
    out = ref_out + "_preempt"

    def start(extra_env, where):
        run = _start_run(cmd, where, extra_env)
        procs.append(run[0])
        return run

    def wait(what, run):
        p, f, path, t = run
        try:
            p.wait(timeout=max(1.0, CLI_TIMEOUT - (time.perf_counter() - t)))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        f.close()
        printed = text(path)
        check(p.returncode == 0,
              f"({tag}) {what} exited {p.returncode}:\n{printed[-4000:]}")
        return printed, time.perf_counter() - t

    def text(path):
        with open(path) as f:
            return f.read()

    def log(path):
        return [json.loads(line)
                for line in text(os.path.join(path, "log.txt")).splitlines()]

    def vals(recs):
        return [(r["step"], r[metric], r["best"]) for r in recs
                if "step" in r]

    procs = [first[0]]
    again = ref_out + "_again"

    def drill():
        printed, save_run_s = wait("the preempted run", first)
        msg = (f"preemption checkpoint saved @ micro {at} (optimizer step "
               f"{at}); rerun with the same --output_dir to resume")
        check(msg in printed, f"({tag}) no '{msg}' in:\n{printed[-2000:]}")
        check(marker not in printed, f"({tag}) a test line after the save")
        path = os.path.join(out, "preempt", f"checkpoint-step-{at}.pth")
        check(os.path.exists(path), f"({tag}) no {path}")
        got = re.search(r"wrote .* \((\d+) bytes\) in ([\d.]+) s", printed)
        nbytes, save_s = int(got[1]), float(got[2])
        meta = torch.load(path, map_location="cpu",
                          weights_only=True)["meta"]
        check((meta["micro"], meta["step"], meta["has_best"])
              == (at, at, True), f"({tag}) the file's counters {meta}")
        recs_saved = log(out)
        printed, resume_run_s = wait("the resumed run", start({}, out))
        line = (f"resuming from preemption checkpoint: micro {at} (optimizer "
                f"step {at}, epoch {at // per_epoch})")
        check(line in printed, f"({tag}) no '{line}' in:\n{printed[-2000:]}")
        got = re.search(r"read .* \(\d+ bytes\) in ([\d.]+) s", printed)
        resume_s = float(got[1])
        check(marker in printed, f"({tag}) no test line after the resume")
        check(not os.path.exists(os.path.join(out, "preempt")),
              f"({tag}) preempt/ left after the end")
        ref_recs, recs = log(ref_out), log(out)

        # each validation line's launches: (c)'s before the save, from the
        # resume after it
        done = at
        for r in recs[len(vals(recs_saved)):]:
            if "step" not in r:
                continue
            want = {k: per_step[k] * (r["step"] - done + n_eval)
                    for k in ("layer_norm", "attention")}
            if "adamw" in per_step:  # one an update; a validation runs none
                want["adamw"] = per_step["adamw"] * (r["step"] - done)
            check(r["kernel_launches"] == want, f"({tag}) launches "
                  f"{r['kernel_launches']} != {want} after the resume")
            done = r["step"]
        n_saved = len(vals(recs_saved))
        check([r["kernel_launches"] for r in recs_saved if "step" in r]
              == [r["kernel_launches"] for r in ref_recs[:n_saved]],
              f"({tag}) launches before the save differ from (c)'s")

        def best(path):
            return torch.load(
                os.path.join(path, "best", "checkpoint-best.pth"),
                map_location="cpu", weights_only=True)["model"]

        def metrics(recs):  # each validation's, then the test's
            test = recs[-1][test_key]
            return [v[1] for v in vals(recs)] + [
                test[metric] if test_key == "test" else test]

        def best_step(recs):  # the validation whose .pth the run kept
            v = vals(recs)
            return next(st for st, m, _ in v if m == v[-1][2])

        def l2(a, b):
            return float(sum(float(((a[k].double() - b[k].double()) ** 2)
                                   .sum()) for k in a) ** 0.5)

        ref_best, got_best = best(ref_out), best(out)
        check(ref_best.keys() == got_best.keys(), f"({tag}) best .pth keys")
        bitwise = all(torch.equal(ref_best[k], got_best[k]) for k in ref_best)
        diffs = [abs(a - b) for a, b in zip(metrics(recs), metrics(ref_recs))]
        steps_equal = ([v[0] for v in vals(recs)]
                       == [v[0] for v in vals(ref_recs)])
        d_e = l2(got_best, ref_best)
        spread = {}
        if bitwise:
            held, within = "bit for bit", max(diffs) == 0.0
        else:
            # where (c) itself does not repeat on the card (an atomic
            # backward): its spread, from the same command once more,
            # uninterrupted; (e)'s validations before
            # the save are samples of it too
            _, again_s = wait("the repeat of (c)", start({}, again))
            again_recs = log(again)
            noise = [abs(a - b) for a, b in zip(metrics(again_recs),
                                                metrics(ref_recs))]
            noise = max(noise + diffs[:n_saved])
            steps = {"c": best_step(ref_recs), "e": best_step(recs),
                     "repeat": best_step(again_recs)}
            spread = {"repeat_seconds": again_s,
                      "metric_max_diff_repeat": noise, "best_steps": steps}
            metrics_ok = max(diffs[n_saved:]) <= PREEMPT_SPREAD * noise
            if len(set(steps.values())) == 1:
                d_n = l2(best(again), ref_best)
                spread["best_l2_repeat"] = d_n
                within = metrics_ok and d_e <= PREEMPT_SPREAD * d_n
                held = (f"within {PREEMPT_SPREAD:g}x the spread of (c) "
                        f"repeated (best .pth L2 {d_e:.3e}, the repeat's "
                        f"{d_n:.3e})")
            else:
                # the runs kept the best .pth of different steps: in every run
                # the validations at those steps lie within the spread, so the
                # choice between them is the card's noise, and the .pth files
                # are of different steps
                by_step = [{st: m for st, m, _ in vals(rr)}
                           for rr in (ref_recs, recs, again_recs)]
                gap = max(abs(v[a] - v[b]) for v in by_step
                          for a in steps.values() for b in steps.values())
                spread["best_step_gap"] = gap
                within = metrics_ok and gap <= PREEMPT_SPREAD * noise
                held = (f"within {PREEMPT_SPREAD:g}x the spread of (c) "
                        f"repeated (the best .pth of steps {steps}: in "
                        f"each run their validations {gap:.3e} apart)")
            held = held if within else f"neither: {held}"
            shutil.rmtree(again, ignore_errors=True)
        phase_s = time.perf_counter() - t_phase
        print(f"  ({tag}) preempted at micro-step {at} (epoch "
              f"{at // per_epoch}, batch {at % per_epoch}, after the first "
              f"validation): the save "
              f"{save_s:.3f} s for {nbytes} bytes, the resume's read "
              f"{resume_s:.3f} s; the runs {save_run_s:.1f} s and "
              f"{resume_run_s:.1f} s, the phase {phase_s:.1f} s")
        print(f"  ({tag}) against (c): {held}; validations {vals(recs)} "
              f"against {vals(ref_recs)}, test {metrics(recs)[-1]} against "
              f"{metrics(ref_recs)[-1]} (metric differences {diffs}"
              + (f", the repeat's largest "
                 f"{spread['metric_max_diff_repeat']:.3e}" if spread else "")
              + ")")
        check(steps_equal and within, f"({tag}) the resumed run is not (c)'s: "
              f"{held}")
        shutil.rmtree(out, ignore_errors=True)
        return {"at_micro_step": at, "epoch": at // per_epoch,
                "batch": at % per_epoch, "save_seconds": save_s,
                "resume_read_seconds": resume_s, "checkpoint_bytes": nbytes,
                "preempted_run_seconds": save_run_s,
                "resumed_run_seconds": resume_run_s, "phase_seconds": phase_s,
                "held": held, "best_l2": d_e, "metric_diffs": diffs,
                "validations": vals(recs), "test": metrics(recs)[-1], **spread}

    try:
        return drill()
    finally:
        for p in procs:  # a failed check leaves no run behind
            if p.poll() is None:
                p.kill()
                p.wait()


def finetune_kernel_phase(card: str, rows: list) -> dict:
    """LayerNorm and attention at the fine-tune step's shapes (B = FT_B,
    bf16): the trunk's (B * 197, 768) and fc_norm's (B, 768) LayerNorm and
    the (B, 12, 197, 64) attention, each forward beside its library call
    and bound, then forward + backward through its Function against
    autograd of the plain version. Their rows join `rows`; returns the
    forward rows by name."""
    import torch

    from ecamp_tpu_torch.kernels import flash_attention as fa
    from ecamp_tpu_torch.kernels import layer_norm as ln

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    b, dtype, main = FT_B, torch.bfloat16, {}
    print(f"kernels at the fine-tune step's shapes (B = {b}, bf16) on {card}")
    for n, tag in ((b * 197, "trunk"), (b, "fc_norm")):
        x = (torch.randn(n, 768, device=dev, generator=gen) * 2 + 0.5).to(
            dtype)
        w = 1 + 0.1 * torch.randn(768, device=dev, generator=gen)
        bias = 0.1 * torch.randn(768, device=dev, generator=gen)
        g = torch.randn(n, 768, device=dev, generator=gen).to(dtype)
        main[f"layer_norm_{tag}"] = _layer_norm_fwd(
            rows, f"finetune layer_norm {tag} fwd ({n}, 768) {dtype}", x, w,
            bias, 1e-6, dtype)
        compare(f"finetune layer_norm {tag} fwd+bwd ({n}, 768) {dtype}",
                _grads_of(lambda *a: ln.fused_layer_norm(*a, 1e-6),
                          (x, w, bias), (True,) * 3, g),
                _grads_of(lambda *a: ln._ln_reference(*a, 1e-6),
                          (x, w, bias), (True,) * 3, g),
                dtype, reps=10, per_pair=3)
    q, k, v, g = (torch.randn(b, 12, 197, 64, device=dev, generator=gen)
                  .to(dtype) for _ in range(4))
    label = f"finetune attention ({b}, 12, 197, 64) {dtype}"
    main["attention"] = _attention_fwd(rows, f"{label} fwd", q, k, v, None,
                                       dtype)
    compare(f"{label} fwd+bwd",
            _grads_of(lambda *a: fa.flash_attention(*a), (q, k, v),
                      (True,) * 3, g),
            _grads_of(lambda *a: fa._attention_reference(*a), (q, k, v),
                      (True,) * 3, g),
            dtype, reps=10, per_pair=3)
    torch.cuda.synchronize()
    return main


def finetune_phase(card: str, pretrained: str, work: str) -> dict:
    """The classification fine-tune at full width (module docstring, 7)."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from ecamp_tpu_torch.core import config as c
    from ecamp_tpu_torch.kernels import flash_attention as fa
    from ecamp_tpu_torch.kernels import fused_adamw as adamw
    from ecamp_tpu_torch.kernels import layer_norm as ln
    from ecamp_tpu_torch.train.classification import ClassificationTask

    gc.collect()
    torch.cuda.empty_cache()
    cfg = c.ClassificationConfig(
        vit=c.ViTConfig(drop_path_rate=0.1),
        optimizer=c.OptimizerConfig(name="sgd", lr=3e-2, weight_decay=0.0,
                                    momentum=0.9,
                                    schedule="warmup_cosine_step",
                                    warmup_steps=50, total_steps=3000,
                                    grad_clip=1.0),
        seed=SEED)
    depth = cfg.vit.depth
    per_step = {"layer_norm": 2 * depth + 1, "attention": depth}
    counters = {"layer_norm": ln.launches, "attention": fa.launches}
    t0 = time.perf_counter()
    task = ClassificationTask(cfg, device="cuda")
    model = task.model
    # The JAX head init (std 2e-5) leaves the loss at ln 2 for any trunk;
    # redraw the head from the seed at std 0.05 so the comparisons see it.
    with torch.no_grad():
        model.head.weight.copy_(0.05 * torch.randn(
            model.head.weight.shape, generator=torch.Generator()
            .manual_seed(SEED + 1)))
    init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    images = torch.randint(0, 256, (FT_B, 224, 224, 1), dtype=torch.uint8,
                           device="cuda", generator=gen)
    labels = (torch.rand(FT_B, cfg.num_classes, device="cuda",
                         generator=gen) < 0.3).float()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"fine-tune on {card}: ViT-B/16 224 px, {cfg.num_classes} "
          f"multilabel classes, {n_params} parameters, B = {FT_B}, bf16, SGD "
          f"momentum 0.9 lr 3e-2 warmup 50 clip 1.0, drop-path 0.1; built "
          f"in {time.perf_counter() - t0:.1f} s")

    def counts():
        return {k: ctr.value for k, ctr in counters.items()}

    def reset():
        for ctr in counters.values():
            ctr.reset()

    def first_step(plain: bool):
        model.load_state_dict(init)
        task.set_plain(plain)
        state = task.init_state()
        reset()
        state, m = task.train_step(state, images, labels)
        gnorm = adamw.global_norm([p.grad for p in model.parameters()])
        torch.cuda.synchronize()
        return float(m["loss"]), float(gnorm), counts()

    # (a) the first step through the kernels, then the plain versions
    loss_k, gnorm_k, n_k = first_step(False)
    loss_p, gnorm_p, n_p = first_step(True)
    task.set_plain(False)
    print(f"  (a) first step: kernels loss {loss_k:.6g} grad norm "
          f"{gnorm_k:.6g} launches {n_k}; plain loss {loss_p:.6g} grad norm "
          f"{gnorm_p:.6g} launches {n_p}")
    check(np.isfinite(loss_k) and np.isfinite(gnorm_k), "non-finite step")
    check(n_k == per_step, f"(a) launches {n_k} != {per_step}")
    check(all(v == 0 for v in n_p.values()), f"plain step launched {n_p}")
    check(abs(loss_k - loss_p) <= LOSS_TOL * abs(loss_p),
          f"(a) loss {loss_k:.6g} vs plain {loss_p:.6g}")
    check(abs(gnorm_k - gnorm_p) <= GNORM_TOL * gnorm_p,
          f"(a) grad norm {gnorm_k:.6g} vs plain {gnorm_p:.6g}")

    def eval_loss():
        model.eval()
        with torch.no_grad():
            return float(task.loss(images, labels)[0])

    def steps(n):
        """n steps from `init` (dropout and drop-path on), counters set to
        0 just before and read just after; the eval-mode loss of the batch
        before and after, the step times, the launches, peak memory and the
        device busy time of one more step (profiler)."""
        model.load_state_dict(init)
        state = task.init_state()
        before = eval_loss()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        losses, times = [], []
        for _ in range(n):
            t = time.perf_counter()
            state, m = task.train_step(state, images, labels)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
            losses.append(float(m["loss"]))
        launches = counts()
        peak = torch.cuda.max_memory_allocated()
        box = [state]

        def one_step():
            box[0], _ = task.train_step(box[0], images, labels)

        busy = device_ms(one_step, "", 3, "fine-tune step", alone=False)
        return before, eval_loss(), losses, times, launches, peak, busy

    def report(tag, n, before, after, losses, times, launches, peak, busy):
        want = {k: v * n for k, v in per_step.items()}
        step_ms = float(np.median(times[1:]))
        print(f"  ({tag}) train losses {[round(x, 5) for x in losses]}; "
              f"eval-mode loss of the batch {before:.6f} -> {after:.6f}; "
              f"launches {launches} in {n} steps")
        print(f"  ({tag}) step {step_ms:.3f} ms median of steps 2-{n} (host "
              f"clock, synchronised), {FT_B / step_ms * 1e3:.2f} images/s, "
              f"device busy {_ms(busy)} a step (profiler, 3 steps), peak "
              f"device memory {peak / 2 ** 30:.3f} GiB on {card}")
        check(all(np.isfinite(losses)), f"({tag}) non-finite loss")
        check(launches == want, f"({tag}) launches {launches} != {want}")
        return {"losses": losses, "eval_loss_before": before,
                "eval_loss_after": after, "step_ms": times,
                "step_ms_median": step_ms,
                "images_per_s": FT_B / step_ms * 1e3,
                "device_busy_ms": busy, "max_memory_allocated_bytes": peak,
                "launches": launches}

    before, after, *rest = steps(FT_STEPS)
    result = {"batch": FT_B, "card": card, "loss_first_step": loss_k,
              "loss_plain_step": loss_p, "grad_norm": gnorm_k,
              "grad_norm_plain": gnorm_p,
              "finetune": report("a", FT_STEPS, before, after, *rest)}
    # the launches counted in (a)'s steps, a step
    result["launches_a_step"] = {
        k: v // FT_STEPS for k, v in result["finetune"]["launches"].items()}
    check(after < before, f"(a) the eval-mode loss did not fall: {before} "
          f"-> {after}")

    # (b) the linear probe from the same weights
    task.cfg = dataclasses.replace(cfg, linear_probe=True)
    before, after, *rest = steps(FT_PROBE_STEPS)
    result["linear_probe"] = report("b", FT_PROBE_STEPS, before, after, *rest)
    now = model.state_dict()
    for k, v in now.items():
        same = torch.equal(v.cpu(), init[k])
        check(same == (not k.startswith("head.")),
              f"(b) {k} {'unchanged' if same else 'changed'}")
    print("  (b) trunk and fc_norm bit-unchanged, head changed")
    task.cfg = cfg
    del now, images, labels
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the CLI from the pretrain CLI's checkpoint
    from ecamp_tpu_torch.data.synthetic import write_classification_corpus

    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    data = write_classification_corpus(
        os.path.join(work, "cxr14"), cfg.task, *FT_SPLITS, seed=SEED,
        num_classes=cfg.num_classes, multilabel=True, img_size=FT_IMG)
    out = os.path.join(work, "ft_out")
    print(f"  (c) {'/'.join(map(str, FT_SPLITS))} JPEGs at {FT_IMG} px "
          f"written in {time.perf_counter() - t0:.1f} s")
    per_epoch = FT_SPLITS[0] // FT_B
    cmd = [sys.executable, "-m", "ecamp_tpu_torch.cli.finetune_cls",
           "--task", cfg.task, "--dataset_path", data, "--pretrained",
           pretrained, "--batch_size", str(FT_B), "--eval_batch_size",
           str(FT_EVAL_B), "--lr", "3e-2", "--warmup_steps", "50",
           "--num_steps", str(2 * per_epoch), "--patience", "1",
           "--output_dir", out, "--seed", str(SEED)]
    # (e)'s preempted run starts now and runs beside (c) and (d)
    first = start_preempted(cmd, out, per_epoch)
    t = time.perf_counter()
    r = subprocess.run(cmd, cwd=repo, capture_output=True, text=True,
                       timeout=CLI_TIMEOUT)
    check(r.returncode == 0, f"fine-tune CLI exited {r.returncode}:\n"
          f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    cli_s = time.perf_counter() - t
    with open(os.path.join(out, "log.txt")) as f:
        recs = [json.loads(line) for line in f]
    printed = r.stdout
    for line in printed.splitlines():
        if line.startswith(("step ", "Epoch [", "TEST", pretrained,
                            "loaded ")):
            print(f"    {line}")
    n_val = -(-FT_SPLITS[1] // FT_EVAL_B)
    want = {k: v * (per_epoch + n_val) for k, v in per_step.items()}
    vals = [rec for rec in recs if "step" in rec]
    check([rec["step"] for rec in vals] == [per_epoch, 2 * per_epoch],
          f"(c) validations at steps {[rec['step'] for rec in vals]}")
    for rec in vals:
        check(np.isfinite(rec["auc"]) and np.isfinite(rec["loss"]),
              f"(c) non-finite validation {rec}")
        check(rec["kernel_launches"] == want,
              f"(c) launches {rec['kernel_launches']} != {want} (steps "
              f"and a validation)")
    # the trunk from the pretraining checkpoint: patch embedding, cls
    # token and 12 tensors a block; pos_embed (a buffer in the port's
    # ECAMP), fc_norm and the head stay at init
    got = re.search(r": loaded (\d+) tensors, (\d+) left at init", printed)
    check(got is not None and (int(got[1]), int(got[2])) == (
        3 + 12 * depth, 5), f"(c) pretrained load: {got and got[0]}")
    check("TEST mean AUROC:" in printed and "test" in recs[-1],
          "(c) no test line")
    check(printed.count("Total time:") == len(vals), "(c) epoch lines")
    best = os.path.join(out, "best", "checkpoint-best.pth")
    check(os.path.exists(best), "(c) no best checkpoint")
    print(f"  (c) CLI {cli_s:.1f} s: validations {vals}, test mean AUROC "
          f"{recs[-1]['test']['auc']:.4f}")

    # (d) the serve engine on the best .pth against the task's eval step
    from PIL import Image

    from ecamp_tpu_torch.ckpt import load_reference_pth, load_reference_state
    from ecamp_tpu_torch.data.transforms import EvalTransform
    from ecamp_tpu_torch.serve import classifier_engine

    engine = classifier_engine(best, num_classes=cfg.num_classes,
                               img_size=224, multilabel=True, buckets=(8,),
                               device="cuda")
    load_reference_state(model, load_reference_pth(best))
    et = EvalTransform(224, cfg.data.mean, cfg.data.std, crop_ratio=1.0)
    with open(os.path.join(data, cfg.task, "test_list.txt")) as f:
        paths = [os.path.join(data, line.split()[0]) for line in f][:5]
    x = np.stack([et(Image.open(p).convert("RGB")) for p in paths])
    served = engine(x)
    logits = task.eval_step(None, torch.from_numpy(x).cuda())
    want_p = torch.sigmoid(logits.float()).cpu().numpy()
    err = float(np.abs(served - want_p).max())
    print(f"  (d) engine on the best .pth: {len(paths)} test images, max "
          f"|served - eval_step| {err:.3e}")
    check(served.shape == want_p.shape and err <= PROB_TOL,
          f"(d) served probabilities off by {err:.3e}")
    result.update(cli_seconds=cli_s, cli_log=recs, served_max_err=err)
    del task, model, engine
    gc.collect()
    torch.cuda.empty_cache()
    # (e) the same CLI preempted after its first validation and resumed
    result["preemption"] = preempt_drill("e", cmd, out, per_epoch, per_step,
                                         n_val, "auc", "test",
                                         "TEST mean AUROC:", first)
    return result


def masked_adamw_check(label: str, opt, named: dict, count: int,
                       ktimes: dict, rows: list, masked: bool = True) -> None:
    """The AdamW kernel on the masked leaves of a fine-tune step (`named`:
    the trainable parameters, their `.grad` set; every leaf if not
    `masked`) against the per-leaf
    formula, from fresh moments at update `count`, the end of the warmup
    (at count 0 the schedule's lr is 0 and no parameter would move):
    parameters, mu and nu within 1e-6 relative, and every leaf with a
    gradient moving on both sides. Its times join `ktimes` and `rows`."""
    import torch

    from ecamp_tpu_torch.kernels import fused_adamw as adamw

    params = {k: p.detach() for k, p in named.items()}
    grads = {k: p.grad for k, p in named.items()}
    n_train = sum(p.numel() for p in params.values())
    state0 = opt.init(params)
    state0.count.fill_(count)
    lr = float(opt.schedule(state0.count))

    def adamw_copy():
        return ({k: p.clone() for k, p in params.items()},
                adamw.AdamWState(count=state0.count.clone(),
                                 mu={k: t.clone() for k, t in
                                     state0.mu.items()},
                                 nu={k: t.clone() for k, t in
                                     state0.nu.items()}))

    pk, sk = adamw_copy()
    opt.apply(pk, grads, sk)
    opt.plain = True
    pp, sp = adamw_copy()
    opt.apply(pp, grads, sp)
    torch.cuda.synchronize()
    err, moved = 0.0, 0.0
    check(lr > 0, f"{label} adamw: lr {lr} at count {count}")
    for k in pk:
        for got, want in ((pk[k], pp[k]), (sk.mu[k], sp.mu[k]),
                          (sk.nu[k], sp.nu[k])):
            d = (got - want).abs()
            check(bool((d <= 1e-6 * want.abs() + 1e-12).all()),
                  f"{label} adamw {k}: max |err| {float(d.max()):.3e}")
        err = max(err, float((pk[k] - pp[k]).abs().max()))
        # every leaf with a gradient moves, on both sides
        dk = float((pk[k] - params[k]).abs().max())
        dp = float((pp[k] - params[k]).abs().max())
        check((dk > 0 and dp > 0) or not bool(grads[k].any()),
              f"{label} adamw {k}: no update (kernel {dk:.3e}, plain "
              f"{dp:.3e})")
        moved = max(moved, dk)
    check(moved > 0, f"{label} adamw: no parameter moved")
    opt.plain = False
    times = {"max_abs_err": err, "lr": lr, "max_update": moved,
             "ms": median_ms(lambda: opt.apply(pk, grads, sk), 10, 2),
             "device_ms": device_ms(lambda: opt.apply(pk, grads, sk),
                                    "adamw_multi", 5, f"{label} adamw")}
    opt.plain = True
    times["plain_ms"] = median_ms(lambda: opt.apply(pp, grads, sp), 10, 2)
    opt.plain = False
    times["bound_ms"], times["bound_by"] = bound(adamw_work(n_train))
    times["leaves"] = len(params)
    print(f"  {label} adamw at count {count} (lr {lr:.3g}): max |update| "
          f"{moved:.3e}")
    print(f"  {label + ' adamw, ' + str(n_train) + ' fp32 parameters':58s}"
          f" max|err| {err:.3e}  kernel {times['ms']:8.4f} ms  plain "
          f"{times['plain_ms']:8.4f} ms  device {_ms(times['device_ms'])}  "
          f"bound {times['bound_ms']:8.4f} ms ({times['bound_by']})")
    ktimes["adamw"] = times
    rows.append({"kernel": "adamw", "shape": f"{label} adamw "
                 f"{'masked' if masked else 'unmasked'} ({len(params)} "
                 f"leaves, {n_train}) fp32", **times})


def segmentation_kernel_phase(card: str, rows: list) -> dict:
    """LayerNorm and attention forward at the frozen trunk's shapes in the
    segmentation step (B = SEG_B, bf16: (B * 197, 768), (B, 12, 197, 64)),
    each beside its library call and bound, both timed on the device by
    queued events (the profiler dropped kernels of sessions at these
    shapes); their rows join `rows`. Returns the rows by name."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    b, dtype, main = SEG_B, torch.bfloat16, {}
    print(f"kernels at the segmentation step's shapes (B = {b}, bf16) on "
          f"{card}")
    n = b * 197
    x = (torch.randn(n, 768, device=dev, generator=gen) * 2 + 0.5).to(dtype)
    w = 1 + 0.1 * torch.randn(768, device=dev, generator=gen)
    bias = 0.1 * torch.randn(768, device=dev, generator=gen)
    main["layer_norm"] = _layer_norm_fwd(
        rows, f"segmentation layer_norm fwd ({n}, 768) {dtype}", x, w, bias,
        1e-6, dtype, events=True)
    del x
    q, k, v = (torch.randn(b, 12, 197, 64, device=dev, generator=gen)
               .to(dtype) for _ in range(3))
    main["attention"] = _attention_fwd(
        rows, f"segmentation attention fwd ({b}, 12, 197, 64) {dtype}", q, k,
        v, None, dtype, events=True)
    del q, k, v
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return main


def _seg_batch(b, channels, gen):
    """A seeded u8 gray batch (b, 224, 224, 1) whose masks are discs that
    brighten the image, so the loss can fall: masks (b, 224, 224,
    channels), RIGA's cup a disc inside the disc."""
    import torch

    dev = gen.device
    yy, xx = torch.meshgrid(torch.arange(224, device=dev),
                            torch.arange(224, device=dev), indexing="ij")
    c = 40 + 144 * torch.rand(b, 2, 1, 1, device=dev, generator=gen)
    r = 15 + 35 * torch.rand(b, 1, 1, device=dev, generator=gen)
    d2 = (yy - c[:, 0]) ** 2 + (xx - c[:, 1]) ** 2
    masks = [(d2 <= r ** 2).float()]
    if channels == 2:
        masks.append((d2 <= (0.5 * r) ** 2).float())
    noise = 25 * torch.randn(b, 224, 224, device=dev, generator=gen)
    img = (100 + noise + 70 * masks[0]).clamp(0, 255).to(torch.uint8)
    return img[..., None], torch.stack(masks, dim=-1)


def segmentation_phase(card: str, pretrained: str, work: str,
                       ktimes: dict, rows: list) -> dict:
    """The segmentation fine-tune at full width (module docstring, 8). The
    masked AdamW's times join `ktimes` and `rows`."""
    import gc

    import numpy as np
    import torch

    from ecamp_tpu_torch.core import config as c
    from ecamp_tpu_torch.kernels import flash_attention as fa
    from ecamp_tpu_torch.kernels import fused_adamw as adamw
    from ecamp_tpu_torch.kernels import layer_norm as ln
    from ecamp_tpu_torch.ops.image_ops import upsample_align_corners
    from ecamp_tpu_torch.train.segmentation import SegmentationTask

    gc.collect()
    torch.cuda.empty_cache()

    def seg_cfg(task, lr, warmup, total):
        return c.SegmentationConfig(
            optimizer=c.OptimizerConfig(
                name="adamw", lr=lr, weight_decay=0.05, betas=(0.9, 0.999),
                schedule="warmup_cosine_step", warmup_steps=warmup,
                total_steps=total, grad_clip=1.0),
            task=task, seed=SEED)

    cfg = seg_cfg("SIIM", 5e-4, 50, 3000)
    depth = cfg.vit.depth
    per_step = {"layer_norm": 2 * depth, "attention": depth, "adamw": 1}
    counters = {"layer_norm": ln.launches, "attention": fa.launches,
                "adamw": adamw.launches}

    def counts():
        return {k: ctr.value for k, ctr in counters.items()}

    def reset():
        for ctr in counters.values():
            ctr.reset()

    t0 = time.perf_counter()
    task = SegmentationTask(cfg, device="cuda")
    model = task.model
    mask = task.freeze_mask()
    trainable = [k for k, keep in mask.items() if keep]
    n_params = sum(p.numel() for p in model.parameters())
    n_train = sum(p.numel() for k, p in model.named_parameters() if mask[k])
    n_stats = sum(t.numel() for k, t in model.state_dict().items()
                  if "running_" in k)
    print(f"segmentation on {card}: SegViT ViT-B/16 224 px, decoder "
          f"{cfg.decode_features}, {n_params} parameters, {n_train} "
          f"trainable in {len(trainable)} leaves, {n_stats} BatchNorm "
          f"statistics, B = {SEG_B}, bf16, AdamW lr 5e-4 wd 0.05 warmup 50 "
          f"of 3000 clip 1.0, encoder frozen; built in "
          f"{time.perf_counter() - t0:.1f} s")
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    images, masks = _seg_batch(SEG_B, 1, gen)

    def stats():
        return torch.cat([t.float().flatten() for k, t in
                          model.state_dict().items() if "running_" in k])

    def first_step(plain: bool):
        model.load_state_dict(init)
        task.set_plain(plain)
        state = task.init_state()
        reset()
        state, m = task.train_step(state, images, masks)
        gnorm = adamw.global_norm([p.grad for k, p in
                                   model.named_parameters() if mask[k]])
        torch.cuda.synchronize()
        return float(m["loss"]), float(gnorm), counts(), stats()

    # (a) the first step through the kernels, then the plain versions
    loss_k, gnorm_k, n_k, stats_k = first_step(False)
    loss_p, gnorm_p, n_p, stats_p = first_step(True)
    task.set_plain(False)
    stats_err = float((stats_k - stats_p).abs().max())
    stats_scale = max(1.0, float(stats_p.abs().max()))
    print(f"  (a) first step: kernels loss {loss_k:.6g} grad norm "
          f"{gnorm_k:.6g} launches {n_k}; plain loss {loss_p:.6g} grad norm "
          f"{gnorm_p:.6g} launches {n_p}; BatchNorm statistics max |kernels "
          f"- plain| {stats_err:.3e} (scale {stats_scale:.3g})")
    check(np.isfinite(loss_k) and np.isfinite(gnorm_k), "non-finite step")
    check(n_k == per_step, f"(a) launches {n_k} != {per_step}")
    check(all(v == 0 for v in n_p.values()), f"plain step launched {n_p}")
    check(abs(loss_k - loss_p) <= LOSS_TOL * abs(loss_p),
          f"(a) loss {loss_k:.6g} vs plain {loss_p:.6g}")
    check(abs(gnorm_k - gnorm_p) <= GNORM_TOL * gnorm_p,
          f"(a) grad norm {gnorm_k:.6g} vs plain {gnorm_p:.6g}")
    check(stats_err <= LOSS_TOL * stats_scale,
          f"(a) BatchNorm statistics off by {stats_err:.3e}")

    # the AdamW kernel on the masked leaves of that step against the
    # per-leaf formula
    masked_adamw_check("segmentation", task.tx.inner,
                       {k: p for k, p in model.named_parameters()
                        if mask[k]}, cfg.optimizer.warmup_steps, ktimes,
                       rows)

    # one decoder upsample stage, the last: (B, 64, 112, 112) bf16
    # channels_last -> 224, through fp32 as the JAX package computes it.
    # Its device time is read by CUDA events around calls queued behind a
    # held stream (`queued_ms`): its calls launch several kernels each, so
    # `device_ms` could not tell a profiler session that dropped some
    up_in = torch.randn(SEG_B, 112, 112, 64, device="cuda",
                        generator=gen).to(torch.bfloat16).permute(0, 3, 1, 2)
    up_bytes = up_in.numel() * 2 * (1 + 4)
    upsample = {"shape": "(512, 64, 112, 112) bf16 -> 224",
                "ms": median_ms(lambda: upsample_align_corners(up_in, 2), 5,
                                2),
                "device_ms": queued_ms(lambda: upsample_align_corners(up_in,
                                                                      2), 5),
                "bound_ms": up_bytes / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes"}
    print(f"  decoder upsample stage 4 {upsample['shape']}: "
          f"{upsample['ms']:.3f} ms (events), device "
          f"{upsample['device_ms']:.3f} ms (queued events), bound "
          f"{upsample['bound_ms']:.3f} ms (bytes) on {card}")
    del up_in
    torch.cuda.empty_cache()

    def steps(t, start, imgs, msks, n, b):
        """n steps of task t from the state dict `start` on a fixed batch,
        counters set to 0 just before and read just after; the losses,
        step times, launches, peak memory and the device busy time of one
        more step (profiler)."""
        t.model.load_state_dict(start)
        state = t.init_state()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        losses, times = [], []
        for _ in range(n):
            t0 = time.perf_counter()
            state, m = t.train_step(state, imgs, msks)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
        launches = counts()
        peak = torch.cuda.max_memory_allocated()
        box = [state]

        def one_step():
            box[0], _ = t.train_step(box[0], imgs, msks)

        busy = device_ms(one_step, "", 3, "segmentation step", alone=False)
        step_ms = float(np.median(times[1:]))
        print(f"    train losses {[round(x, 5) for x in losses]}; launches "
              f"{launches} in {n} steps; step {step_ms:.3f} ms median of "
              f"steps 2-{n} (host clock, synchronised), "
              f"{b / step_ms * 1e3:.2f} images/s, device busy {_ms(busy)} a "
              f"step (profiler, 3 steps), peak device memory "
              f"{peak / 2 ** 30:.3f} GiB on {card}")
        check(all(np.isfinite(losses)), "non-finite segmentation loss")
        want = {k: v * n for k, v in per_step.items()}
        check(launches == want, f"launches {launches} != {want}")
        return {"losses": losses, "step_ms": times,
                "step_ms_median": step_ms, "images_per_s": b / step_ms * 1e3,
                "device_busy_ms": busy, "max_memory_allocated_bytes": peak,
                "launches": launches}

    print(f"  (a) {SEG_STEPS} steps at B = {SEG_B}")
    result = {"card": card, "batch": SEG_B, "parameters": n_params,
              "trainable": n_train, "trainable_leaves": len(trainable),
              "batch_norm_statistics": n_stats,
              "loss_first_step": loss_k, "loss_plain_step": loss_p,
              "grad_norm": gnorm_k, "grad_norm_plain": gnorm_p,
              "batch_norm_stats_max_err": stats_err,
              "upsample_stage4": upsample,
              "siim": steps(task, init, images, masks, SEG_STEPS, SEG_B)}
    # the launches counted in (a)'s steps, a step
    result["launches_a_step"] = {
        k: v // SEG_STEPS for k, v in result["siim"]["launches"].items()}
    losses = result["siim"]["losses"]
    check(losses[-1] < losses[0], f"(a) the loss did not fall: {losses}")

    def changed(t, before):
        now = t.model.state_dict()
        for k, v in now.items():
            trunk = k.startswith("encoder.") and not k.startswith(
                "encoder.seg_head.")
            same = torch.equal(v, before[k])
            check(same == trunk, f"{k} {'unchanged' if same else 'changed'}")

    changed(task, init)
    print("  (a) trunk bit-unchanged, seg_head and decoder changed")
    del task, model, images, masks, init
    gc.collect()
    torch.cuda.empty_cache()

    # (b) SegViTDual (RIGA) at B = SEG_DUAL_B
    dtask = SegmentationTask(seg_cfg("RIGA", 5e-4, 15, 500), device="cuda")
    dual_init = {k: v.detach().clone()
                 for k, v in dtask.model.state_dict().items()}
    n_dual = sum(p.numel() for p in dtask.model.parameters())
    dmask = dtask.freeze_mask()
    print(f"  (b) SegViTDual (RIGA): {n_dual} parameters, "
          f"{sum(p.numel() for k, p in dtask.model.named_parameters() if dmask[k])}"
          f" trainable in {sum(dmask.values())} leaves, {SEG_DUAL_STEPS} "
          f"steps at B = {SEG_DUAL_B}")
    dimgs, dmasks = _seg_batch(SEG_DUAL_B, 2, gen)
    result["riga"] = steps(dtask, dual_init, dimgs, dmasks, SEG_DUAL_STEPS,
                           SEG_DUAL_B)
    result["riga"]["parameters"] = n_dual
    changed(dtask, dual_init)
    print("  (b) trunk bit-unchanged, both decoders changed")
    del dtask, dual_init, dimgs, dmasks
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the CLI from the pretrain CLI's checkpoint on a seeded SIIM corpus
    from ecamp_tpu_torch.data.datasets import SIIMSegmentationDataset
    from ecamp_tpu_torch.data.synthetic import write_segmentation_corpus

    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    data = write_segmentation_corpus(os.path.join(work, "siim"), "SIIM",
                                     *SEG_SPLITS, seed=SEED,
                                     img_size=SEG_IMG)
    n_images = len(SIIMSegmentationDataset(data, data, "train"))
    per_epoch = n_images // SEG_CLI_B
    print(f"  (c) SIIM corpus {'/'.join(map(str, SEG_SPLITS))} rows, PNGs at "
          f"{SEG_IMG} px, RLE masks at 1024, written in "
          f"{time.perf_counter() - t0:.1f} s; {n_images} balanced training "
          f"images, {per_epoch} updates an epoch at B = {SEG_CLI_B}")
    check(per_epoch >= 1, "(c) the corpus fills no batch")
    out = os.path.join(work, "seg_out")
    cmd = [sys.executable, "-m", "ecamp_tpu_torch.cli.finetune_seg",
           "--task", "SIIM", "--dataset_path", data, "--pretrained",
           pretrained, "--batch_size", str(SEG_CLI_B), "--eval_batch_size",
           str(SEG_EVAL_B), "--lr", "5e-4", "--warmup_steps", "50",
           "--num_steps", str(2 * per_epoch), "--patience", "1",
           "--output_dir", out, "--seed", str(SEED)]
    # (e)'s preempted run starts now and runs beside (c) and (d)
    first = start_preempted(cmd, out, per_epoch)
    t = time.perf_counter()
    r = subprocess.run(cmd, cwd=repo, capture_output=True, text=True,
                       timeout=CLI_TIMEOUT)
    check(r.returncode == 0, f"segmentation CLI exited {r.returncode}:\n"
          f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    cli_s = time.perf_counter() - t
    with open(os.path.join(out, "log.txt")) as f:
        recs = [json.loads(line) for line in f]
    printed = r.stdout
    for line in printed.splitlines():
        if line.startswith(("step ", "Epoch [", "TEST", pretrained,
                            "loaded ")):
            print(f"    {line}")
    n_val = -(-SEG_SPLITS[1] // SEG_EVAL_B)
    want = {k: per_step[k] * (per_epoch + n_val)
            for k in ("layer_norm", "attention")}
    want["adamw"] = per_epoch  # one an update; a validation runs none
    vals = [rec for rec in recs if "step" in rec]
    check([rec["step"] for rec in vals] == [per_epoch, 2 * per_epoch],
          f"(c) validations at steps {[rec['step'] for rec in vals]}")
    for rec in vals:
        check(np.isfinite(rec["dice"]) and np.isfinite(rec["loss"]),
              f"(c) non-finite validation {rec}")
        check(rec["kernel_launches"] == want,
              f"(c) launches {rec['kernel_launches']} != {want} (steps "
              f"and a validation)")
    # the trunk from the pretraining checkpoint: patch embedding, cls token
    # and 12 tensors a block; pos_embed (a buffer in the port's ECAMP),
    # seg_head and the decoder (4 x 6 + 2) stay at init
    got = re.search(r": loaded (\d+) tensors, (\d+) left at init", printed)
    check(got is not None and (int(got[1]), int(got[2])) == (
        3 + 12 * depth, 1 + 2 + 4 * 6 + 2),
        f"(c) pretrained load: {got and got[0]}")
    check("TEST dice:" in printed and "test_dice" in recs[-1],
          "(c) no test line")
    best = os.path.join(out, "best", "checkpoint-best.pth")
    check(os.path.exists(best), "(c) no best checkpoint")
    print(f"  (c) CLI {cli_s:.1f} s: validations {vals}, test dice "
          f"{recs[-1]['test_dice']:.4f}")

    # (d) the serve engine on the best .pth against the task's eval step,
    # then one POST through the HTTP server
    from ecamp_tpu_torch.ckpt import load_reference_pth, load_reference_state
    from ecamp_tpu_torch.serve import segmenter_engine
    from ecamp_tpu_torch.serve.http_server import PredictionService, serve

    engine = segmenter_engine(best, img_size=224, buckets=(8,),
                              device="cuda")
    etask = SegmentationTask(cfg, device="cuda")
    load_reference_state(etask.model, load_reference_pth(best))
    ds = SIIMSegmentationDataset(data, data, "test")
    x = np.stack([ds[i]["image"] for i in range(5)])
    served = engine(x)
    want_p = etask.eval_step(None, torch.from_numpy(x).cuda()).cpu().numpy()
    err = float(np.abs(served - want_p).max())
    print(f"  (d) engine on the best .pth: {len(x)} test images, max |served "
          f"- eval_step| {err:.3e}")
    check(served.shape == want_p.shape == (5, 224, 224, 1) and err <= PROB_TOL,
          f"(d) served masks off by {err:.3e}")
    with open(ds.image_path(ds.img_ids[0]), "rb") as f:
        body = {"image": base64.b64encode(f.read()).decode()}
    service = PredictionService(engine, img_size=224, task="segmentation")
    httpd = serve(service, port=0, background=True)
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        reply = _http(f"{base}/predict", body)
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()
    pred = reply["predictions"][0]
    print(f"  (d) POST /predict with --task segmentation: {pred}")
    check(set(pred) == {"area_fraction", "bbox_xyxy"}
          and 0.0 <= pred["area_fraction"] <= 1.0, f"(d) reply {reply}")
    result.update(cli_seconds=cli_s, cli_log=recs, served_max_err=err,
                  http_reply=pred)
    del etask, engine
    gc.collect()
    torch.cuda.empty_cache()
    # (e) the same CLI preempted after its first validation and resumed
    result["preemption"] = preempt_drill("e", cmd, out, per_epoch, per_step,
                                         n_val, "dice", "test_dice",
                                         "TEST dice:", first)
    return result


def detection_kernel_phase(card: str, rows: list) -> dict:
    """LayerNorm and attention forward at the frozen trunk's shapes in the
    detection step (B = DET_B, bf16: (B * 197, 768), (B, 12, 197, 64)),
    each beside its library call and bound, both timed on the device by
    queued events; their rows join `rows`. Returns the rows by name."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    b, dtype, main = DET_B, torch.bfloat16, {}
    print(f"kernels at the detection step's shapes (B = {b}, bf16) on "
          f"{card}")
    n = b * 197
    x = (torch.randn(n, 768, device=dev, generator=gen) * 2 + 0.5).to(dtype)
    w = 1 + 0.1 * torch.randn(768, device=dev, generator=gen)
    bias = 0.1 * torch.randn(768, device=dev, generator=gen)
    main["layer_norm"] = _layer_norm_fwd(
        rows, f"detection layer_norm fwd ({n}, 768) {dtype}", x, w, bias,
        1e-6, dtype, events=True)
    del x
    q, k, v = (torch.randn(b, 12, 197, 64, device=dev, generator=gen)
               .to(dtype) for _ in range(3))
    main["attention"] = _attention_fwd(
        rows, f"detection attention fwd ({b}, 12, 197, 64) {dtype}", q, k, v,
        None, dtype, events=True)
    del q, k, v
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return main


def detection_phase(card: str, pretrained: str, work: str, ktimes: dict,
                    rows: list) -> dict:
    """The detection fine-tune at full width (module docstring, 9). The
    masked AdamW's times join `ktimes` and `rows`."""
    import gc

    import numpy as np
    import torch

    from ecamp_tpu_torch.core import config as c
    from ecamp_tpu_torch.data.synthetic import detection_batch
    from ecamp_tpu_torch.kernels import flash_attention as fa
    from ecamp_tpu_torch.kernels import fused_adamw as adamw
    from ecamp_tpu_torch.kernels import layer_norm as ln
    from ecamp_tpu_torch.train.detection import DetectionTask

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()

    def det_cfg(expansion, warmup, total):
        return c.DetectionConfig(
            expansion=expansion,
            optimizer=c.OptimizerConfig(
                name="adamw", lr=5e-4, weight_decay=0.05, betas=(0.9, 0.999),
                schedule="warmup_cosine_step", warmup_steps=warmup,
                total_steps=total, grad_clip=1.0),
            seed=SEED)

    cfg = det_cfg(4, 30, 20000)
    depth = cfg.vit.depth
    per_step = {"layer_norm": 2 * depth, "attention": depth, "adamw": 1}
    counters = {"layer_norm": ln.launches, "attention": fa.launches,
                "adamw": adamw.launches}

    def counts():
        return {k: ctr.value for k, ctr in counters.items()}

    def reset():
        for ctr in counters.values():
            ctr.reset()

    def trunk(k):
        return k.startswith("backbone.encoder.") and not k.startswith(
            "backbone.encoder.det_head.")

    t0 = time.perf_counter()
    task = DetectionTask(cfg, device="cuda")
    model = task.model
    mask = task.freeze_mask()
    trainable = [k for k, keep in mask.items() if keep]
    n_params = sum(p.numel() for p in model.parameters())
    n_train = sum(p.numel() for k, p in model.named_parameters() if mask[k])
    n_stats = sum(t.numel() for k, t in model.state_dict().items()
                  if "running_" in k)
    n_entries = sum(1 for k in model.state_dict()
                    if not k.endswith("num_batches_tracked"))
    print(f"detection on {card}: ViT-B/16 224 px + det_head + Bottleneck "
          f"neck (expansion 4) + YOLOv3 head (1 class), {n_params} "
          f"parameters, {n_train} trainable in {len(trainable)} leaves, "
          f"{n_stats} BatchNorm statistics, B = {DET_B}, bf16, AdamW lr 5e-4 "
          f"wd 0.05 warmup 30 of 20000 clip 1.0, encoder frozen; built in "
          f"{time.perf_counter() - t0:.1f} s")
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    images, targets = detection_batch(DET_B, cfg.max_objects, gen)
    n_boxes = int((targets.sum(-1) > 0).sum())

    def stats():
        return torch.cat([t.float().flatten() for k, t in
                          model.state_dict().items() if "running_" in k])

    def first_step(plain: bool):
        model.load_state_dict(init)
        task.set_plain(plain)
        state = task.init_state()
        reset()
        state, m = task.train_step(state, images, targets)
        gnorm = adamw.global_norm([p.grad for k, p in
                                   model.named_parameters() if mask[k]])
        torch.cuda.synchronize()
        return float(m["loss"]), float(gnorm), counts(), stats()

    # (a) the first step through the kernels, then the plain versions
    loss_k, gnorm_k, n_k, stats_k = first_step(False)
    loss_p, gnorm_p, n_p, stats_p = first_step(True)
    task.set_plain(False)
    stats_err = float((stats_k - stats_p).abs().max())
    stats_scale = max(1.0, float(stats_p.abs().max()))
    print(f"  (a) {n_boxes} boxes in the batch; first step: kernels loss "
          f"{loss_k:.6g} grad norm {gnorm_k:.6g} launches {n_k}; plain loss "
          f"{loss_p:.6g} grad norm {gnorm_p:.6g} launches {n_p}; BatchNorm "
          f"statistics max |kernels - plain| {stats_err:.3e} (scale "
          f"{stats_scale:.3g})")
    check(np.isfinite(loss_k) and np.isfinite(gnorm_k), "non-finite step")
    check(n_k == per_step, f"(a) launches {n_k} != {per_step}")
    check(all(v == 0 for v in n_p.values()), f"plain step launched {n_p}")
    check(abs(loss_k - loss_p) <= LOSS_TOL * abs(loss_p),
          f"(a) loss {loss_k:.6g} vs plain {loss_p:.6g}")
    check(abs(gnorm_k - gnorm_p) <= GNORM_TOL * gnorm_p,
          f"(a) grad norm {gnorm_k:.6g} vs plain {gnorm_p:.6g}")
    check(stats_err <= LOSS_TOL * stats_scale,
          f"(a) BatchNorm statistics off by {stats_err:.3e}")

    # the AdamW kernel on the masked leaves of that step against the
    # per-leaf formula
    masked_adamw_check("detection", task.tx.inner,
                       {k: p for k, p in model.named_parameters()
                        if mask[k]}, cfg.optimizer.warmup_steps, ktimes,
                       rows)
    torch.cuda.empty_cache()

    def steps(t, start, imgs, tgts, n, b, count):
        """n steps of task t on a fixed batch from the state dict `start`,
        after `count` untimed steps through the warmup (so the AdamW
        moments fit the update count), counters set to 0 just before the n
        and read just after; the losses, step times, launches, peak memory
        and the device busy time of one more step (profiler)."""
        t.model.load_state_dict(start)
        state = t.init_state()
        for _ in range(count):
            state, _ = t.train_step(state, imgs, tgts)
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset()
        losses, times, lrs = [], [], []
        for _ in range(n):
            t0 = time.perf_counter()
            state, m = t.train_step(state, imgs, tgts)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(m["loss"]))
            lrs.append(float(m["lr"]))
        launches = counts()
        peak = torch.cuda.max_memory_allocated()
        box = [state]

        def one_step():
            box[0], _ = t.train_step(box[0], imgs, tgts)

        busy = device_ms(one_step, "", 3, "detection step", alone=False)
        step_ms = float(np.median(times[1:]))
        print(f"    train losses {[round(x, 5) for x in losses]} at lr "
              f"{[float(f'{x:.4g}') for x in lrs]}; launches {launches} in "
              f"{n} steps; step {step_ms:.3f} ms median of steps 2-{n} "
              f"(host clock, synchronised), {b / step_ms * 1e3:.2f} "
              f"images/s, device busy {_ms(busy)} a step (profiler, 3 "
              f"steps), peak device memory {peak / 2 ** 30:.3f} GiB on "
              f"{card}")
        check(all(np.isfinite(losses)), "non-finite detection loss")
        check(min(lrs) > 0, f"lr {lrs} not past the warmup's start")
        want = {k: v * n for k, v in per_step.items()}
        check(launches == want, f"launches {launches} != {want}")
        return {"losses": losses, "lr": lrs, "step_ms": times,
                "step_ms_median": step_ms, "images_per_s": b / step_ms * 1e3,
                "device_busy_ms": busy, "max_memory_allocated_bytes": peak,
                "launches": launches}

    def changed(t, before):
        for k, v in t.model.state_dict().items():
            same = torch.equal(v, before[k])
            check(same == trunk(k),
                  f"{k} {'unchanged' if same else 'changed'}")

    print(f"  (a) {DET_STEPS} steps at B = {DET_B} from update "
          f"{cfg.optimizer.warmup_steps} (the peak lr)")
    result = {"card": card, "batch": DET_B, "parameters": n_params,
              "trainable": n_train, "trainable_leaves": len(trainable),
              "batch_norm_statistics": n_stats, "boxes": n_boxes,
              "loss_first_step": loss_k, "loss_plain_step": loss_p,
              "grad_norm": gnorm_k, "grad_norm_plain": gnorm_p,
              "batch_norm_stats_max_err": stats_err,
              "rsna_100": steps(task, init, images, targets, DET_STEPS,
                                DET_B, cfg.optimizer.warmup_steps)}
    result["launches_a_step"] = {
        k: v // DET_STEPS for k, v in result["rsna_100"]["launches"].items()}
    losses = result["rsna_100"]["losses"]
    check(losses[-1] < losses[0], f"(a) the loss did not fall: {losses}")
    changed(task, init)
    print("  (a) trunk bit-unchanged; det_head, the neck and the head "
          "changed")
    del task, model, images, targets, init
    gc.collect()
    torch.cuda.empty_cache()

    # (b) det_RSNA_10: expansion 8 at B = DET10_B
    cfg10 = det_cfg(8, 5, 3000)
    task10 = DetectionTask(cfg10, device="cuda")
    init10 = {k: v.detach().clone()
              for k, v in task10.model.state_dict().items()}
    mask10 = task10.freeze_mask()
    n10 = sum(p.numel() for p in task10.model.parameters())
    n10_train = sum(p.numel() for k, p in task10.model.named_parameters()
                    if mask10[k])
    print(f"  (b) det_RSNA_10 (expansion 8): {n10} parameters, {n10_train} "
          f"trainable in {sum(mask10.values())} leaves, {DET10_STEPS} steps "
          f"at B = {DET10_B}")
    imgs10, tgts10 = detection_batch(DET10_B, cfg10.max_objects, gen)
    result["rsna_10"] = steps(task10, init10, imgs10, tgts10, DET10_STEPS,
                              DET10_B, cfg10.optimizer.warmup_steps)
    result["rsna_10"].update(parameters=n10, trainable=n10_train)
    changed(task10, init10)
    del task10, init10, imgs10, tgts10
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the CLI from the pretrain CLI's checkpoint on a seeded RSNA corpus
    from ecamp_tpu_torch.data.datasets import RSNADetectionDataset
    from ecamp_tpu_torch.data.synthetic import write_detection_corpus

    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    data = write_detection_corpus(os.path.join(work, "rsna_det"), "RSNA",
                                  *DET_SPLITS, seed=SEED, img_size=DET_IMG)
    n_images = len(RSNADetectionDataset(data, data, "train"))
    per_epoch = n_images // DET_CLI_B
    n_val = len(RSNADetectionDataset(data, data, "val"))
    print(f"  (c) RSNA corpus {'/'.join(map(str, DET_SPLITS))} rows, PNGs at "
          f"{DET_IMG} px, written in {time.perf_counter() - t0:.1f} s; "
          f"{per_epoch} updates an epoch at B = {DET_CLI_B}, {n_val} "
          f"validation images in batches of {DET_EVAL_B}")
    check(per_epoch >= 1, "(c) the corpus fills no batch")
    out = os.path.join(work, "det_out")
    cmd = [sys.executable, "-m", "ecamp_tpu_torch.cli.finetune_det",
           "--task", "RSNA", "--dataset_path", data, "--pretrained",
           pretrained, "--batch_size", str(DET_CLI_B), "--eval_batch_size",
           str(DET_EVAL_B), "--lr", "5e-4", "--weight_decay", "0.05",
           "--warmup_steps", "2", "--num_steps", str(2 * per_epoch),
           "--patience", "1", "--start_eval", "1", "--output_dir", out,
           "--seed", str(SEED)]
    # (e)'s preempted run starts now and runs beside (c) and (d)
    first = start_preempted(cmd, out, per_epoch)
    t = time.perf_counter()
    r = subprocess.run(cmd, cwd=repo, capture_output=True, text=True,
                       timeout=CLI_TIMEOUT)
    check(r.returncode == 0, f"detection CLI exited {r.returncode}:\n"
          f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    cli_s = time.perf_counter() - t
    with open(os.path.join(out, "log.txt")) as f:
        recs = [json.loads(line) for line in f]
    printed = r.stdout
    for line in printed.splitlines():
        if line.startswith(("step ", "Epoch [", "TEST", pretrained,
                            "loaded ")):
            print(f"    {line}")
    n_eval = -(-n_val // DET_EVAL_B)
    want = {k: per_step[k] * (per_epoch + n_eval)
            for k in ("layer_norm", "attention")}
    want["adamw"] = per_epoch  # one an update; a validation runs none
    vals = [rec for rec in recs if "step" in rec]
    check(len(vals) >= 1 and [rec["step"] for rec in vals]
          == [per_epoch * (i + 1) for i in range(len(vals))],
          f"(c) validations at steps {[rec['step'] for rec in vals]}")
    for rec in vals:
        check(0.0 <= rec["mAP"] <= 1.0 and np.isfinite(rec["loss"]),
              f"(c) validation {rec}")
        check(rec["kernel_launches"] == want,
              f"(c) launches {rec['kernel_launches']} != {want} (steps "
              f"and a validation)")
    # the trunk from the pretraining checkpoint: patch embedding, cls token
    # and 12 tensors a block; pos_embed (a buffer in the port's ECAMP),
    # det_head, the neck and the head stay at init
    got = re.search(r": loaded (\d+) tensors, (\d+) left at init", printed)
    check(got is not None and (int(got[1]), int(got[2])) == (
        3 + 12 * depth, n_entries - 3 - 12 * depth),
        f"(c) pretrained load: {got and got[0]}")
    check("TEST mAP@[.40:.05:.75]:" in printed and "test_map" in recs[-1],
          "(c) no test line")
    best = os.path.join(out, "best", "checkpoint-best.pth")
    check(os.path.exists(best), "(c) no best checkpoint")
    print(f"  (c) CLI {cli_s:.1f} s: validations {vals}, test mAP "
          f"{recs[-1]['test_map']:.4f}")

    # (d) the serve engine on the best .pth against the task's eval step,
    # the same NMS on the same candidates, then one POST
    from ecamp_tpu_torch.ckpt import load_reference_pth, load_reference_state
    from ecamp_tpu_torch.serve import detector_engine
    from ecamp_tpu_torch.serve.http_server import PredictionService, serve

    engine = detector_engine(best, img_size=224, buckets=(8,),
                             device="cuda")
    etask = DetectionTask(cfg, device="cuda")
    load_reference_state(etask.model, load_reference_pth(best))
    ds = RSNADetectionDataset(data, data, "test")
    x = np.stack([ds[i]["image"] for i in range(5)])
    with torch.inference_mode():
        served = engine._run_padded(np.concatenate(
            [x, np.broadcast_to(x[-1:], (3,) + x.shape[1:])]), 5)
    want_c = etask.eval_step(None, torch.from_numpy(x).cuda()).cpu().numpy()
    # the boxes (pixels) against their own scale, the probabilities absolute
    box_err = float(np.abs(served[..., :4] - want_c[..., :4]).max())
    scale = float(np.abs(want_c[..., :4]).max())
    prob_err = float(np.abs(served[..., 4:] - want_c[..., 4:]).max())
    print(f"  (d) engine on the best .pth: {len(x)} test images, "
          f"{served.shape[1]} candidates each, max |served - eval_step| "
          f"{box_err:.3e} on the boxes (scale {scale:.3g}), {prob_err:.3e} "
          f"on objectness and class")
    check(served.shape == want_c.shape == (5, 3 * (49 + 196 + 784), 6)
          and box_err <= PROB_TOL * max(1.0, scale)
          and prob_err <= PROB_TOL,
          f"(d) served candidates off by {box_err:.3e} (boxes), "
          f"{prob_err:.3e} (probabilities)")
    boxes_e = engine.postprocess(served)
    boxes_t = etask.detections(served)
    check(all((a is None and b is None) or (a is not None and b is not None
                                            and np.array_equal(a, b))
              for a, b in zip(boxes_e, boxes_t)),
          "(d) the engine's NMS and the task's differ on one candidate set")
    full = engine(x)
    check(len(full) == 5, f"(d) engine answered {len(full)} images")
    with open(ds.img_paths[0], "rb") as f:
        body = {"image": base64.b64encode(f.read()).decode()}
    service = PredictionService(engine, img_size=224, task="detection")
    httpd = serve(service, port=0, background=True)
    try:
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        reply = _http(f"{base}/predict", body)
    finally:
        httpd.shutdown()
        httpd.server_close()
        service.close()
    pred = reply["predictions"][0]
    print(f"  (d) POST /predict with --task detection: {pred}")
    check(set(pred) == {"boxes"} and (pred["boxes"] is None or all(
        len(b) == 7 for b in pred["boxes"])), f"(d) reply {reply}")
    result.update(cli_seconds=cli_s, cli_log=recs,
                  served_box_max_err=box_err, served_prob_max_err=prob_err,
                  served_boxes=[None if b is None else len(b)
                                for b in boxes_e], http_reply=pred)
    del etask, engine
    gc.collect()
    torch.cuda.empty_cache()
    # (e) the same CLI preempted after its first validation and resumed
    result["preemption"] = preempt_drill("e", cmd, out, per_epoch, per_step,
                                         n_eval, "mAP", "test_map",
                                         "TEST mAP@[.40:.05:.75]:", first)
    result["phase_seconds"] = time.perf_counter() - t_phase
    print(f"  detection phase: {result['phase_seconds']:.1f} s")
    return result


def _dpf_cfg(kind: str):
    """(9f)'s configuration: SegViT SIIM or the ViT detector (expansion 4)
    at full width, bf16, AdamW at a constant lr (wd 0.05, clip 1.0), so
    that the first steps move the decoder or the neck: 5e-4 for SegViT,
    1e-4 for the detector (at 5e-4 its first sign-like Adam step takes the
    loss from 1.18 to 6.0, and the runs' bf16 roundings part further)."""
    from ecamp_tpu_torch.core import config as c

    opt = c.OptimizerConfig(name="adamw", lr=5e-4 if kind == "seg" else 1e-4,
                            weight_decay=0.05, betas=(0.9, 0.999),
                            schedule="constant", grad_clip=1.0)
    if kind == "seg":
        return c.SegmentationConfig(optimizer=opt, task="SIIM", seed=SEED)
    return c.DetectionConfig(optimizer=opt, seed=SEED)


def _dpf_run(kind: str, dev, batch: int, rank: int, world: int,
             stats_path: str = "") -> dict:
    """DPF_STEPS steps of (9f)'s `kind` task on `dev` on this rank's rows
    (batch / world of them) of the seeded global batch of `batch` rows
    (one process: rank 0 of 1): each step's loss, the first update's averaged
    gradient norm over the trained leaves, host ms a step, the peak
    device memory, the kernels' launches, the checksums of the parameters
    and of the BatchNorm buffers; the running statistics after the first
    and the last step written to `stats_path` if given."""
    import gc

    import torch

    from ecamp_tpu_torch.data.synthetic import detection_batch
    from ecamp_tpu_torch.kernels import flash_attention as fa
    from ecamp_tpu_torch.kernels import fused_adamw as adamw
    from ecamp_tpu_torch.kernels import layer_norm as ln
    from ecamp_tpu_torch.train.detection import DetectionTask
    from ecamp_tpu_torch.train.segmentation import SegmentationTask

    gc.collect()
    torch.cuda.empty_cache()
    cfg = _dpf_cfg(kind)
    task = (SegmentationTask if kind == "seg" else DetectionTask)(
        cfg, device=dev)
    state = task.init_state()
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    if kind == "seg":
        images, targets = _seg_batch(batch, 1, gen)
    else:
        images, targets = detection_batch(batch, cfg.max_objects, gen)
    rows = batch // world
    lo = rank * rows
    images, targets = images[lo:lo + rows], targets[lo:lo + rows]
    mask = task.freeze_mask()
    trained = [p for k, p in task.model.named_parameters() if mask[k]]
    counters = {"layer_norm": ln.launches, "attention": fa.launches,
                "adamw": adamw.launches}
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    for ctr in counters.values():
        ctr.reset()
    def running_stats():
        return {k: v.detach().float().cpu()
                for k, v in task.model.state_dict().items()
                if "running_" in k}

    losses, step_ms, gnorm, first = [], [], None, None
    for _ in range(DPF_STEPS):
        t = time.perf_counter()
        state, m = task.train_step(state, images, targets)
        torch.cuda.synchronize(dev)
        step_ms.append((time.perf_counter() - t) * 1e3)
        losses.append(float(m["loss"]))
        if gnorm is None:
            gnorm = float(sum(p.grad.double().square().sum()
                              for p in trained) ** 0.5)
            first = running_stats()
    stats = running_stats()
    if stats_path:
        torch.save({"first": first, "last": stats}, stats_path)
    out = {"rows": rows, "losses": losses, "grad_norm": gnorm,
           "step_ms": step_ms,
           "peak_bytes": torch.cuda.max_memory_allocated(dev),
           "launches": {k: ctr.value for k, ctr in counters.items()},
           "param_checksum": float(sum(p.detach().double().sum()
                                       for p in task.model.parameters())),
           "bn_checksum": float(sum(v.double().sum()
                                    for v in stats.values())),
           "trained_elements": sum(p.numel() for p in trained)}
    del task, state, images, targets
    return out


def dp_ft_worker(spec: dict) -> int:
    """One rank of (9f) (a)'s torchrun launch (`chip_smoke.py
    --dp-ft-worker SPEC`): `_dpf_run` of SegViT and of the ViT detector on
    this rank's share of the seeded global batch of DPF_SEG_B or
    DPF_DET_B rows; rank 0 writes the running statistics. Writes its results
    as JSON to spec["out"] with the rank's number; a failed check exits
    non-zero."""
    import torch

    from ecamp_tpu_torch.core import distributed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    check(distributed.initialize_distributed("cuda"),
          "no launcher environment")
    rank, world = distributed.rank(), distributed.world_size()
    dev = distributed.rank_device("cuda")
    out = {"rank": rank, "world": world,
           "backend": torch.distributed.get_backend(),
           "card": torch.cuda.get_device_name(dev)}
    for kind, batch in (("seg", DPF_SEG_B), ("det", DPF_DET_B)):
        out[kind] = _dpf_run(kind, dev, batch, rank, world,
                             f"{spec['out']}{kind}.pt" if rank == 0 else "")
    with open(f"{spec['out']}{rank}.json", "w") as f:
        json.dump(out, f)
    distributed.shutdown_distributed()
    return 0


def _dpf_cli(kind: str, work: str, pretrained: str, env: dict):
    """Start (9f) (b)'s torchrun launch of the `kind` fine-tune CLI on 2
    ranks for 1 epoch of DPF_CLI_B rows a rank on (8)'s or (9)'s corpus;
    returns (the process, its command, its output directory, the updates
    of the epoch)."""
    from ecamp_tpu_torch.data.datasets import (RSNADetectionDataset,
                                               SIIMSegmentationDataset)

    data = os.path.join(work, "siim" if kind == "seg" else "rsna_det")
    ds = (SIIMSegmentationDataset if kind == "seg" else
          RSNADetectionDataset)(data, data, "train")
    per_epoch = -(-len(ds) // 2) // DPF_CLI_B
    check(per_epoch >= 1, f"(9f b) the {kind} corpus fills no batch")
    out = os.path.join(work, f"dpf_{kind}")
    cmd = (_torchrun(2, _free_port())
           + ["-m", f"ecamp_tpu_torch.cli.finetune_{kind}",
              "--task", "SIIM" if kind == "seg" else "RSNA",
              "--dataset_path", data, "--batch_size", str(DPF_CLI_B),
              "--eval_batch_size", str(SEG_EVAL_B), "--lr", "5e-4",
              "--num_steps", str(per_epoch), "--patience", "1",
              "--num_workers", "2", "--output_dir", out, "--seed",
              str(SEED)]
           + (["--pretrained", pretrained] if pretrained else [])
           + (["--warmup_steps", "2", "--weight_decay", "0.05",
               "--start_eval", "1"] if kind == "det" else
              ["--warmup_steps", "50"]))
    return _start_group(cmd, env), cmd, out, per_epoch


def dp_finetune_phase(card: str, pretrained: str, work: str) -> dict:
    """(9f) Data-parallel fine-tunes (module docstring). Returns the
    `data_parallel_finetune` JSON line's content."""
    t_phase = time.perf_counter()
    env = {k: v for k, v in os.environ.items()
           if k not in ("ECAMP_PREEMPT_AT_STEP", "ECAMP_RSS_LIMIT_GB")}
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host
    # (b) starts first and runs beside (a)
    clis = {}
    try:
        for kind in ("seg", "det"):
            clis[kind] = _dpf_cli(kind, work, pretrained, env)
        return _dpf_checks(card, work, env, clis, t_phase)
    finally:
        for p, *_ in clis.values():  # a failed check leaves none running
            _stop(p)


def _dpf_checks(card: str, work: str, env: dict, clis: dict,
                t_phase: float) -> dict:
    """(9f) (a), then (b)'s CLIs, which `dp_finetune_phase` started."""
    import gc

    import numpy as np
    import torch

    t_cli = time.perf_counter()

    # (a): one process at the global batch, then the ranks
    depth = _dpf_cfg("seg").vit.depth
    per_step = {"layer_norm": 2 * depth, "attention": depth, "adamw": 1}
    ref = {}
    for kind, batch in (("seg", DPF_SEG_B), ("det", DPF_DET_B)):
        ref[kind] = _dpf_run(kind, torch.device("cuda"), batch, 0, 1,
                             os.path.join(work, f"dpf_ref_{kind}.pt"))
        r = ref[kind]
        print(f"data-parallel fine-tune on {card}: {kind} one process at B "
              f"= {batch}: losses {[round(x, 5) for x in r['losses']]}, "
              f"grad norm {r['grad_norm']:.6g}, step ms "
              f"{[round(t, 1) for t in r['step_ms']]}, peak "
              f"{r['peak_bytes']} bytes")
    gc.collect()
    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    plan = [2] if cards >= 2 else [1, 2]
    runs = {}
    for n in plan:
        backend = "nccl" if n <= cards else "gloo"
        tag = f"{backend}{n}"
        spec = {"out": os.path.join(work, f"dpf_{tag}_rank")}
        t = time.perf_counter()
        _run_group(_torchrun(n, _free_port())
                   + [os.path.abspath(__file__), "--dp-ft-worker",
                      json.dumps(spec)], env, DP_TIMEOUT,
                   f"(9f a) torchrun {n} x {backend}")
        wall = time.perf_counter() - t
        res = []
        for r in range(n):
            with open(f"{spec['out']}{r}.json") as f:
                res.append(json.load(f))
        runs[tag] = {"backend": backend, "ranks": n, "launch_s": wall}
        for kind, batch in (("seg", DPF_SEG_B), ("det", DPF_DET_B)):
            rows = batch // n
            want = ref[kind]
            stats = torch.load(f"{spec['out']}{kind}.pt", weights_only=True)
            ref_stats = torch.load(os.path.join(work, f"dpf_ref_{kind}.pt"),
                                   weights_only=True)
            # each running statistic's distance over its own scale
            bn_err = {when: max(
                float((v - ref_stats[when][k]).abs().max())
                / max(1.0, float(ref_stats[when][k].abs().max()))
                for k, v in stats[when].items()) for when in stats}
            r0 = res[0][kind]
            runs[tag][kind] = {
                "rows_a_rank": rows, "losses": r0["losses"],
                "grad_norm": r0["grad_norm"], "bn_stats_rel_err": bn_err,
                "step_ms": [r[kind]["step_ms"] for r in res],
                "peak_bytes": [r[kind]["peak_bytes"] for r in res],
                "launches": [r[kind]["launches"] for r in res],
                "param_checksum": r0["param_checksum"],
                "bn_checksum": r0["bn_checksum"],
                "trained_elements": r0["trained_elements"]}
            scaling = ("" if backend == "nccl" and n > 1 else
                       "; no scaling figure: " + ("one rank" if n == 1
                                                  else "the ranks share "
                                                  "one card"))
            losses = [[round(x, 5) for x in r[kind]["losses"]] for r in res]
            sums = [(r[kind]["param_checksum"], r[kind]["bn_checksum"])
                    for r in res]
            print(f"  {n} rank(s), {backend}, {kind} at {rows} rows a rank: "
                  f"losses {losses}, grad norm {r0['grad_norm']:.6g}, "
                  f"BatchNorm statistics {bn_err['first']:.3e} / "
                  f"{bn_err['last']:.3e} of their scale from one process's "
                  f"after step 1 / {DPF_STEPS}; checksums (parameters, "
                  f"BatchNorm) {sums}; host "
                  f"ms a step {runs[tag][kind]['step_ms']}{scaling}; peak "
                  f"bytes {runs[tag][kind]['peak_bytes']}; launches "
                  f"{r0['launches']}")
            for r in res:
                who = f"(9f a) {tag} rank {r['rank']} {kind}"
                check(r["backend"] == backend,
                      f"{who}: backend {r['backend']}, expected {backend}")
                got = r[kind]
                for i, (a, b) in enumerate(zip(got["losses"],
                                               want["losses"])):
                    check(np.isfinite(a) and abs(a - b) <= LOSS_TOL * abs(b),
                          f"{who} step {i}: loss {a:.6g} against {b:.6g}")
                g, gr = got["grad_norm"], want["grad_norm"]
                check(abs(g - gr) <= GNORM_TOL * gr,
                      f"{who}: grad norm {g:.6g} against {gr:.6g}")
                steps = {k: v * DPF_STEPS for k, v in per_step.items()}
                check(got["launches"] == steps,
                      f"{who}: launches {got['launches']} != {steps}")
            for key in ("param_checksum", "bn_checksum"):
                check(len({r[kind][key] for r in res}) == 1,
                      f"(9f a) {tag} {kind}: {key}s "
                      f"{[r[kind][key] for r in res]} differ")
            # after the first step the statistics are those of the global
            # batch through the same weights; later steps add the updates'
            # spread (printed)
            check(bn_err["first"] <= DPF_BN_TOL,
                  f"(9f a) {tag} {kind}: BatchNorm statistics "
                  f"{bn_err['first']:.3e} of their scale from one "
                  f"process's after the first step")
        print(f"  {tag}: launch {wall:.1f} s (beside (b)'s CLIs)")

    # (b): the CLIs' logs, then one process scores each best .pth
    from ecamp_tpu_torch.cli import finetune_det, finetune_seg

    cli = {}
    for kind, (p, cmd, out, per_epoch) in clis.items():
        printed, _ = _wait_group(p, f"(9f b) torchrun cli.finetune_{kind}",
                                 DP_TIMEOUT - (time.perf_counter() - t_cli))
        cli_s = time.perf_counter() - t_cli
        with open(os.path.join(out, "log.txt")) as f:
            recs = [json.loads(line) for line in f]
        key, test_key = (("dice", "test_dice") if kind == "seg" else
                         ("mAP", "test_map"))
        vals = [rec for rec in recs if "step" in rec]
        check(len(recs) == 2 and [rec["step"] for rec in vals] == [per_epoch]
              and test_key in recs[-1],
              f"(9f b) {kind} log {recs}: rank 0 alone writes one "
              f"validation and one test line")
        best = os.path.join(out, "best", "checkpoint-best.pth")
        check(os.path.exists(best), f"(9f b) {kind}: no best .pth")
        check(printed.count(f"step {per_epoch}: val") == 1,
              f"(9f b) {kind}: rank 0 alone prints")
        one_out = os.path.join(work, f"dpf_{kind}_one")
        os.makedirs(os.path.join(one_out, "best"))
        os.link(best, os.path.join(one_out, "best", "checkpoint-best.pth"))
        argv = cmd[cmd.index("--task"):]
        argv[argv.index("--output_dir") + 1] = one_out
        if "--pretrained" in argv:
            i = argv.index("--pretrained")
            del argv[i:i + 2]
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            one = (finetune_seg if kind == "seg" else finetune_det).main(
                argv + ["--stage", "test"])
        one_s = time.perf_counter() - t
        two = recs[-1][test_key]
        diff = abs(two - one)
        print(f"  (b) torchrun --nproc_per_node=2 cli.finetune_{kind}: "
              f"{cli_s:.1f} s, validation {key} {vals[0][key]:.6f}, test "
              f"{key} on 2 ranks (ShardedEval) {two:.6f}, one process on "
              f"the same .pth {one:.6f} ({one_s:.1f} s): |diff| {diff:.3e}")
        check(diff <= DPF_TEST_TOL, f"(9f b) {kind}: the 2-rank test "
              f"{key} {two:.6f} against one process's {one:.6f}")
        cli[kind] = {"seconds": cli_s, "log": recs, "updates": per_epoch,
                     "test_two_ranks": two, "test_one_process": one,
                     "test_abs_diff": diff, "one_process_s": one_s}
        shutil.rmtree(one_out, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    print(f"  (9f) phase {seconds:.1f} s")
    return {"reference": ref, "runs": runs, "cli": cli,
            "per_step": per_step, "seconds": seconds}


def write_torchvision_resnet50(work: str) -> str:
    """A seeded torchvision-layout ResNet-50 `.pth` (the port's
    `ResNet50Backbone` state dict, with the `fc.*` a torchvision file
    carries), the baselines' `--pretrained`; returns its path."""
    import torch

    from ecamp_tpu_torch.nn.resnet import ResNet50Backbone

    sd = ResNet50Backbone(
        generator=torch.Generator().manual_seed(SEED + 11)).state_dict()
    sd["fc.weight"] = torch.zeros(1000, 2048)
    sd["fc.bias"] = torch.zeros(1000)
    path = os.path.join(work, "resnet50_torchvision.pth")
    torch.save(sd, path)
    return path


def resnet_phase(card: str, kind: str, work: str, pretrained: str,
                 ktimes: dict, rows: list) -> dict:
    """A ResNet-50 baseline at full width: kind "seg", the UNet (module
    docstring, 10), or "det", the detector (11). `pretrained` is the
    torchvision-layout `.pth` the CLI starts from; (8) and (9) wrote the
    corpora under `work`. The AdamW check's times join `ktimes` and
    `rows`."""
    import gc

    import numpy as np
    import torch

    from ecamp_tpu_torch.core import config as c
    from ecamp_tpu_torch.data.synthetic import detection_batch
    from ecamp_tpu_torch.kernels import flash_attention as fa
    from ecamp_tpu_torch.kernels import fused_adamw as adamw
    from ecamp_tpu_torch.kernels import layer_norm as ln
    from ecamp_tpu_torch.train.detection import DetectionTask
    from ecamp_tpu_torch.train.segmentation import SegmentationTask

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    seg = kind == "seg"
    # the UNet's warmup cut to RESNET_WARMUP; the detector's is its
    # recipe's 30 (at once at the peak lr its loss jumped on the CPU)
    warmup = RESNET_WARMUP if seg else 30
    opt = c.OptimizerConfig(
        name="adamw", lr=5e-4, weight_decay=0.05, betas=(0.9, 0.999),
        schedule="warmup_cosine_step", warmup_steps=warmup,
        total_steps=3000 if seg else 20000, grad_clip=1.0)
    if seg:
        cfg = c.SegmentationConfig(backbone="resnet50", optimizer=opt,
                                   task="SIIM", seed=SEED)
        task = SegmentationTask(cfg, device="cuda")
        b_max, name = RSEG_B, "resnet_seg"
        gen = torch.Generator(device="cuda").manual_seed(SEED + 12)

        def make(b):
            return _seg_batch(b, 1, gen)
    else:
        cfg = c.DetectionConfig(backbone="resnet50", optimizer=opt,
                                seed=SEED)
        task = DetectionTask(cfg, device="cuda")
        b_max, name = RDET_B, "resnet_det"
        gen = torch.Generator(device="cuda").manual_seed(SEED + 13)

        def make(b):
            return detection_batch(b, cfg.max_objects, gen)
    model = task.model
    mask = task.freeze_mask()
    trainable = [k for k, _ in model.named_parameters()
                 if mask is None or mask[k]]
    per_step = {"layer_norm": 0, "attention": 0, "adamw": 1}
    counters = {"layer_norm": ln.launches, "attention": fa.launches,
                "adamw": adamw.launches}

    def counts():
        return {k: ctr.value for k, ctr in counters.items()}

    def reset():
        for ctr in counters.values():
            ctr.reset()

    def frozen(k):  # the detector's backbone weights (not its statistics)
        return (not seg and k.startswith("backbone.")
                and "running_" not in k
                and not k.endswith("num_batches_tracked"))

    n_params = sum(p.numel() for p in model.parameters())
    n_train = sum(p.numel() for k, p in model.named_parameters()
                  if k in trainable)
    n_stats = sum(t.numel() for k, t in model.state_dict().items()
                  if "running_" in k)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}

    # the batch: the recipe's, halved until a step fits. A probe step's
    # peak memory (over the model and the optimizer) sets the first try
    def one_step(b):
        model.load_state_dict(init)
        state = task.init_state()
        imgs, tgts = make(b)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        task.train_step(state, imgs, tgts)
        torch.cuda.synchronize()
        return base, torch.cuda.max_memory_allocated()

    base, probe_peak = one_step(RESNET_PROBE_B)
    per_image = (probe_peak - base) / RESNET_PROBE_B
    total = torch.cuda.get_device_properties(0).total_memory
    b = b_max
    while b > RESNET_PROBE_B and base + per_image * b > 0.85 * total:
        b //= 2
    tried = []
    while True:
        try:
            one_step(b)
            break
        except torch.cuda.OutOfMemoryError:
            tried.append(b)
            model.zero_grad(set_to_none=True)
            gc.collect()
            torch.cuda.empty_cache()
            check(b > RESNET_PROBE_B, f"{name}: B = {b} does not fit")
            b //= 2
    desc = ("ResNet-50 UNet, decoder 256/128/64/32/16" if seg
            else "ResNet-50 (frozen) + YOLOv3 head (1 class)")
    print(f"{name} on {card}: {desc}, 224 px, bf16, {n_params} parameters, "
          f"{n_train} trainable in {len(trainable)} leaves, {n_stats} "
          f"BatchNorm statistics; a B = {RESNET_PROBE_B} step peaks at "
          f"{probe_peak / 2 ** 30:.3f} GiB "
          f"({per_image / 2 ** 20:.1f} MiB an image over "
          f"{base / 2 ** 30:.3f}); B = {b} (recipe {b_max}"
          f"{', refused by the allocator: ' + str(tried) if tried else ''})")
    images, targets = make(b)
    gc.collect()
    torch.cuda.empty_cache()

    def stats():
        return torch.cat([t.float().flatten() for k, t in
                          model.state_dict().items() if "running_" in k])

    def first_step(plain: bool):
        model.load_state_dict(init)
        task.set_plain(plain)
        state = task.init_state()
        reset()
        state, m = task.train_step(state, images, targets)
        gnorm = adamw.global_norm([p.grad for k, p in
                                   model.named_parameters()
                                   if k in trainable])
        torch.cuda.synchronize()
        return float(m["loss"]), float(gnorm), counts(), stats()

    # (a) the first step through the kernels, then the plain versions
    loss_k, gnorm_k, n_k, stats_k = first_step(False)
    loss_p, gnorm_p, n_p, stats_p = first_step(True)
    task.set_plain(False)
    stats_err = float((stats_k - stats_p).abs().max())
    stats_scale = max(1.0, float(stats_p.abs().max()))
    print(f"  (a) first step: kernels loss {loss_k:.6g} grad norm "
          f"{gnorm_k:.6g} launches {n_k}; plain loss {loss_p:.6g} grad norm "
          f"{gnorm_p:.6g} launches {n_p}; BatchNorm statistics max |kernels "
          f"- plain| {stats_err:.3e} (scale {stats_scale:.3g})")
    check(np.isfinite(loss_k) and np.isfinite(gnorm_k), "non-finite step")
    check(n_k == per_step, f"(a) launches {n_k} != {per_step}")
    check(all(v == 0 for v in n_p.values()), f"plain step launched {n_p}")
    check(abs(loss_k - loss_p) <= LOSS_TOL * abs(loss_p),
          f"(a) loss {loss_k:.6g} vs plain {loss_p:.6g}")
    check(abs(gnorm_k - gnorm_p) <= GNORM_TOL * gnorm_p,
          f"(a) grad norm {gnorm_k:.6g} vs plain {gnorm_p:.6g}")
    check(stats_err <= LOSS_TOL * stats_scale,
          f"(a) BatchNorm statistics off by {stats_err:.3e}")
    masked_adamw_check(name, task.tx if mask is None else task.tx.inner,
                       {k: p for k, p in model.named_parameters()
                        if k in trainable}, warmup, ktimes, rows,
                       masked=mask is not None)
    torch.cuda.empty_cache()

    # the timed steps follow `warmup` untimed ones, from the peak lr
    model.load_state_dict(init)
    state = task.init_state()
    for _ in range(warmup):
        state, _ = task.train_step(state, images, targets)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset()
    losses, times = [], []
    for _ in range(RESNET_STEPS):
        t0 = time.perf_counter()
        state, m = task.train_step(state, images, targets)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    box = [state]

    def step():
        box[0], _ = task.train_step(box[0], images, targets)

    busy = device_ms(step, "", 3, f"{name} step", alone=False)
    step_ms = float(np.median(times[1:]))
    print(f"  (a) train losses {[round(x, 5) for x in losses]}; launches "
          f"{launches} in {RESNET_STEPS} steps; step {step_ms:.3f} ms median "
          f"of steps 2-{RESNET_STEPS} (host clock, synchronised), "
          f"{b / step_ms * 1e3:.2f} images/s, device busy {_ms(busy)} a step "
          f"(profiler, 3 steps), peak device memory {peak / 2 ** 30:.3f} GiB "
          f"on {card}")
    check(all(np.isfinite(losses)), f"non-finite {name} loss")
    check(float(m["lr"]) > 0, f"lr {float(m['lr'])} not past the warmup")
    want = {k: v * RESNET_STEPS for k, v in per_step.items()}
    check(launches == want, f"launches {launches} != {want}")
    check(losses[-1] < losses[0], f"(a) the loss did not fall: {losses}")
    for k, v in model.state_dict().items():
        same = torch.equal(v, init[k])
        check(same == frozen(k), f"{k} {'unchanged' if same else 'changed'}")
    print("  (a) " + ("every parameter and statistic changed" if seg else
                      "the backbone's weights bit-unchanged, its BatchNorm "
                      "statistics and the head changed"))
    result = {"card": card, "batch": b, "batch_recipe": b_max,
              "batches_refused": tried, "parameters": n_params,
              "trainable": n_train, "trainable_leaves": len(trainable),
              "batch_norm_statistics": n_stats,
              "probe_peak_bytes": probe_peak, "loss_first_step": loss_k,
              "loss_plain_step": loss_p, "grad_norm": gnorm_k,
              "grad_norm_plain": gnorm_p,
              "batch_norm_stats_max_err": stats_err, "losses": losses,
              "step_ms": times, "step_ms_median": step_ms,
              "images_per_s": b / step_ms * 1e3, "device_busy_ms": busy,
              "max_memory_allocated_bytes": peak, "launches": launches,
              "launches_a_step": {k: v // RESNET_STEPS
                                  for k, v in launches.items()}}
    del task, model, images, targets, init, box, state
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the CLI on the earlier phase's corpus, from the torchvision .pth
    from ecamp_tpu_torch.data.datasets import (RSNADetectionDataset,
                                               SIIMSegmentationDataset)

    repo = os.path.dirname(os.path.abspath(__file__))
    data = os.path.join(work, "siim" if seg else "rsna_det")
    ds_cls = SIIMSegmentationDataset if seg else RSNADetectionDataset
    cli_b, eval_b = (SEG_CLI_B, SEG_EVAL_B) if seg else (DET_CLI_B,
                                                         DET_EVAL_B)
    per_epoch = len(ds_cls(data, data, "train")) // cli_b
    check(per_epoch >= 1, "(b) the corpus fills no batch")
    out = os.path.join(work, f"{name}_out")
    cmd = [sys.executable, "-m", "ecamp_tpu_torch.cli."
           + ("finetune_seg" if seg else "finetune_det"),
           "--task", "SIIM" if seg else "RSNA", "--model", "resnet50",
           "--dataset_path", data, "--pretrained", pretrained,
           "--batch_size", str(cli_b), "--eval_batch_size", str(eval_b),
           "--lr", "5e-4", "--weight_decay", "0.05", "--warmup_steps",
           str(RESNET_WARMUP), "--num_steps", str(per_epoch),
           "--patience", "1", "--output_dir", out, "--seed", str(SEED)]
    if not seg:
        cmd += ["--start_eval", "1"]
    t = time.perf_counter()
    r = subprocess.run(cmd, cwd=repo, capture_output=True, text=True,
                       timeout=CLI_TIMEOUT)
    check(r.returncode == 0, f"{name} CLI exited {r.returncode}:\n"
          f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    cli_s = time.perf_counter() - t
    with open(os.path.join(out, "log.txt")) as f:
        recs = [json.loads(line) for line in f]
    printed = r.stdout
    for line in printed.splitlines():
        if line.startswith(("step ", "Epoch [", "TEST", pretrained,
                            "loaded ")):
            print(f"    {line}")
    vals = [rec for rec in recs if "step" in rec]
    check(len(vals) >= 1 and [rec["step"] for rec in vals]
          == [per_epoch * (i + 1) for i in range(len(vals))],
          f"(b) validations at steps {[rec['step'] for rec in vals]}")
    want = {"layer_norm": 0, "attention": 0, "adamw": per_epoch}
    metric = "dice" if seg else "mAP"
    for rec in vals:
        check(0.0 <= rec[metric] <= 1.0 and np.isfinite(rec["loss"]),
              f"(b) validation {rec}")
        check(rec["kernel_launches"] == want,
              f"(b) launches {rec['kernel_launches']} != {want}")
    got = re.search(r": loaded (\d+) tensors, (\d+) left at init", printed)
    check(got is not None and int(got[1]) == RESNET50_TENSORS,
          f"(b) pretrained load: {got and got[0]}")
    test_line = "TEST dice:" if seg else "TEST mAP@[.40:.05:.75]:"
    check(test_line in printed and f"test_{metric.lower()}" in recs[-1],
          "(b) no test line")
    check(os.path.exists(os.path.join(out, "best", "checkpoint-best.pth")),
          "(b) no best checkpoint")
    print(f"  (b) CLI {cli_s:.1f} s: {got[0].strip()}; validations {vals}, "
          f"test {metric} {recs[-1][f'test_{metric.lower()}']:.4f}")
    result.update(cli_seconds=cli_s, cli_log=recs,
                  phase_seconds=time.perf_counter() - t_phase)
    print(f"  {name} phase: {result['phase_seconds']:.1f} s")
    return result


def visualize_phase(card: str, pretrained: str, work: str,
                    rows: list) -> dict:
    """The visualizer at full width (module docstring, 12); the LayerNorm
    and attention rows at its shapes join `rows`."""
    import numpy as np
    import torch
    from PIL import Image

    from ecamp_tpu_torch.cli import visualize
    from ecamp_tpu_torch.core import config as c
    from ecamp_tpu_torch.kernels import flash_attention as fa
    from ecamp_tpu_torch.kernels import layer_norm as ln
    from ecamp_tpu_torch.nn.layers import set_plain

    t_phase = time.perf_counter()
    vit, bert = c.ViTConfig(), c.BertConfig()
    counters = {"layer_norm": ln.launches, "attention": fa.launches}

    def counts():
        return {k: ctr.value for k, ctr in counters.items()}

    # every LayerNorm (ViT: 2 a block and the last; BERT: the embeddings',
    # 3 in the fusion layer, 2 a layer, the MLM transform's) and every
    # self-attention; the cross attention is plain
    want = {"layer_norm": 2 * vit.depth + 1 + 1 + 3
            + 2 * bert.num_hidden_layers + 1,
            "attention": vit.depth + 1 + bert.num_hidden_layers}
    repo = os.path.dirname(os.path.abspath(__file__))
    tok = os.path.join(repo, "ecamp_tpu", "assets", "mimic_wordpiece.json")
    rng = np.random.default_rng(SEED + 14)
    yy, xx = np.mgrid[:512, :512]
    gray = 90 + 60 * np.exp(-((yy - 300) ** 2 + (xx - 180) ** 2) / 5000.0) \
        + 20 * rng.standard_normal((512, 512))
    image = os.path.join(work, "viz_input.png")
    Image.fromarray(np.clip(gray, 0, 255).astype(np.uint8), "L").save(image)
    text = "small left pleural effusion with basilar atelectasis"
    out_png = os.path.join(work, "viz_heatmap.png")
    orig_png = os.path.join(work, "viz_original.png")
    for ctr in counters.values():
        ctr.reset()
    t = time.perf_counter()
    amap = visualize.main(["--image", image, "--text", text, "--checkpoint",
                           pretrained, "--tokenizer", tok, "--output",
                           out_png, "--save_original", orig_png])
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t
    launches = counts()
    heat = np.asarray(Image.open(out_png))
    print(f"visualize on {card}: cli.visualize.main {main_s:.2f} s "
          f"(the model built and loaded, one fp32 forward at 224 px, L = "
          f"{bert.max_position_embeddings}), launches {launches}, heatmap "
          f"{heat.shape} in {os.path.basename(out_png)}")
    check(launches == want, f"visualize launches {launches} != {want}")
    check(heat.shape == (224, 224, 3) and np.asarray(
        Image.open(orig_png)).shape == (224, 224), "visualize PNGs")
    check(amap.shape == (224, 224) and np.isfinite(amap).all()
          and 0.0 <= amap.min() < amap.max() <= 1.0, "visualize map")

    # the same inputs through the plain version of every kernel
    model = visualize.load_model(pretrained, "cuda")
    _, batch = visualize.prepare(image, text, tok,
                                 bert.max_position_embeddings)
    set_plain(model, True)
    for ctr in counters.values():
        ctr.reset()
    amap_p = visualize.cross_attention_map(model, batch, 4)
    n_p = counts()
    err = float(np.abs(amap - amap_p).max())
    print(f"  heatmap with kernels against the plain versions: max |diff| "
          f"{err:.3e} (tolerance {VIZ_TOL}); plain launches {n_p}")
    check(all(v == 0 for v in n_p.values()), f"plain run launched {n_p}")
    check(err <= VIZ_TOL, f"visualize heatmap off by {err:.3e}")
    forward = {}
    for plain in (False, True):
        set_plain(model, plain)
        forward["plain_ms" if plain else "ms"] = median_ms(
            lambda: visualize.cross_attention_map(model, batch, 4), 5, 2)
    print(f"  one forward + heatmap: kernels {forward['ms']:.3f} ms, plain "
          f"{forward['plain_ms']:.3f} ms (events, host-synchronised by the "
          f"map's copy) on {card}")
    del model
    torch.cuda.empty_cache()

    # LayerNorm and attention forwards at the visualizer's fp32 shapes
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    dtype = torch.float32
    n_text = 12
    for n, d, eps, tag in ((vit.num_patches + 1, vit.embed_dim, 1e-6, "vit"),
                           (bert.max_position_embeddings, bert.hidden_size,
                            1e-12, "bert")):
        x = torch.randn(n, d, device=dev, generator=gen) * 2 + 0.5
        w = 1 + 0.1 * torch.randn(d, device=dev, generator=gen)
        bias = 0.1 * torch.randn(d, device=dev, generator=gen)
        _layer_norm_fwd(rows, f"visualize layer_norm {tag} fwd ({n}, {d}) "
                        f"{dtype}", x, w, bias, eps, dtype)
    hd = vit.embed_dim // vit.num_heads
    for n, tag, key_pad in ((vit.num_patches + 1, "vit", False),
                            (bert.max_position_embeddings, "bert", True)):
        q, k, v = (torch.randn(1, vit.num_heads, n, hd, device=dev,
                               generator=gen) for _ in range(3))
        kb = None
        if key_pad:
            kb = torch.zeros(1, 1, 1, n, device=dev)
            kb[..., n_text:] = torch.finfo(torch.float32).min
        _attention_fwd(rows, f"visualize attention {tag} fwd (1, "
                       f"{vit.num_heads}, {n}, {hd}) {dtype}"
                       + (" key-pad" if key_pad else ""), q, k, v, kb,
                       dtype)
    torch.cuda.synchronize()
    result = {"card": card, "main_seconds": main_s, "launches": launches,
              "heatmap_max_err": err, "tolerance": VIZ_TOL,
              "forward": forward,
              "phase_seconds": time.perf_counter() - t_phase}
    print(f"  visualize phase: {result['phase_seconds']:.1f} s")
    return result


def int8_ptxas_lines() -> list:
    """What ptxas said of int8_linear.cu's kernels in the library's build
    log: registers, spills, and any wgmma it serialised (C75xx)."""
    from ecamp_tpu_torch.kernels import _build

    lines, inside = [], False
    log = _build.build().with_suffix(".log").read_text().splitlines()
    for line in log:
        if "nvcc" in line and " -c " in line:
            inside = "int8_linear.cu" in line
        elif inside or ("C75" in line and "int8_linear" in line):
            if any(w in line for w in ("registers", "spill", "Compiling",
                                       "C75")):
                lines.append(line.strip())
    return lines


def int8_kernel_phase(card: str, rows: list) -> dict:
    """The int8-weight linear kernel at the served shapes (module
    docstring, 13a); every row joins `rows`, the I8_MAIN one is returned."""
    import torch
    import torch.nn.functional as F

    from ecamp_tpu_torch.kernels import int8_linear as i8
    from ecamp_tpu_torch.serve.quantize import quantize_weight_int8

    print(f"int8-weight linear on {card}: kernel against F.linear with the "
          f"dequantised weight (plain, dequantising every call) and the "
          f"weight dequantised once (library)")
    for line in int8_ptxas_lines():
        print("  ptxas:", line)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    shapes = [(197 * b, n, k) for b in I8_IMAGES
              for n, k in I8_PROJECTIONS] + [I8_RAGGED]
    main = None
    for m, n, k in shapes:
        x = torch.randn(m, k, device=dev, generator=gen).to(torch.bfloat16)
        q, s = (t.to(dev) for t in quantize_weight_int8(
            0.02 * torch.randn(n, k, device=dev, generator=gen)))
        b = (0.1 * torch.randn(n, device=dev, generator=gen)).to(
            torch.bfloat16)
        label = f"int8_linear ({m}, {n}, {k}) bf16"
        r = compare(label, i8.int8_linear, i8._int8_linear_reference,
                    torch.bfloat16, library_fn=F.linear, match="int8_linear",
                    work=int8_linear_work(m, n, k), inputs=(x, q, s, b),
                    library_inputs=(x, i8.dequantize_int8(q, s, x.dtype), b))
        plan = i8._plan(m, n, k, sms)
        r["plan"] = dict(plan._asdict(), splits=plan.splits)
        print(f"    plan: {plan.bt} tokens by 128 channels a tile, "
              f"{plan.tiles} tiles ({plan.whole} whole), {plan.units} units "
              f"on {plan.grid} blocks, K in up to {plan.splits} split(s)")
        rows.append({"kernel": "int8_linear", "shape": label, **r})
        if (m, n, k) == I8_MAIN:
            main = dict(r, shape=label)
    torch.cuda.synchronize()
    return main


def _bucket_p50(engine, buckets, rng) -> dict:
    """Host-clock p50 of an engine call at each bucket (TIMING_REPS calls,
    each ending in the host copy)."""
    import numpy as np

    p50 = {}
    for b in buckets:
        xs = rng.normal(size=(b, IMG, IMG, 3)).astype(np.float32)
        engine(xs)
        lat = []
        for _ in range(TIMING_REPS):
            t = time.perf_counter()
            engine(xs)
            lat.append((time.perf_counter() - t) * 1e3)
        p50[b] = float(np.median(lat))
    return p50


def _engine_memory(engine, bucket, rng) -> dict:
    """The engine's weights' device bytes (`engine.weight_bytes`) and the
    peak allocated during a call of `bucket` images, in GiB."""
    import numpy as np
    import torch

    xs = rng.normal(size=(bucket, IMG, IMG, 3)).astype(np.float32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine(xs)
    torch.cuda.synchronize()
    return {"weights_gib": engine.weight_bytes / 2 ** 30,
            f"peak_gib_b{bucket}": torch.cuda.max_memory_allocated() / 2 ** 30}


def _built(factory, **kw):
    """factory(**kw) with `weight_bytes`, the device memory it took."""
    import torch

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    engine = factory(**kw)
    torch.cuda.synchronize()
    engine.weight_bytes = torch.cuda.memory_allocated() - before
    return engine


def serving_rest_phase(card: str, pretrained: str, best_cls: str,
                       work: str) -> dict:
    """int8 classifier and embedding serving and the export (module
    docstring, 13b-d)."""
    import gc

    import numpy as np
    import torch

    from ecamp_tpu_torch.cli import export
    from ecamp_tpu_torch.kernels import flash_attention as fa
    from ecamp_tpu_torch.kernels import int8_linear as i8
    from ecamp_tpu_torch.kernels import layer_norm as ln
    from ecamp_tpu_torch.nn import set_plain
    from ecamp_tpu_torch.serve import classifier_engine, embedding_engine
    from ecamp_tpu_torch.serve.http_server import PredictionService, serve
    from ecamp_tpu_torch.serve.quantize import quantized_modules

    t_phase = time.perf_counter()
    counters = {"layer_norm": ln.launches, "attention": fa.launches,
                "int8_linear": i8.launches}

    def reset():
        for ctr in counters.values():
            ctr.reset()

    def counts():
        return {k: ctr.value for k, ctr in counters.items()}

    def post(engine, task, n):
        """One POST of n seeded PNGs through the HTTP server; the decoded
        inputs, the predictions and the launches of the request."""
        service = PredictionService(engine, img_size=IMG, task=task)
        httpd = serve(service, port=0, background=True)
        imgs = [_png_b64(rng, 256, 288) for _ in range(n)]
        try:
            base = f"http://127.0.0.1:{httpd.server_address[1]}"
            reset()
            reply = _http(f"{base}/predict", {"image": imgs[0]} if n == 1
                          else {"images": imgs})
            launched = counts()
        finally:
            httpd.shutdown()
            httpd.server_close()
            service.close()
        return service.decode(imgs), reply["predictions"], launched

    def per_forward(model, int8):
        """A forward's launches: 2 LayerNorms a block and the last, an
        attention a block, `int8` int8-weight linears."""
        depth = len(model.blocks)
        return {"layer_norm": 2 * depth + 1, "attention": depth,
                "int8_linear": int8}

    def projections(depth):  # a ViT's weights quantized, in module order
        return ["patch_embed.proj"] + [
            f"blocks.{i}.{m}" for i in range(depth)
            for m in ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2")]

    rng = np.random.default_rng(SEED + 17)
    xs = rng.normal(size=(5, IMG, IMG, 3)).astype(np.float32)

    # (b) the classifier, bf16 then int8, on the same seeded weights
    def cls_engine(quantize):
        engine = _built(classifier_engine, num_classes=N_CLASSES,
                        img_size=IMG, buckets=BUCKETS, device="cuda",
                        seed=SEED, quantize=quantize)
        with torch.no_grad():  # the serving slice's head (slice_phase)
            g = torch.Generator().manual_seed(SEED + 1)
            engine.model.head.weight.copy_(0.05 * torch.randn(
                engine.model.head.weight.shape, generator=g))
        engine.warmup(np.zeros((1, IMG, IMG, 3), np.float32))
        return engine

    cls = {}
    for quantize in ("", "int8"):
        tag = quantize or "bf16"
        engine = cls_engine(quantize)
        r = {"probs": engine(xs)}
        if quantize:
            names = quantized_modules(engine.model)
            check(names == projections(len(engine.model.blocks)),
                  f"(b) int8 set {names} (the head is under the floor)")
            x_req, preds, launched = post(engine, "classification", 1)
            want = per_forward(engine.model, len(names))
            print(f"  (b) int8 classifier: {len(names)} weights int8; one "
                  f"POST launched {launched}")
            check(launched == want, f"(b) launches {launched} != {want}")
            served = np.asarray([p["probs"] for p in preds])
            check(np.array_equal(served, engine(x_req)),
                  "(b) POST against the engine")
            err = float(np.abs(r["probs"] - cls["bf16"]["probs"]).max())
            set_plain(engine.model, True)
            reset()
            plain = engine(xs)
            n_plain = counts()
            set_plain(engine.model, False)
            err_p = float(np.abs(r["probs"] - plain).max())
            print(f"  (b) int8 against bf16 probabilities: max |diff| "
                  f"{err:.3e} (tolerance {INT8_PROB_TOL}); against its plain "
                  f"versions {err_p:.3e} (tolerance {PROB_TOL}), plain "
                  f"launches {n_plain}")
            check(all(v == 0 for v in n_plain.values()),
                  f"(b) plain run launched {n_plain}")
            check(err <= INT8_PROB_TOL, f"(b) int8 probabilities {err:.3e}")
            check(err_p <= PROB_TOL, f"(b) int8 vs plain {err_p:.3e}")
            r.update(launches_a_forward=launched, int8_weights=len(names),
                     max_err_vs_bf16=err, max_err_vs_plain=err_p)
        r["p50_ms"] = _bucket_p50(engine, BUCKETS, rng)
        r.update(_engine_memory(engine, BUCKETS[-1], rng))
        busy = {}
        for b in (BUCKETS[0], BUCKETS[-1]):
            xb = rng.normal(size=(b, IMG, IMG, 3)).astype(np.float32)
            busy[b] = {name: device_ms(lambda: engine(xb), match, 5,
                                       f"{tag} classifier bucket {b} {name}",
                                       alone=False)
                       for name, match in (("busy", ""),
                                           ("int8_linear", "int8_linear"))
                       if quantize or name == "busy"}
        r["device_ms"] = busy
        print(f"  (b) {tag} classifier on {card}: p50 "
              f"{r['p50_ms']} ms, weights {r['weights_gib']:.3f} GiB, "
              f"bucket-{BUCKETS[-1]} peak "
              f"{r[f'peak_gib_b{BUCKETS[-1]}']:.3f} GiB, device ms a call "
              f"{busy} (profiler, 5 calls)")
        cls[tag] = r
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    for r in cls.values():
        del r["probs"]

    # (c) the embedding engine on the pretrain CLI's checkpoint
    emb = {}
    for quantize in ("", "int8"):
        tag = quantize or "bf16"
        engine = _built(embedding_engine, checkpoint=pretrained,
                        img_size=IMG, buckets=EMB_BUCKETS, device="cuda",
                        quantize=quantize)
        engine.warmup(np.zeros((1, IMG, IMG, 3), np.float32))
        reset()
        e = engine(xs)
        launched = counts()
        norm_err = float(np.abs(np.linalg.norm(e, axis=-1) - 1).max())
        r = {"launches_a_forward": launched, "norm_err": norm_err}
        want = per_forward(engine.model, 0)
        if quantize:
            names = quantized_modules(engine.model)
            path = [n for n in names
                    if n.startswith(("patch_embed", "blocks.", "bert_mlp"))]
            want["int8_linear"] = len(path)
            check(path == projections(len(engine.model.blocks))
                  + ["bert_mlp"], f"(c) int8 weights on the path {path}")
            cos = (e * emb["bf16"]["emb"]).sum(-1) / (
                np.linalg.norm(e, axis=-1)
                * np.linalg.norm(emb["bf16"]["emb"], axis=-1))
            r.update(int8_weights=len(names), min_cosine_vs_bf16=float(
                cos.min()))
            print(f"  (c) int8 embedding: {len(names)} weights int8, "
                  f"{len(path)} on its path; cosine to bf16 >= "
                  f"{cos.min():.5f} (needed {EMB_COS})")
            check(cos.min() >= EMB_COS, f"(c) cosine {cos.min():.5f}")
        else:
            set_plain(engine.model, True)
            reset()
            plain = engine(xs)
            n_plain = counts()
            set_plain(engine.model, False)
            err_p = float(np.abs(e - plain).max())
            check(all(v == 0 for v in n_plain.values()),
                  f"(c) plain run launched {n_plain}")
            check(err_p <= EMB_PLAIN_TOL, f"(c) embedding vs plain "
                  f"{err_p:.3e}")
            x_req, preds, posted = post(engine, "embedding", 1)
            served = np.asarray([p["embedding"] for p in preds])
            check(served.shape == (1, e.shape[1]) and np.array_equal(
                served, engine(x_req)), "(c) POST against the engine")
            check(posted == want, f"(c) POST launches {posted} != {want}")
            r.update(max_err_vs_plain=err_p, dim=int(e.shape[1]),
                     post_launches=posted)
            print(f"  (c) embedding {e.shape}: max |norm - 1| {norm_err:.2e}"
                  f", against its plain versions {err_p:.3e}; one POST "
                  f"launched {posted}")
        check(launched == want, f"(c) {tag} launches {launched} != {want}")
        check(norm_err <= EMB_NORM_TOL, f"(c) norm off by {norm_err:.2e}")
        r["p50_ms"] = _bucket_p50(engine, EMB_BUCKETS, rng)
        r.update(_engine_memory(engine, EMB_BUCKETS[-1], rng))
        print(f"  (c) {tag} embedding on {card}: p50 {r['p50_ms']} ms, "
              f"weights {r['weights_gib']:.3f} GiB, bucket-"
              f"{EMB_BUCKETS[-1]} peak {r[f'peak_gib_b{EMB_BUCKETS[-1]}']:.3f}"
              f" GiB")
        emb[tag] = dict(r, emb=e)
        del engine
        gc.collect()
        torch.cuda.empty_cache()

    # (d) the export, on the CPU, and the engines on what it wrote
    t = time.perf_counter()
    pre_out = os.path.join(work, "export_pretrain.pth")
    export.main(["--task", "pretrain", "--checkpoint", pretrained,
                 "--output", pre_out])
    cls_out = os.path.join(work, "export_cls.pth")
    export.main(["--task", "classification", "--checkpoint", best_cls,
                 "--output", cls_out, "--num_classes", str(N_CLASSES)])
    export_s = time.perf_counter() - t
    written = torch.load(pre_out, map_location="cpu", weights_only=True)
    check(set(written) == {"model", "epoch"} and written["epoch"] == 2,
          f"(d) pretrain export {sorted(written)}")
    engine = embedding_engine(pre_out, img_size=IMG, buckets=EMB_BUCKETS,
                              device="cuda")
    same_emb = np.array_equal(engine(xs), emb["bf16"]["emb"])
    del engine
    same_probs = np.array_equal(*(
        classifier_engine(path, num_classes=N_CLASSES, img_size=IMG,
                          buckets=(8,), device="cuda")(xs)
        for path in (best_cls, cls_out)))
    print(f"  (d) cli.export {export_s:.1f} s (both, CPU): embeddings from "
          f"the exported pretrain .pth bit-equal {same_emb}, probabilities "
          f"from the exported classifier bit-equal {same_probs}")
    check(same_emb and same_probs, "(d) export round trip")
    for r in emb.values():
        del r["emb"]
    gc.collect()
    torch.cuda.empty_cache()
    result = {"card": card, "classifier": cls, "embedding": emb,
              "export_seconds": export_s,
              "phase_seconds": time.perf_counter() - t_phase}
    print(f"  serving phase: {result['phase_seconds']:.1f} s")
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; the port's smoke run needs "
              "one and does not run on the CPU", file=sys.stderr)
        return 1
    from ecamp_tpu_torch.kernels import _build
    from ecamp_tpu_torch.kernels import flash_attention as fa
    from ecamp_tpu_torch.kernels import fused_adamw as adamw
    from ecamp_tpu_torch.kernels import fused_mlm_loss as mlm
    from ecamp_tpu_torch.kernels import int8_linear as i8
    from ecamp_tpu_torch.kernels import layer_norm as ln
    from ecamp_tpu_torch.kernels import sr_head as sr

    card = card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmuls and cuDNN: the fp32 comparisons are full fp32")
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"built {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip())

    clock = {}  # each phase's end, seconds from here

    def mark(name):
        clock[name] = time.perf_counter() - t_main
        print(f"[{clock[name]:.1f} s] {name} done", flush=True)

    t_main = time.perf_counter()
    shape_rows = []
    kernel_phase(card, shape_rows)
    mark("kernels")
    main_times = train_kernel_phase(card, shape_rows)
    mark("train_kernels")
    main_times.update(fused_ce_phase(card))
    mark("fused_ce")
    serve_launches, prob_err, p50, serve_busy = slice_phase(card)
    mark("serving")
    launches, flaunches, main_times["adamw"], pretrain = pretrain_phase(card)
    mark("pretrain")
    recipe = recipe_phase(card)
    mark("recipe")
    ft_times = finetune_kernel_phase(card, shape_rows)
    mark("finetune_kernels")
    work = tempfile.mkdtemp(prefix="ecamp_cli_")
    try:
        cli_per_step = {k: v // PRE_STEPS for k, v in flaunches.items()}
        cli, ckpt = cli_phase(card, cli_per_step, work)
        mark("pretrain_cli")
        recipe["cli"] = cli_accum_phase(card, cli_per_step, work)
        mark("pretrain_cli_accum")
        dp = dp_phase(card, {k: v // PRE_STEPS for k, v in launches.items()},
                      cli_per_step, work)
        mark("data_parallel")
        finetune = finetune_phase(card, ckpt, work)
        mark("finetune")
        seg_kernels = segmentation_kernel_phase(card, shape_rows)
        mark("segmentation_kernels")
        segmentation = segmentation_phase(card, ckpt, work, seg_kernels,
                                          shape_rows)
        mark("segmentation")
        det_kernels = detection_kernel_phase(card, shape_rows)
        mark("detection_kernels")
        detection = detection_phase(card, ckpt, work, det_kernels,
                                    shape_rows)
        mark("detection")
        dpf = dp_finetune_phase(card, ckpt, work)
        mark("data_parallel_finetune")
        tv_pth = write_torchvision_resnet50(work)
        resnet_kernels = {"resnet_seg": {}, "resnet_det": {}}
        resnet_seg = resnet_phase(card, "seg", work, tv_pth,
                                  resnet_kernels["resnet_seg"], shape_rows)
        mark("resnet_seg")
        resnet_det = resnet_phase(card, "det", work, tv_pth,
                                  resnet_kernels["resnet_det"], shape_rows)
        mark("resnet_det")
        viz = visualize_phase(card, ckpt, work, shape_rows)
        mark("visualize")
        main_times["int8_linear"] = int8_kernel_phase(card, shape_rows)
        mark("int8_kernels")
        serving = serving_rest_phase(
            card, ckpt, os.path.join(work, "ft_out", "best",
                                     "checkpoint-best.pth"), work)
        mark("serving_rest")
    finally:
        for p in _STARTED:  # a failed check leaves no run behind
            _stop(p)
        shutil.rmtree(work, ignore_errors=True)

    # launches: the materialised step's (d) for the first four kernels, the
    # fused-CE step's (f) for the fused CE (dx + dW for its backward)
    launches["fused_ce_fwd"] = (flaunches["fused_ce_fwd"]
                                + flaunches["fused_ce_merge"])
    launches["fused_ce_bwd"] = (flaunches["fused_ce_dl"]
                                + flaunches["fused_ce_dx"]
                                + flaunches["fused_ce_dw"])
    # the int8 kernel's main path: one POST to the int8 classifier engine
    int8_cls = serving["classifier"]["int8"]["launches_a_forward"]
    int8_emb = serving["embedding"]["int8"]["launches_a_forward"]
    launches["int8_linear"] = int8_cls["int8_linear"]
    no_library = {
        "sr_conv_stack": "no single PyTorch call: two convolutions with "
                         "biases and relus, then the residual",
        "adamw": "no single PyTorch call: torch's fused AdamW has neither "
                 "the weight-decay mask nor the folded clip",
        "fused_ce_fwd": "no single PyTorch call: the vocab product, then "
                        "logsumexp and the gold logit",
        "fused_ce_bwd": "no single PyTorch call: softmax minus one-hot, "
                        "then the dx, dW and db products"}
    # the counters of each kernel of the `kernels` line
    parts = {"fused_ce_fwd": ("fused_ce_fwd", "fused_ce_merge"),
             "fused_ce_bwd": ("fused_ce_dl", "fused_ce_dx", "fused_ce_dw")}
    kernels = []
    for name, mod, route, replaces in (
            ("layer_norm", ln, "cuda",
             "ecamp_tpu/kernels/layer_norm.py:46"),
            ("attention", fa, "cuda",
             "ecamp_tpu/kernels/flash_attention.py:106"),
            ("sr_conv_stack", sr, "cuda", "ecamp_tpu/kernels/sr_head.py:79"),
            ("adamw", adamw, "cuda",
             "ecamp_tpu/kernels/fused_adamw.py:100"),
            ("fused_ce_fwd", mlm, "cuda",
             "ecamp_tpu/kernels/fused_mlm_loss.py:85"),
            ("fused_ce_bwd", mlm, "cuda",
             "ecamp_tpu/kernels/fused_mlm_loss.py:194"),
            ("int8_linear", i8, "cuda", "ecamp_tpu/serve/quantize.py:60")):
        t = main_times[name]
        entry = {"name": name, "route": route, "source": mod.SOURCE,
                 "replaces": replaces, "launches": launches[name],
                 **{k: t[k] for k in ("max_abs_err", "ms", "plain_ms",
                                      "device_ms", "bound_ms", "bound_by")},
                 "library_ms": t.get("library_ms")}
        if name in no_library:
            entry["library_note"] = no_library[name]
        else:
            entry["library_device_ms"] = t["library_device_ms"]
            entry["vs_library"] = t["vs_library"]
        if name in serve_launches:
            entry["serve_launches"] = serve_launches[name]
        if name in finetune["launches_a_step"]:  # a fine-tune step's
            entry["finetune_launches"] = finetune["launches_a_step"][name]
        if name in segmentation["launches_a_step"]:  # a segmentation step's
            entry["segmentation_launches"] = \
                segmentation["launches_a_step"][name]
        if name in detection["launches_a_step"]:  # a detection step's
            entry["detection_launches"] = detection["launches_a_step"][name]
        for tag, run in (("resnet_seg", resnet_seg),
                         ("resnet_det", resnet_det)):  # a step's
            if name in run["launches_a_step"]:
                entry[f"{tag}_launches"] = run["launches_a_step"][name]
        # one update of the recipe's accumulation at B = RECIPE_B, (e) and
        # (f): RECIPE_ACCUM micro-steps
        for tag in ("e", "f"):
            run = recipe[tag]["launches"]
            n = sum(run.get(k, 0) for k in parts.get(name, (name,)))
            if n:
                entry[f"recipe_{tag}_launches"] = n
        # the data-parallel phase (6e): a rank's DP_STEPS steps of its
        # multi-rank run (plain, ZeRO-1), the torchrun CLI's rank 0 epoch
        dp_run = dp["runs"][max(dp["runs"], key=lambda t: dp["runs"][t]
                                ["ranks"])]["launches"]
        cli_dp = dp["cli"]["log"]["kernel_launches"]
        n = sum(dp_run["plain"][0].get(k, 0) for k in parts.get(name, (name,)))
        if n:
            entry["dp_launches"] = n
            entry["dp_zero1_launches"] = sum(
                dp_run["zero1"][0].get(k, 0)
                for k in parts.get(name, (name,)))
        n = sum(cli_dp.get(k, 0) for k in parts.get(name, (name,)))
        if n:
            entry["dp_cli_launches"] = n
        # (9f) (a): a rank's DPF_STEPS steps of SegViT and of the ViT
        # detector in its multi-rank run
        dpf_run = dpf["runs"][max(dpf["runs"], key=lambda t: dpf["runs"][t]
                                  ["ranks"])]
        for kind in ("seg", "det"):
            n = dpf_run[kind]["launches"][0].get(name, 0)
            if n:
                entry[f"dp_{kind}_launches"] = n
        if name in viz["launches"]:  # one visualizer forward's
            entry["visualize_launches"] = viz["launches"][name]
        if name in int8_cls:  # one forward of each int8 engine
            entry["int8_classifier_launches"] = int8_cls[name]
            entry["int8_embedding_launches"] = int8_emb[name]
        if name == "int8_linear":
            entry["shape"] = t["shape"]
            entry["tpu_kernel"] = ("none: XLA fuses the dequantisation into "
                                   "the dot (ecamp_tpu/serve/quantize.py:"
                                   "60-83)")
        if name == "fused_ce_fwd":  # the tile kernel and the merge
            entry["parts"] = {
                k: {"launches_a_step": flaunches[
                        "fused_ce_fwd" if k == "tiles" else "fused_ce_merge"]
                    // PRE_STEPS,
                    **{f: t["parts"][k][f] for f in (
                        "max_abs_err", "ms", "plain_ms", "device_ms",
                        "bound_ms", "bound_by")}}
                for k in ("tiles", "merge")}
        if name == "fused_ce_bwd":  # three kernels a vocab chunk
            entry["chunk"] = t["chunk"]
            entry["launches_a_step"] = {
                k: flaunches[f"fused_ce_{k}"] // PRE_STEPS
                for k in ("dl", "dx", "dw")}
            entry["parts_first_chunk"] = {
                k: {f: t["parts_first_chunk"][k][f] for f in (
                    "max_abs_err", "ms", "plain_ms", "device_ms", "bound_ms")}
                for k in ("dl", "dx", "dw")}
        kernels.append(entry)
    print(json.dumps({"kernel_shapes": shape_rows}))
    print(json.dumps({"serve_p50_ms": {str(b): v for b, v in p50.items()},
                      f"serve_device_ms_b{BUCKETS[-1]}": serve_busy,
                      "max_prob_err": prob_err, "card": card}))
    print(json.dumps({"pretrain": pretrain}))
    print(json.dumps({"cli_epochs": cli}))
    print(json.dumps({"pretrain_recipe": recipe}))
    print(json.dumps({"data_parallel": dp}))
    print(json.dumps({"finetune": finetune, "finetune_kernels": ft_times}))
    print(json.dumps({"segmentation": segmentation,
                      "segmentation_kernels": seg_kernels}))
    print(json.dumps({"detection": detection,
                      "detection_kernels": det_kernels}))
    print(json.dumps({"data_parallel_finetune": dpf}))
    print(json.dumps({"resnet_seg": resnet_seg, "resnet_det": resnet_det,
                      "resnet_kernels": resnet_kernels}))
    print(json.dumps({"visualize": viz}))
    print(json.dumps({"serving_rest": serving}))
    print(json.dumps({"fused_ce_mainloop":
                      main_times["fused_ce_bwd"]["mainloop"]}))
    print(json.dumps({"device_ms_by_events": BY_EVENTS}))
    print(json.dumps({"phase_end_seconds": clock}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--dp-worker":
        sys.exit(dp_worker(json.loads(sys.argv[2])))
    if len(sys.argv) == 3 and sys.argv[1] == "--dp-ft-worker":
        sys.exit(dp_ft_worker(json.loads(sys.argv[2])))
    sys.exit(main())
