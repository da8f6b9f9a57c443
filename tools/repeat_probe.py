"""Does a fine-tune step repeat itself bit for bit on the card, and what
does the align-corners upsample's backward cost?

Runs the segmentation (SegViT, SIIM) and detection (ViT detector, RSNA)
tasks at full width, bf16, from their seeded initial weights, for a few
steps on one seeded batch, twice, and compares every parameter and
BatchNorm statistic of the two runs, with three versions of the
align-corners upsample (the seg decoder's four stages, the det neck's
one):

- `interpolate`: `F.interpolate`'s own backward (atomic adds);
- `taps`: the transposed resize as a fixed-order weighted sum of
  `index_select` gathers (here only);
- `gemm`: the port's (`ops/image_ops.py`: two batched fp32 products).

Then each version's forward + backward alone at the shapes of a full
step (the seg decoder's stages at B = 512, the det neck at B = 1024;
bf16, channels_last), by CUDA events, and whether two backwards of the
same gradient are bit-equal. Prints a line a row and one JSON line.

    python3 tools/repeat_probe.py [--seg_b 32] [--det_b 64] [--steps 3]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _interpolate_upsample(x, scale):
    import torch.nn.functional as F

    return F.interpolate(x.float(), scale_factor=scale, mode="bilinear",
                         align_corners=True).to(x.dtype)


def _taps_upsample(x, scale):
    """The upsample with its backward as gathers: input i's gradient is
    sum over k, in order, of m[o_k, i] * grad[o_k] over the outputs o_k
    that read i."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from ecamp_tpu_torch.ops.image_ops import _align_corners_matrix

    def taps(src, dst, device):
        m = _align_corners_matrix(src, dst)  # (dst, src)
        k = int((m != 0).sum(0).max())
        index = np.zeros((src, k), np.int64)
        weight = np.zeros((src, k), np.float32)
        for i in range(src):
            outs = np.nonzero(m[:, i])[0]
            index[i, :len(outs)], weight[i, :len(outs)] = outs, m[outs, i]
        return (torch.from_numpy(index).to(device),
                torch.from_numpy(weight).to(device))

    def transposed(g, dim, src):
        index, weight = taps(src, g.shape[dim], g.device)
        shape = [1] * g.dim()
        shape[dim] = src
        out = None
        for k in range(index.shape[1]):
            term = g.index_select(dim, index[:, k])
            term.mul_(weight[:, k].view(shape))
            out = term if out is None else out.add_(term)
        return out

    class Up(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            ctx.hw = x.shape[-2:]
            return F.interpolate(x, scale_factor=scale, mode="bilinear",
                                 align_corners=True)

        @staticmethod
        def backward(ctx, g):
            h, w = ctx.hw
            t = g.float().permute(0, 2, 3, 1)
            t = transposed(transposed(t, 2, w), 1, h)
            return t.permute(0, 3, 1, 2)

    return Up.apply(x.float()).to(x.dtype)


def _version(variant):
    from ecamp_tpu_torch.ops import image_ops

    return {"interpolate": _interpolate_upsample, "taps": _taps_upsample,
            "gemm": image_ops.upsample_align_corners}[variant]


def upsample_cost(variant: str, shape, reps: int = 5) -> dict:
    """fp32 forward + backward of one upsample of a bf16 channels_last
    NCHW `shape`, CUDA-event ms (median of `reps`), and whether two
    backwards of one gradient are bit-equal."""
    import torch

    up = _version(variant)
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(shape, device="cuda", generator=gen).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    x.requires_grad_(True)
    b, c, h, w = shape
    g = torch.randn(b, h * 2, w * 2, c, device="cuda", generator=gen).to(
        torch.bfloat16).permute(0, 3, 1, 2)
    grads, ms = [], []
    for i in range(reps + 2):
        x.grad = None
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        up(x, 2).backward(g)
        t1.record()
        torch.cuda.synchronize()
        ms.append(t0.elapsed_time(t1))
        if i < 2:
            grads.append(x.grad.clone())
    equal = torch.equal(grads[0], grads[1])
    del x, g, grads
    torch.cuda.empty_cache()
    return {"shape": list(shape), "variant": variant,
            "ms": statistics.median(ms[2:]), "grad_bit_equal": equal}


def run(task_name: str, b: int, steps: int, variant: str,
        device: str = "cuda") -> dict:
    import torch

    from ecamp_tpu_torch.core import config as c
    from ecamp_tpu_torch.data.synthetic import detection_batch
    from ecamp_tpu_torch.nn import det, seg

    det.upsample_align_corners = seg.upsample_align_corners = \
        _version(variant)
    opt = c.OptimizerConfig(name="adamw", lr=5e-4, weight_decay=0.05,
                            betas=(0.9, 0.999), schedule="warmup_cosine_step",
                            warmup_steps=2, total_steps=100, grad_clip=1.0)
    gen = torch.Generator(device=device).manual_seed(1)
    if task_name == "segmentation":
        from ecamp_tpu_torch.train.segmentation import SegmentationTask

        task = SegmentationTask(c.SegmentationConfig(optimizer=opt,
                                                     task="SIIM", seed=0),
                                device=device)
        yy, xx = torch.meshgrid(torch.arange(224, device=device),
                                torch.arange(224, device=device),
                                indexing="ij")
        ctr = 40 + 144 * torch.rand(b, 2, 1, 1, device=device, generator=gen)
        mask = (((yy - ctr[:, 0]) ** 2 + (xx - ctr[:, 1]) ** 2) <= 900
                ).float()[..., None]
        img = (100 + 25 * torch.randn(b, 224, 224, 1, device=device,
                                      generator=gen) + 70 * mask)
        batch = (img.clamp(0, 255).to(torch.uint8), mask)
    else:
        from ecamp_tpu_torch.train.detection import DetectionTask

        cfg = c.DetectionConfig(optimizer=opt, seed=0)
        task = DetectionTask(cfg, device=device)
        batch = detection_batch(b, cfg.max_objects, gen)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    init = {k: v.detach().clone() for k, v in task.model.state_dict().items()}
    finals, ms = [], []
    for _ in range(2):
        task.model.load_state_dict(init)
        state = task.init_state()
        for _ in range(steps):
            sync()
            t = time.perf_counter()
            state, m = task.train_step(state, *batch)
            sync()
            ms.append((time.perf_counter() - t) * 1e3)
        finals.append({k: v.detach().clone()
                       for k, v in task.model.state_dict().items()})
    a, z = finals
    diff = max(float((a[k].double() - z[k].double()).abs().max())
               for k in a if a[k].numel())
    del task, init, finals, a, z
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"task": task_name, "variant": variant, "batch": b,
            "steps": steps, "bit_equal": diff == 0.0, "max_abs_diff": diff,
            "step_ms_median": statistics.median(ms[1:])}


VARIANTS = ("interpolate", "taps", "gemm")
# the seg decoder's four stages at B = 512, the det neck's at B = 1024
OP_SHAPES = ((512, 512, 14, 14), (512, 256, 28, 28), (512, 128, 56, 56),
             (512, 64, 112, 112), (1024, 512, 14, 14))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seg_b", type=int, default=32)
    ap.add_argument("--det_b", type=int, default=64)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="cpu: a rehearsal of the control flow")
    args = ap.parse_args(argv)
    import subprocess

    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    rows = []
    for name, b in (("segmentation", args.seg_b), ("detection", args.det_b)):
        for variant in VARIANTS:
            r = run(name, b, args.steps, variant, args.device)
            rows.append(r)
            print(f"{name} B = {b} {variant}: "
                  + ("bit for bit" if r["bit_equal"] else
                     f"max |diff| {r['max_abs_diff']:.3e}")
                  + f", step {r['step_ms_median']:.3f} ms", flush=True)
    ops = []
    if args.device == "cuda":
        for shape in OP_SHAPES:
            for variant in VARIANTS:
                r = upsample_cost(variant, shape)
                ops.append(r)
                print(f"upsample {tuple(shape)} bf16 {variant}: fwd + bwd "
                      f"{r['ms']:.3f} ms, two backwards "
                      + ("bit-equal" if r["grad_bit_equal"] else "differ"),
                      flush=True)
    card = "cpu" if args.device == "cpu" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps({"card": card, "steps": rows, "upsample": ops}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
