#!/usr/bin/env python3
"""Time the port's bf16 attention, fused-CE forward and SR conv stack
kernels of one checkout on the card, for an A/B of two versions in one
machine's turn.

    python3 tools/kernel_ab.py ROOT TAG [attention] [fused_ce] [sr]

ROOT is a checkout (or a copy of `ecamp_tpu_torch/` under ROOT) whose
kernels are built and timed; TAG names it in the output. Run two roots in
turns (a, b, b, a) from the repository's root, so both meet one card and
its drift. Each attention shape is checked against the plain version,
then timed by the profiler on `chip_smoke.rotated` copies of its inputs
beside `F.scaled_dot_product_attention` on the same copies: one JSON line
a shape (device ms, SDPA's, their ratio), then one for the fused-CE
forward at (8192, 768, 30000) and its merge, then one for the SR conv
stack forward at (32, 3, 448, 448) bf16, checked against the plain version
in fp32 rounded once, then timed on rotated copies: the kernel's device ms
(`sr_conv_stack_device_ms`), the device ms of everything the wrapper runs
on the card (the parameters' packing and copy too) and the path it took.
The names after TAG pick the parts (all three by default). Needs the card.
"""

import json
import os
import sys

ROOT, TAG = sys.argv[1], sys.argv[2]
PARTS = sys.argv[3:] or ["attention", "fused_ce", "sr"]
sys.path.insert(0, os.path.abspath(ROOT))
sys.path.append(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ecamp_tpu_torch.kernels import flash_attention as fa  # noqa: E402
from ecamp_tpu_torch.kernels import fused_mlm_loss as mlm  # noqa: E402
from ecamp_tpu_torch.kernels import sr_head as sr  # noqa: E402

SHAPES = (((32, 6, 256, 256, 128), "key_padding"),  # BERT self, the step
          ((32, 6, 256, 256, 128), "none"),
          ((64, 12, 197, 197, 64), "none"),         # 224-px serving
          ((64, 12, 197, 197, 64), "key_padding"),
          ((8, 12, 785, 785, 64), "none"),          # 448-px serving
          ((32, 6, 256, 49, 128), "none"),          # fusion cross
          ((32, 12, 50, 50, 64), "none"),           # MAE encoder
          ((32, 16, 197, 197, 32), "none"))         # MAE decoder


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA card", file=sys.stderr)
        return 1
    assert os.path.abspath(fa.__file__).startswith(os.path.abspath(ROOT))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    if "attention" in PARTS:
        for (b, h, nq, nk, d), kind in SHAPES:
            q = torch.randn(b, h, nq, d, device=dev, generator=gen).bfloat16()
            k, v = (torch.randn(b, h, nk, d, device=dev, generator=gen)
                    .bfloat16() for _ in range(2))
            bias = None
            if kind == "key_padding":
                keep = torch.arange(nk, device=dev)[None, :] < torch.randint(
                    nk // 2, nk + 1, (b, 1), device=dev, generator=gen)
                bias = torch.where(keep, 0.0, torch.finfo(torch.float32).min
                                   ).reshape(b, 1, 1, nk)
            cs._within(f"{TAG} {kind}", fa.flash_attention(q, k, v, bias),
                       fa._attention_reference(q, k, v, bias), torch.bfloat16)
            mask = None if bias is None else bias.to(q.dtype)
            ms = cs.device_ms(cs.rotated(fa.flash_attention, (q, k, v, bias)),
                              "attention_fwd", 20, f"{TAG} attention")
            sdpa = cs.device_ms(cs.rotated(cs._sdpa, (q, k, v, mask)), "", 20,
                                f"{TAG} sdpa")
            print(json.dumps({"tag": TAG, "shape": [b, h, nq, nk, d],
                              "bias": kind, "device_ms": ms, "sdpa_ms": sdpa,
                              "ratio": ms / sdpa}), flush=True)
    if "fused_ce" in PARTS:
        n, d, v = 8192, 768, 30000
        x = torch.randn(n, d, device=dev, generator=gen).bfloat16()
        w = (0.05 * torch.randn(v, d, device=dev, generator=gen)).bfloat16()
        bias = 0.1 * torch.randn(v, device=dev, generator=gen)
        labels = torch.randint(0, v, (n,), device=dev, generator=gen)
        fwd = cs.rotated(mlm._forward_cuda, (x, w, bias, labels))
        print(json.dumps({"tag": TAG, "fused_ce_fwd_device_ms": cs.device_ms(
            fwd, "fused_ce_fwd", 5, f"{TAG} fused CE fwd"), "merge_ms":
            cs.device_ms(fwd, "merge", 5, f"{TAG} merge")}))
    if "sr" in PARTS:
        torch.backends.cudnn.allow_tf32 = False
        x = torch.randn(32, 3, 448, 448, device=dev, generator=gen).bfloat16()
        w1, w2 = (0.2 * torch.randn(3, 3, 3, 3, device=dev, generator=gen)
                  for _ in range(2))
        b1, b2 = (0.1 * torch.randn(3, device=dev, generator=gen)
                  for _ in range(2))
        ins = (x, w1, b1, w2, b2)
        cs._within(f"{TAG} sr", sr.sr_conv_stack(*ins), sr._sr_reference(
            x.float(), w1, b1, w2, b2).bfloat16(), torch.bfloat16)
        call = cs.rotated(sr.sr_conv_stack, ins)
        path = sr.sr_path(x) if hasattr(sr, "sr_path") else "generic"
        print(json.dumps({
            "tag": TAG, "shape": list(x.shape), "path": path,
            "sr_conv_stack_device_ms": cs.device_ms(
                call, "sr_conv_stack", 20, f"{TAG} sr"),
            "wrapper_device_ms": cs.device_ms(call, "", 20,
                                              f"{TAG} sr wrapper")}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
