#!/usr/bin/env python3
"""Time the port's bf16 attention, fused-CE forward, SR conv stack and
int8-weight linear kernels of one checkout on the card, for an A/B of two
versions in one machine's turn.

    python3 tools/kernel_ab.py ROOT TAG [attention] [fused_ce] [sr] [int8]
        [int8_plans] [int8_host] [int8_engine]

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
`int8`: the int8-weight linear at chip_smoke's 13 served shapes (M = 197
tokens an image x 1 / 8 / 64 and the four ViT-B projections, and the
ragged one), each checked against the plain version, then timed by the
profiler on rotated copies (`int8_device_ms`, its kernels and any
reduction summed) with the plan the wrapper took, where the tree has one.
`int8_plans` (this tree's wrapper only): at the same shapes, the plans
around `_plan`'s candidates (`_int8_candidates`), each checked and timed:
the data `_plan`'s cost model is fitted to. `int8_host`: the host's time
a call of the wrapper at M = 197 and at the ragged shape, beside
`F.linear`'s (the launch rate of INT8_HOST_CALLS calls queued back to
back): serving's small buckets are host-bound. `int8_engine`: the
serving slice's ViT-B/16 classifier engine, bf16 and `quantize="int8"`
on the same seeded weights, a forward of each bucket on a device input
(the engine's apply function: no host preprocessing or copy), median
host ms of ENGINE_CALLS calls each ending in a synchronise, and of the
enqueue alone. The names after TAG pick the parts (the first three by
default). Needs the card.
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


INT8_SPLITS = (2, 3, 4, 6, 8, 12, 16, 24)  # `int8_plans`: even splits tried
INT8_HOST_CALLS = 400  # `int8_host`: calls a reading
ENGINE_CALLS = 20  # `int8_engine`: forwards a bucket


def _int8_operands(m, n, k, dev, gen):
    x = torch.randn(m, k, device=dev, generator=gen).bfloat16()
    q = torch.randint(-127, 128, (n, k), device=dev, generator=gen,
                      dtype=torch.int32).to(torch.int8)
    s = 2e-3 * torch.rand(n, device=dev, generator=gen) + 1e-4
    b = (0.1 * torch.randn(n, device=dev, generator=gen)).bfloat16()
    return x, q, s, b


def _int8_timed(label, fn, ins, want):
    """fn(*ins) checked against `want`, then its device ms on rotated
    copies (every kernel whose name holds int8_linear)."""
    cs._within(label, fn(*ins), want, torch.bfloat16)
    return cs.device_ms(cs.rotated(fn, ins), "int8_linear", 20, label)


def _host_us(fn, ins):
    """The host's microseconds a call of fn(*ins), calls queued back to
    back (the median of five readings)."""
    import time

    fn(*ins)
    torch.cuda.synchronize()
    readings = []
    for _ in range(5):
        t = time.perf_counter()
        for _ in range(INT8_HOST_CALLS):
            fn(*ins)
        readings.append((time.perf_counter() - t) / INT8_HOST_CALLS * 1e6)
        torch.cuda.synchronize()
    return sorted(readings)[2]


def int8_parts(dev, gen):
    from ecamp_tpu_torch.kernels import int8_linear as i8

    shapes = [(197 * b, n, k) for b in cs.I8_IMAGES
              for n, k in cs.I8_PROJECTIONS] + [cs.I8_RAGGED]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for m, n, k in shapes:
        ins = _int8_operands(m, n, k, dev, gen)
        want = i8._int8_linear_reference(*ins)
        if "int8" in PARTS:
            plan = i8._plan(m, n, k, sms) if hasattr(i8, "_plan") else None
            ms = _int8_timed(f"{TAG} int8 {m, n, k}", i8.int8_linear, ins,
                             want)
            print(json.dumps({"tag": TAG, "shape": [m, n, k],
                              "plan": plan and plan._asdict(),
                              "int8_device_ms": ms}), flush=True)
        if "int8_host" in PARTS and (m == 197 or (m, n, k) == cs.I8_RAGGED):
            lib = (ins[0], i8.dequantize_int8(ins[1], ins[2], ins[0].dtype),
                   ins[3])
            print(json.dumps({"tag": TAG, "shape": [m, n, k],
                              "int8_host_us": _host_us(i8.int8_linear, ins),
                              "f_linear_host_us": _host_us(
                                  torch.nn.functional.linear, lib)}),
                  flush=True)
        if "int8_plans" in PARTS:
            for plan in _int8_candidates(i8, m, n, k, sms):
                ms = _int8_timed(
                    f"{TAG} int8 {m, n, k} {plan}",
                    lambda *a, p=plan: i8._int8_linear_cuda(*a, plan=p),
                    ins, want)
                print(json.dumps({"tag": TAG, "shape": [m, n, k],
                                  "plan": plan._asdict(),
                                  "int8_plan_device_ms": ms}), flush=True)


def _int8_candidates(i8, m, n, k, sms):
    """Plans around `_plan`'s candidates: each token tile unsplit; where
    its tiles are fewer than the SMs, split evenly INT8_SPLITS ways and
    into one to three waves of units; else its last, part-filled wave
    split into one wave of units."""
    nk = -(-k // i8.BK)
    plans = []
    for bt in i8.TILE_T:
        tiles = -(-m // bt) * -(-n // i8.BN)
        plans.append(i8.Plan(bt, tiles, tiles, tiles, min(tiles, sms)))
        if tiles < sms:
            units = {tiles * s for s in INT8_SPLITS} | {
                r * sms for r in (1, 2, 3)}
            plans += [i8.Plan(bt, tiles, 0, u, min(u, sms))
                      for u in sorted(units) if u <= min(3 * sms, tiles * nk)]
        elif tiles % sms and sms <= (tiles % sms) * nk:
            whole = tiles // sms * sms
            plans.append(i8.Plan(bt, tiles, whole, whole + sms, sms))
    return plans


def engine_part(dev):
    """The classifier engine's forward, bf16 and int8 (`int8_engine`)."""
    import time

    import numpy as np

    from ecamp_tpu_torch.serve import classifier_engine

    for quantize in ("", "int8"):
        engine = classifier_engine(
            num_classes=cs.N_CLASSES, img_size=cs.IMG, buckets=cs.BUCKETS,
            device=str(dev), seed=cs.SEED, quantize=quantize)
        engine.warmup(np.zeros((1, cs.IMG, cs.IMG, 3), np.float32))
        for b in cs.BUCKETS:
            x = torch.zeros(b, cs.IMG, cs.IMG, 3, device=dev)
            with torch.inference_mode():
                for _ in range(3):
                    engine._fn(x)
                torch.cuda.synchronize()
                enq, fwd = [], []
                for _ in range(ENGINE_CALLS):
                    t0 = time.perf_counter()
                    engine._fn(x)
                    t1 = time.perf_counter()
                    torch.cuda.synchronize()
                    enq.append((t1 - t0) * 1e3)
                    fwd.append((time.perf_counter() - t0) * 1e3)
            print(json.dumps({"tag": TAG, "engine": quantize or "bf16",
                              "bucket": b, "forward_ms": float(np.median(fwd)),
                              "enqueue_ms": float(np.median(enq))}),
                  flush=True)
        del engine
        torch.cuda.empty_cache()


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
    if {"int8", "int8_plans", "int8_host"} & set(PARTS):
        int8_parts(dev, gen)
    if "int8_engine" in PARTS:
        engine_part(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
