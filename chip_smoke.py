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
5. The fused vocab-projection + CE kernels (in 2., after the SR stack)
   against their plain versions at the step's shape (B * 256, 768, 30000)
   in bf16, at a ragged fp32 shape, and at a ragged bf16 shape (V = 3001:
   a 57-wide last vocab tile) over three lowered vocab chunks; each
   tensor-core kernel (the forward's tiles and merge, the backward's dl,
   dx, dW) also alone against its plain version, timed by name at the
   main shape.
6. The pretraining CLI: `python -m ecamp_tpu_torch.cli.pretrain
   --fused_mlm_ce` at full width on a seeded MIMIC-style corpus written to
   a temporary directory, 2 epochs and a resume for a third.
7. Per-bucket p50 latency and the device time of a bucket-64 call, JSON
   lines of the results, of every kernel shape timed and of the kernels
   and, last, the device line.

Any failed check or exception exits non-zero. Without a CUDA card it fails
at once; it never runs on the CPU.
"""

from __future__ import annotations

import base64
import io
import json
import os
import subprocess
import sys
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
    rate. The profiler now and then records no kernel at all: after
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
        us = sum(_device_us(e) for e in prof.key_averages()
                 if match in e.key)
        if us > 0:
            return us / calls / 1e3
    what = f"'{label or match}': the profiler saw no kernel in " \
        f"{PROFILER_TRIES} tries"
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
            work=None, inputs=None, library_inputs=None) -> dict:
    """Run a kernel wrapper and its plain version on the same inputs; check
    every output at the tolerance of `dtype` (a tuple of outputs are
    gradients, checked relative to their scale) against `oracle_fn` if
    given, else the plain version; time both. `library_fn`, one PyTorch
    call that computes the same function (a yardstick the port never
    calls), is timed beside them; `match`, the kernel's name, adds the
    profiler's device time of the kernel (and of the library call);
    `work`, its (flops, bytes, type), adds its bound. With `inputs`, every
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
        r["device_ms"] = device_ms(timed_kernel, match, label=label)
        line += f"  device {r['device_ms']:8.4f} ms"
        if library_fn is not None:
            r["library_device_ms"] = device_ms(library_fn,
                                               label=f"library {label}")
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


def _attention_fwd(rows, label, q, k, v, bias, dtype):
    """The attention forward at one shape: kernel against plain, with the
    library call, device time and bound; its row joins `rows`."""
    from ecamp_tpu_torch.kernels import flash_attention as fa

    b, h, nq, d = q.shape
    mask = None if bias is None else bias.to(q.dtype)
    r = compare(label, fa.flash_attention, fa._attention_reference, dtype,
                library_fn=_sdpa, match="attention_fwd",
                work=attention_work(b, h, nq, k.shape[2], d, q.element_size(),
                                    0 if bias is None else bias.numel()),
                inputs=(q, k, v, bias), library_inputs=(q, k, v, mask))
    rows.append({"kernel": "attention", "shape": label, **r})
    return r


def _layer_norm_fwd(rows, label, x, w, b, eps, dtype):
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
                library_inputs=(x, w.to(x.dtype), b.to(x.dtype), eps))
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


def cli_phase(card: str, per_step):
    """The pretraining entry point at full width: a seeded MIMIC-style
    corpus (CLI_IMAGES gray PNGs at CLI_IMG px, reports of words of the
    repository's 30000-word vocabulary) in a temporary directory, then
    `python -m ecamp_tpu_torch.cli.pretrain --fused_mlm_ce` for 2 epochs
    at B = PRE_B and a resume from its checkpoint-1.pth for a third. Each
    epoch's log line must be finite and count `per_step` launches of every
    kernel a step; the resume must restore the epoch and the AdamW moments
    and step."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from ecamp_tpu_torch.core.config import PretrainConfig
    from ecamp_tpu_torch.data.synthetic import write_mimic_corpus

    cfg = PretrainConfig()  # the CLI's model
    repo = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="ecamp_cli_")
    try:
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
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return recs


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

    shape_rows = []
    kernel_phase(card, shape_rows)
    main_times = train_kernel_phase(card, shape_rows)
    main_times.update(fused_ce_phase(card))
    serve_launches, prob_err, p50, serve_busy = slice_phase(card)
    launches, flaunches, main_times["adamw"], pretrain = pretrain_phase(card)
    cli = cli_phase(card, {k: v // PRE_STEPS for k, v in flaunches.items()})

    # launches: the materialised step's (d) for the first four kernels, the
    # fused-CE step's (f) for the fused CE (dx + dW for its backward)
    launches["fused_ce_fwd"] = (flaunches["fused_ce_fwd"]
                                + flaunches["fused_ce_merge"])
    launches["fused_ce_bwd"] = (flaunches["fused_ce_dl"]
                                + flaunches["fused_ce_dx"]
                                + flaunches["fused_ce_dw"])
    no_library = {
        "sr_conv_stack": "no single PyTorch call: two convolutions with "
                         "biases and relus, then the residual",
        "adamw": "no single PyTorch call: torch's fused AdamW has neither "
                 "the weight-decay mask nor the folded clip",
        "fused_ce_fwd": "no single PyTorch call: the vocab product, then "
                        "logsumexp and the gold logit",
        "fused_ce_bwd": "no single PyTorch call: softmax minus one-hot, "
                        "then the dx, dW and db products"}
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
             "ecamp_tpu/kernels/fused_mlm_loss.py:194")):
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
    print(json.dumps({"fused_ce_mainloop":
                      main_times["fused_ce_bwd"]["mainloop"]}))
    print(json.dumps({"device_ms_by_events": BY_EVENTS}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
