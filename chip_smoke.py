#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ecamp_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. Setup: print the card's `nvidia-smi` name and power limit, turn TF32
   off for the comparisons, build the CUDA library (one nvcc per source, in
   parallel) and import Triton.
2. Kernels against their plain PyTorch versions on the card, in fp32
   (|err| <= 1e-5, relative to the output's scale for a gradient) and bf16
   (atol = rtol = 1.6e-2, about one bf16 ulp of the output), with median
   CUDA-event times: LayerNorm and attention forward at the serving
   shapes; at the pretraining step's shapes (B = 32) LayerNorm and
   attention forward + backward through their autograd Functions against
   autograd of the plain versions, and the SR conv stack forward.
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
   peak device memory.
5. Per-bucket p50 latency, a JSON line of kernels and, last, the device
   line.

Any failed check or exception exits non-zero. Without a CUDA card it fails
at once; it never runs on the CPU.
"""

from __future__ import annotations

import base64
import io
import json
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
            per_pair: int = 10, oracle_fn=None):
    """Run a kernel wrapper and its plain version on the same inputs; check
    every output at the tolerance of `dtype` (a tuple of outputs are
    gradients, checked relative to their scale) against `oracle_fn` if
    given, else the plain version; time both; return (max_abs_err, ms,
    plain_ms)."""
    import torch

    got, want = kernel_fn(), (oracle_fn or plain_fn)()
    torch.cuda.synchronize()
    if isinstance(got, tuple):
        max_err = max(_within(f"{label} [{i}]", a, b, dtype, scaled=True)
                      for i, (a, b) in enumerate(zip(got, want)))
    else:
        max_err = _within(label, got, want, dtype)
    ms = median_ms(kernel_fn, reps, per_pair)
    plain_ms = median_ms(plain_fn, reps, per_pair)
    print(f"  {label:58s} max|err| {max_err:.3e}  kernel {ms:8.4f} ms  "
          f"plain {plain_ms:8.4f} ms")
    return max_err, ms, plain_ms


def kernel_phase(card: str) -> None:
    """LayerNorm and attention forward at the serving slice's shapes."""
    import torch

    from ecamp_tpu_torch.kernels import flash_attention as fa
    from ecamp_tpu_torch.kernels import layer_norm as ln

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    print(f"kernels vs plain versions on {card} (median of {TIMING_REPS} "
          f"CUDA-event pairs around 10 calls each)")

    for rows, d, eps in ((64 * 197, 768, 1e-6), (8 * 256, 768, 1e-12)):
        x32 = torch.randn(rows, d, device=dev, generator=gen) * 2 + 0.5
        w = 1 + 0.1 * torch.randn(d, device=dev, generator=gen)
        b = 0.1 * torch.randn(d, device=dev, generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            compare(f"layer_norm ({rows}, {d}) eps {eps:g} {dtype}",
                    lambda: ln.fused_layer_norm(x, w, b, eps),
                    lambda: ln._ln_reference(x, w, b, eps), dtype)

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
            compare(f"attention ({bsz}, {h}, {n}, {d}) bias {bias_kind} "
                    f"{dtype}",
                    lambda: fa.flash_attention(q, k, v, bias),
                    lambda: fa._attention_reference(q, k, v, bias), dtype)
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


def train_kernel_phase(card: str):
    """The kernels at the pretraining step's shapes (B = PRE_B): LayerNorm
    and attention forward + backward through their autograd Functions
    against autograd of the plain versions, and the SR conv stack."""
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

    for rows, d, eps in ((b * 50, 768, 1e-6), (b * 197, 512, 1e-6),
                         (b * 256, 768, 1e-12)):
        x32 = torch.randn(rows, d, device=dev, generator=gen) * 2 + 0.5
        w = 1 + 0.1 * torch.randn(d, device=dev, generator=gen)
        bias = 0.1 * torch.randn(d, device=dev, generator=gen)
        g32 = torch.randn(rows, d, device=dev, generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            x, g = x32.to(dtype), g32.to(dtype)
            if (rows, dtype) == (b * 256, torch.bfloat16):
                main["layer_norm"] = compare(
                    f"layer_norm fwd ({rows}, {d}) eps {eps:g} {dtype}",
                    lambda: ln.fused_layer_norm(x, w, bias, eps),
                    lambda: ln._ln_reference(x, w, bias, eps), dtype)
            compare(f"layer_norm fwd+bwd ({rows}, {d}) {dtype}",
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
            if kind == "bert self" and dtype == torch.bfloat16:
                main["attention"] = compare(
                    f"{label} fwd",
                    lambda: fa.flash_attention(q, k, v, bias),
                    lambda: fa._attention_reference(q, k, v, bias), dtype)
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
        r = compare(f"sr_conv_stack fwd ({b}, 3, 448, 448) {dtype}",
                    lambda: sr.sr_conv_stack(x, w1, b1, w2, b2),
                    lambda: sr._sr_reference(x, w1, b1, w2, b2), dtype,
                    oracle_fn=lambda: sr._sr_reference(
                        x.float(), w1, b1, w2, b2).to(dtype))
        if dtype == torch.bfloat16:
            main["sr_conv_stack"] = r
    torch.cuda.synchronize()
    return main


def pretrain_phase(card: str):
    import numpy as np
    import torch

    from ecamp_tpu_torch.core.config import OptimizerConfig, PretrainConfig
    from ecamp_tpu_torch.kernels import flash_attention as fa
    from ecamp_tpu_torch.kernels import fused_adamw as adamw
    from ecamp_tpu_torch.kernels import layer_norm as ln
    from ecamp_tpu_torch.kernels import sr_head as sr
    from ecamp_tpu_torch.train.pretrain import PretrainTask, synthetic_batch

    counters = {"layer_norm": ln.launches, "attention": fa.launches,
                "sr_conv_stack": sr.launches, "adamw": adamw.launches}
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
    # BERT layer; one SR conv stack; one AdamW update
    per_step = {"layer_norm": (2 * c.depth + 1) + (2 * dc.depth + 1)
                + (1 + 3 + 2 * bc.num_hidden_layers + 1),
                "attention": c.depth + dc.depth + 2 + bc.num_hidden_layers,
                "sr_conv_stack": 1, "adamw": 1}
    gen = torch.Generator(device=task.device).manual_seed(SEED + 3)
    batch = synthetic_batch(cfg, PRE_B, gen)
    noise = torch.rand(PRE_B, c.num_patches, device=task.device,
                       generator=gen)
    init = {k: v.clone() for k, v in model.state_dict().items()}
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
    ms = median_ms(lambda: task.tx.apply(pk, grads, sk), 10, 2)
    task.tx.plain = True
    plain_ms = median_ms(lambda: task.tx.apply(pp, grads, sp), 10, 2)
    task.tx.plain = False
    print(f"  {'adamw update, ' + str(n_params) + ' fp32 parameters':58s} "
          f"max|err| {err:.3e}  kernel {ms:8.4f} ms  plain {plain_ms:8.4f} ms")
    adamw_times = (err, ms, plain_ms)
    del pk, sk, pp, sp, grads, opt, state

    _, loss_p, gnorm_p, n_p = first_step(True)
    print(f"  (b) plain step:  {json.dumps(loss_p)} grad norm {gnorm_p:.6g} "
          f"launches {n_p}")
    check(all(v == 0 for v in n_p.values()), f"plain step launched {n_p}")
    for k in ("mim_loss", "res_loss", "mlm_loss"):
        rel = abs(loss_k[k] - loss_p[k]) / abs(loss_p[k])
        check(rel <= LOSS_TOL, f"(b) {k}: kernel {loss_k[k]:.6g} vs plain "
              f"{loss_p[k]:.6g} (rel {rel:.3e})")
    check(abs(gnorm_k - gnorm_p) <= GNORM_TOL * gnorm_p,
          f"(b) grad norm {gnorm_k:.6g} vs plain {gnorm_p:.6g}")

    # (c), (d), (e): PRE_STEPS training steps through the kernels
    model.load_state_dict(init)
    task.set_plain(False)
    state = task.init_state()
    del init
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
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
    print(f"  (c) loss over {PRE_STEPS} steps (dropout on): "
          f"{[round(x, 5) for x in losses]}")
    check(all(np.isfinite(losses)), "(c) non-finite loss")
    check(losses[-1] < losses[0], f"(c) loss did not fall: {losses}")
    want = {k: v * PRE_STEPS for k, v in per_step.items()}
    print(f"  (d) launches in {PRE_STEPS} steps {launches} (per step "
          f"{per_step})")
    check(launches == want, f"(d) launches {launches} != {want}")
    step_ms = float(np.median(times[1:]))
    result = {"step_ms_median": step_ms, "step_ms": times,
              "images_per_s": PRE_B / step_ms * 1e3,
              "max_memory_allocated_bytes": peak, "batch": PRE_B,
              "loss_first_step": loss_k, "loss_plain_step": loss_p,
              "grad_norm": gnorm_k, "grad_norm_plain": gnorm_p,
              "losses": losses, "card": card}
    print(f"  (e) step {step_ms:.3f} ms median of steps 2-{PRE_STEPS} "
          f"(host clock, synchronised), {result['images_per_s']:.2f} "
          f"images/s, peak device memory {peak / 2 ** 30:.3f} GiB on {card}")
    del state, task, model
    torch.cuda.empty_cache()
    return launches, adamw_times, result


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
    torch.cuda.synchronize()
    return {"layer_norm": n_ln, "attention": n_attn}, worst, p50


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible; the port's smoke run needs "
              "one and does not run on the CPU", file=sys.stderr)
        return 1
    from ecamp_tpu_torch.kernels import _build
    from ecamp_tpu_torch.kernels import flash_attention as fa
    from ecamp_tpu_torch.kernels import fused_adamw as adamw
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
    ln._triton_kernel()
    print(f"built {lib.name} and imported triton in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip())

    kernel_phase(card)
    main_times = train_kernel_phase(card)
    serve_launches, prob_err, p50 = slice_phase(card)
    launches, main_times["adamw"], pretrain = pretrain_phase(card)

    kernels = []
    for name, mod, route, replaces in (
            ("layer_norm", ln, "triton",
             "ecamp_tpu/kernels/layer_norm.py:46"),
            ("attention", fa, "cuda",
             "ecamp_tpu/kernels/flash_attention.py:106"),
            ("sr_conv_stack", sr, "cuda", "ecamp_tpu/kernels/sr_head.py:79"),
            ("adamw", adamw, "cuda",
             "ecamp_tpu/kernels/fused_adamw.py:100")):
        err, ms, plain_ms = main_times[name]
        entry = {"name": name, "route": route, "source": mod.SOURCE,
                 "replaces": replaces, "launches": launches[name],
                 "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        if name in serve_launches:
            entry["serve_launches"] = serve_launches[name]
        kernels.append(entry)
    print(json.dumps({"serve_p50_ms": {str(b): v for b, v in p50.items()},
                      "max_prob_err": prob_err, "card": card}))
    print(json.dumps({"pretrain": pretrain}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
