#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ecamp_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

1. Setup: print the card's `nvidia-smi` name and power limit, turn TF32
   off for the comparisons, build the CUDA library and import Triton.
2. Kernels against their plain PyTorch versions on the card, at the
   serving path's shapes, in fp32 (|err| <= 1e-5) and bf16 (atol = rtol =
   1.6e-2, about one bf16 ulp of the output), with median CUDA-event times.
3. The slice: a full-width ViT-B/16 classifier (224 px, 14 classes,
   multilabel, buckets 8/32/64) with seeded random weights behind
   `classifier_engine` + `PredictionService` + the HTTP server. Three
   POSTs (1 image through the MicroBatcher, 5, and 40) must agree with a
   direct forward of the same model through the plain versions, and must
   have launched both kernels the expected number of times.
4. Per-bucket p50 latency, then a JSON line of kernels and, last, the
   device line.

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


def compare(label, kernel_fn, plain_fn, dtype):
    """Run a kernel wrapper and its plain version on the same inputs; check
    the tolerance of `dtype`; return (max_abs_err, ms, plain_ms)."""
    import torch

    got = kernel_fn()
    want = plain_fn()
    torch.cuda.synchronize()
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{label}: {tuple(got.shape)} {got.dtype} vs "
          f"{tuple(want.shape)} {want.dtype}")
    g, w = got.float(), want.float()
    check(bool(torch.isfinite(g).all()), f"{label}: non-finite output")
    err = (g - w).abs()
    tol = FP32_TOL if dtype == torch.float32 else BF16_TOL + BF16_TOL * w.abs()
    max_err = float(err.max())
    check(bool((err <= tol).all()), f"{label}: max |err| {max_err:.3e} over "
          f"tolerance")
    ms, plain_ms = median_ms(kernel_fn), median_ms(plain_fn)
    print(f"  {label:58s} max|err| {max_err:.3e}  kernel {ms:8.4f} ms  "
          f"plain {plain_ms:8.4f} ms")
    return max_err, ms, plain_ms


def kernel_phase(card: str):
    import torch

    from ecamp_tpu_torch.kernels import flash_attention as fa
    from ecamp_tpu_torch.kernels import layer_norm as ln

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    main = {}
    print(f"kernels vs plain versions on {card} (median of {TIMING_REPS} "
          f"CUDA-event pairs around 10 calls each)")

    for rows, d, eps in ((64 * 197, 768, 1e-6), (8 * 256, 768, 1e-12)):
        x32 = torch.randn(rows, d, device=dev, generator=gen) * 2 + 0.5
        w = 1 + 0.1 * torch.randn(d, device=dev, generator=gen)
        b = 0.1 * torch.randn(d, device=dev, generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            r = compare(f"layer_norm ({rows}, {d}) eps {eps:g} {dtype}",
                        lambda: ln.fused_layer_norm(x, w, b, eps),
                        lambda: ln._ln_reference(x, w, b, eps), dtype)
            if (rows, dtype) == (64 * 197, torch.bfloat16):
                main["layer_norm"] = r

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
            r = compare(f"attention ({bsz}, {h}, {n}, {d}) bias {bias_kind} "
                        f"{dtype}",
                        lambda: fa.flash_attention(q, k, v, bias),
                        lambda: fa._attention_reference(q, k, v, bias), dtype)
            if ((bsz, n, d, bias_kind, dtype)
                    == (64, 197, 64, "none", torch.bfloat16)):
                main["attention"] = r
    torch.cuda.synchronize()
    return main


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
    from ecamp_tpu_torch.kernels import layer_norm as ln

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

    main_times = kernel_phase(card)
    launches, prob_err, p50 = slice_phase(card)

    kernels = []
    for name, mod, route, replaces in (
            ("layer_norm", ln, "triton",
             "ecamp_tpu/kernels/layer_norm.py:46"),
            ("attention", fa, "cuda",
             "ecamp_tpu/kernels/flash_attention.py:106")):
        err, ms, plain_ms = main_times[name]
        kernels.append({"name": name, "route": route, "source": mod.SOURCE,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(json.dumps({"serve_p50_ms": {str(b): v for b, v in p50.items()},
                      "max_prob_err": prob_err, "card": card}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
