"""The bound helper of `chip_smoke.py`: a kernel's shape -> its operations
and bytes -> the least time an H100 SXM could take for them, and which of
the two bounds it. Held against hand counts at the port's main shapes;
runs on the CPU (importing `chip_smoke` does no CUDA work). Also the input
rotation its timings use, and the kernel groups of the step profile."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402

B = 32  # the pretraining batch


# (work, flops, bytes, bound ms, bound_by), counted by hand: each input
# read once and each output written once, bf16 on the tensor cores at
# 989 TFLOP/s, fp32 on the FMA pipe at 67 TFLOP/s, memory at 3.35 TB/s
CASES = {
    # BERT self-attention with its (B, 1, 1, 256) key-padding bias:
    # q, k, v, o of 32*6*256*128 bf16 (12.58 MB each) + 32 KB of bias;
    # 6.44 GFLOP -> 6.5 us, under the 15.0 us of the bytes
    "attention_bert": (chip_smoke.attention_work(B, 6, 256, 256, 128, 2,
                                                 B * 256),
                       6_442_450_944, 50_364_416, 0.015034, "bytes"),
    # 448-px serving: about 390 flops a byte, above the ridge (~295)
    "attention_785": (chip_smoke.attention_work(8, 12, 785, 785, 64, 2),
                      15_144_345_600, 38_584_320, 0.015313, "operations"),
    # LayerNorm (8192, 768) bf16: x in, y out, fp32 weight and bias
    "layer_norm": (chip_smoke.layer_norm_work(8192, 768, 2),
                   50_331_648, 25_171_968, 0.0075140, "bytes"),
    # SR conv stack (32, 3, 448, 448) bf16: 77.1 MB in and out
    "sr_conv_stack": (chip_smoke.sr_work(B, 448, 448, 2), 2_138_701_824,
                      77_070_336, 0.023006, "bytes"),
    # AdamW: 28 bytes a parameter (5.11 GB) over 182,582,488 fp32 params
    "adamw": (chip_smoke.adamw_work(182_582_488), 2_738_737_320,
              5_112_309_664, 1.52606, "bytes"),
    # fused CE forward (8192, 768, 30000) bf16: 0.377 TFLOP of logits
    "fused_ce_fwd": (chip_smoke.fused_ce_fwd_work(8192, 768, 30000, 2),
                     377_487_360_000, 58_913_984, 0.381686, "operations"),
    # its tile kernel: the same product, and the fp32 (max, sum-exp) of
    # 235 tiles x 8192 rows (15.4 MB) and the gold written
    "fused_ce_fwd_tiles": (chip_smoke.fused_ce_fwd_tiles_work(
        8192, 768, 30000, 2, 235), 377_487_360_000, 74_282_176, 0.381686,
        "operations"),
    # its merge: the 15.4 MB of stats and the labels read, lse and gold
    # written; about 4 fp32 flops a tile and row
    "fused_ce_fwd_merge": (chip_smoke.fused_ce_fwd_merge_work(8192, 235),
                           7_700_480, 15_532_032, 0.0046364, "bytes"),
    # fused CE backward: one logit recompute plus the dx and dW products
    "fused_ce_bwd": (chip_smoke.fused_ce_bwd_work(8192, 768, 30000, 2),
                     1_132_462_080_000, 117_696_896, 1.145058, "operations"),
    # int8-weight linear, fc1 at bucket 8 (M = 1576): bf16 x, int8 q, fp32
    # scales, bf16 bias in, bf16 y out; 7.4 GFLOP -> 7.5 us over 4.3 us
    "int8_linear_fc1_b8": (chip_smoke.int8_linear_work(1576, 3072, 768),
                           7_436_500_992, 14_481_408, 0.0075192,
                           "operations"),
    # qkv at one image (M = 197): the 1.77 MB of int8 weight dominate
    "int8_linear_qkv_b1": (chip_smoke.int8_linear_work(197, 2304, 768),
                           697_171_968, 2_993_664, 0.00089363, "bytes"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_bound_of_each_kernel_at_its_main_shape(name):
    work, flops, nbytes, ms, by = CASES[name]
    assert work[:2] == (flops, nbytes)
    bound_ms, bound_by = chip_smoke.bound(work)
    assert bound_by == by
    assert bound_ms == pytest.approx(ms, rel=1e-4)


def test_bound_takes_the_larger_time_and_the_peak_of_the_type():
    # 1 GFLOP on 1 MB: operations; the same on 1 GB: bytes
    assert chip_smoke.bound((1e9, 1e6, "bf16")) == pytest.approx(
        (1e9 / 989e12 * 1e3, "operations"))
    assert chip_smoke.bound((1e9, 1e9, "bf16")) == pytest.approx(
        (1e9 / 3.35e12 * 1e3, "bytes"))
    # fp32 runs on the FMA pipe, about 15x slower than bf16 tensor cores
    fp32_ms, _ = chip_smoke.bound(chip_smoke.attention_work(
        B, 6, 256, 256, 128, 4, B * 256))
    assert fp32_ms == pytest.approx(6_442_450_944 / 67e12 * 1e3)
    # the key-padding bias is read at its stored size, not broadcast
    with_bias = chip_smoke.attention_work(2, 3, 10, 20, 32, 2, 2 * 20)
    without = chip_smoke.attention_work(2, 3, 10, 20, 32, 2)
    assert with_bias[1] - without[1] == 4 * 2 * 20


def test_rotated_copies_hold_twice_the_l2_and_take_turns():
    """A timed call's inputs rotate over copies (twice the 50 MB L2
    together; the first copy is the inputs themselves, non-tensors are
    shared), one copy a call, in turn."""
    import torch

    x = torch.zeros(10 * 2 ** 20)  # 40 MiB of fp32
    seen = []
    call = chip_smoke.rotated(lambda t, eps: seen.append((t.data_ptr(), eps)),
                              (x, 1e-6))
    assert call.copies == 3  # 120 MiB >= 100 MiB
    for _ in range(2 * call.copies):
        call()
    ptrs = [p for p, _ in seen]
    assert ptrs[0] == x.data_ptr() and len(set(ptrs)) == 3
    assert ptrs[:3] == ptrs[3:] and {e for _, e in seen} == {1e-6}
    big = torch.zeros(30 * 2 ** 20)  # 120 MiB: no copy needed
    assert chip_smoke.rotated(lambda t: None, (big,)).copies == 1


def test_profile_groups_hold_every_kernel_of_the_port():
    """`train/profile_step.py` puts each of the port's kernels in its
    group by name, the two-kernel fused-CE forward, the TMA + wgmma
    attention, the TMA SR forward and the int8-weight linear included (a
    name of it holding "gemm" stays out of the GEMM group)."""
    from ecamp_tpu_torch.train.profile_step import group_of

    for name, group in (
            ("void attention_fwd_wgmma_kernel<64, 1>(CUtensorMap_st, ...)",
             "attention kernel"),
            ("void attention_fwd_kernel<float, 64>(...)", "attention kernel"),
            ("ln_fwd_kernel", "layer_norm kernel"),
            ("ln_fwd_vec_kernel", "layer_norm kernel"),
            ("sr_conv_stack_kernel", "sr_conv_stack kernel"),
            ("sr_conv_stack_tma_kernel", "sr_conv_stack kernel"),
            ("adamw_multi_kernel", "adamw kernel"),
            ("fused_ce_fwd_tiles_kernel(CUtensorMap_st, ...)",
             "fused CE kernels"),
            ("fused_ce_fwd_merge_kernel(float2 const*, ...)",
             "fused CE kernels"),
            ("void fused_ce_fwd_kernel<float>(...)", "fused CE kernels"),
            ("fused_ce_bwd_dl_kernel", "fused CE kernels"),
            ("void (anonymous namespace)::int8_linear_kernel<128, 128>(...)",
             "int8 linear kernel"),
            ("int8_linear_kernel<64, 64>", "int8 linear kernel"),
            ("int8_linear_gemm", "int8 linear kernel"),
            ("sm90_xmma_gemm_bf16bf16", "gemm")):
        assert group_of(name) == group, name


def test_compare_retimes_a_profiler_time_under_the_bound(monkeypatch):
    """`compare` takes a profiler reading under the bound (a session that
    kept part of its kernels) for none: it times the kernel and its
    library call again by queued CUDA events and says so in BY_EVENTS;
    readings at or over the bound stand. The card's timers are stubbed."""
    import torch

    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(chip_smoke, "median_ms", lambda fn, *a: 1.0)
    monkeypatch.setattr(chip_smoke, "queued_ms",
                        lambda fn, *a: calls.append(fn) or 0.5)
    monkeypatch.setattr(chip_smoke, "BY_EVENTS", [])
    work = chip_smoke.int8_linear_work(1576, 3072, 768)  # 0.0075 ms
    x = torch.ones(4)
    for lib_ms, retimed in ((0.0139, False), (0.0010, True)):
        times = iter([0.0574, lib_ms])
        monkeypatch.setattr(chip_smoke, "device_ms",
                            lambda fn, *a, **k: next(times))
        calls.clear()
        r = chip_smoke.compare("k", lambda: x, lambda: x, torch.float32,
                               library_fn=lambda: x, match="k", work=work)
        assert (r["device_ms"], r["library_device_ms"]) == (
            (0.5, 0.5) if retimed else (0.0574, lib_ms))
        assert r["device_by"] == ("queued events" if retimed
                                  else "profiler")
        assert len(calls) == 2 * retimed
    assert chip_smoke.BY_EVENTS == ["k", "library k"]
