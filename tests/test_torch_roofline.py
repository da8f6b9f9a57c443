"""The bound helper of `chip_smoke.py`: a kernel's shape -> its operations
and bytes -> the least time an H100 SXM could take for them, and which of
the two bounds it. Held against hand counts at the port's main shapes;
runs on the CPU (importing `chip_smoke` does no CUDA work)."""

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
    # fused CE backward: one logit recompute plus the dx and dW products
    "fused_ce_bwd": (chip_smoke.fused_ce_bwd_work(8192, 768, 30000, 2),
                     1_132_462_080_000, 117_696_896, 1.145058, "operations"),
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
