"""``bench/counts.py``, with stablelm-3b's reference module's counts,
against counts made by hand, at two shapes."""
import json

import pytest

from bench import counts, harness

CONF = json.loads((harness.BENCH / "configs" / "stablelm-3b.json")
                  .read_text())
M, REF = harness.port_config(CONF), harness.reference_of(CONF)


def test_matmul_params_by_hand():
    # per layer: q, k, v, o 4 x 2560 x 2560; gate, in, out 3 x 2560 x 6912;
    # 32 layers, and the head 2560 x 50304 (the real vocabulary)
    per_layer = 4 * 2560 * 2560 + 3 * 2560 * 6912
    assert per_layer == 79_298_560
    assert REF.matmul_params(M) == 32 * per_layer + 2560 * 50304 \
        == 2_666_332_160


def test_train_flops_8x1024_with_the_attention_term():
    # causal pairs 1024 * 1025 / 2 = 524,800; Q K^T and P V, 2 FLOPs a
    # multiply-add: 4 * B * H * hd * pairs * layers
    attn = 4 * 8 * 32 * 80 * 524_800 * 32
    assert attn == 1_375_731_712_000
    assert REF.attention_fwd_flops(M, 8, 1024) == attn
    assert counts.train_flops(REF, M, 8, 1024) == 131_055_558_328_320 + 3 * attn \
        == 135_182_753_464_320


def test_forward_flops_1x2048():
    attn = 4 * 1 * 32 * 80 * (2048 * 2049 // 2) * 32
    assert attn == 687_530_311_680
    assert counts.forward_flops(REF, M, 1, 2048) == 2 * 2_666_332_160 * 2048 \
        + attn == 11_608_826_839_040


@pytest.mark.parametrize("b, s, flops, nbytes, bound", [
    (8, 1024, 42_991_616_000, 167_772_160, 167_772_160 / 3.35e12),
    (1, 2048, 4 * 32 * 80 * 2_098_176, 128 * 2048 * 80 * 2,
     4 * 32 * 80 * 2_098_176 / 989e12),
])
def test_flash_forward_work_and_bound(b, s, flops, nbytes, bound):
    f, n = counts.flash_fwd_work(b, s, 32, 32, 80)
    assert (f, n) == (flops, nbytes)
    assert counts.bound_s(f, n) == pytest.approx(bound, rel=1e-12)
