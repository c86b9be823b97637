"""The yardstick's counts against hand counts."""

import json
import os

import pytest

from gpubench import roofline

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def config(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return json.load(f)


def test_gemm_layer_of_granite_3_2b_at_8192_tokens():
    # q, o: 2*8192*2048*2048 each; k, v: 2*8192*512*2048 each;
    # gate, up: 2*8192*8192*2048 each; down: 2*8192*2048*8192
    hand = (2 * 68_719_476_736 + 2 * 17_179_869_184 + 2 * 274_877_906_944
            + 274_877_906_944)
    assert roofline.layer_gemm_flops(config("granite-3-2b"), 8192) == hand
    assert hand / 1e9 == pytest.approx(996.4, abs=0.05)


def test_flash_call_of_granite_34b_counts_the_causal_pairs():
    cfg = config("granite-34b")
    flops = roofline.flash_flops(cfg["num_attention_heads"], 8192,
                                 cfg["head_dim"])
    assert flops == 4 * 128 * 48 * (8192 * 8193 // 2)
    assert flops / 1e9 == pytest.approx(824.7, abs=0.05)


def test_train_step_of_granite_3_2b():
    cfg = config("granite-3-2b")
    layer = (2048 * 2048 * 2 + 2 * 2048 * 512 + 3 * 2048 * 8192)
    params = 40 * layer + 2048 * 49155          # the tied head's product
    attn = 3 * 4 * 32 * 64 * 8 * (256 * 257 // 2) * 40
    flops = roofline.train_step_flops(cfg, 8, 256)
    assert flops == 6 * params * 2048 + attn
    assert flops / 1e12 == pytest.approx(31.39, abs=0.005)
    # attention counted over all S^2 pairs, as a count of what the eager
    # step computes would have it: 31.65 TFLOP
    full = 6 * params * 2048 + 3 * 4 * 32 * 64 * 8 * 256 * 256 * 40
    assert full / 1e12 == pytest.approx(31.65, abs=0.005)


@pytest.mark.parametrize("flops,nbytes,by", [
    (2 * 8192 * 512 * 2048, 2 * (8192 * 2048 + 2048 * 512 + 8192 * 512),
     "operations"),
    (1e6, 1e9, "bytes")])
def test_bound_is_the_larger_of_operations_and_bytes(flops, nbytes, by):
    t_ops = flops / roofline.PEAK_BF16_FLOPS
    t_bytes = nbytes / roofline.PEAK_HBM_BYTES
    assert roofline.bound_s(flops, nbytes) == max(t_ops, t_bytes)
    assert (t_ops >= t_bytes) == (by == "operations")


def test_gelu_configuration_has_no_gate():
    names = [p[0] for p in roofline.dense_products(config("granite-34b"))]
    assert names == ["q", "k", "v", "o", "up", "down"]
