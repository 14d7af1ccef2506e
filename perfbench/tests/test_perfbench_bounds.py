"""The frozen yardstick reproduces the bounds PERF.md's kernel table was
read against, and the FLOP counts behind the mfu metrics are the ones
worked by hand."""

import pytest

from perfbench import bounds, flops


def test_flash_bound_at_the_8b_training_shape():
    # (1, 2048, 32, 8, 128) bf16, padded 37 left and 301 right: the real
    # run's causal pairs plus those of the pads, one segment of 338
    s, pad_l, pad_r = 2048, 37, 301
    real = s - pad_l - pad_r
    pads = pad_l + pad_r
    pairs = real * (real + 1) // 2 + pads * (pads + 1) // 2
    assert pairs == 1_520_196
    fwd, by = bounds.flash_bound((1, s, 32, 8, 128), "bfloat16", pairs,
                                 False)
    bwd, _ = bounds.flash_bound((1, s, 32, 8, 128), "bfloat16", pairs, True)
    assert by == "operations"
    assert fwd * 1e3 == pytest.approx(29.54, abs=0.005)
    assert bwd * 1e3 == pytest.approx(67.32, abs=0.005)


def test_attention_bound_at_the_sampler_shape_in_f32():
    ms, by = bounds.attention_bound(16, 50, 16, 64, "float32", True)
    assert by == "bytes"
    assert ms * 1e3 == pytest.approx(3.913, abs=0.0005)


def test_flash_pairs_of_a_right_padded_batch():
    # width 8, rows of 5 and 8 real tokens: 15 + 6 pad pairs, 36
    assert bounds.flash_pairs([5, 8], 8) == 15 + 6 + 36


def test_llm_flops_by_hand():
    llm = {"hidden_size": 64, "num_heads": 4, "num_layers": 2}
    # 2 N a token
    assert flops.llm_tokens(1000, 3) == 6000
    # 4 d a pair, head and layer forward; 12 d with input gradients
    assert flops.attention(llm, 10) == 4 * 16 * 4 * 2 * 10
    assert flops.attention(llm, 10, backward=True) == 12 * 16 * 4 * 2 * 10
    assert flops.causal_pairs(4) == 10


def test_denoiser_and_gin_flops_by_hand():
    dit = {"hidden_size": 8, "max_n_nodes": 2, "Edim": 5, "mlp_ratio": 4.0,
           "text_dim": 3, "depth": 1}
    h, n, in_dim, mlp = 8, 2, 1 + 2 * 5, 32
    block = (2 * n * (4 * h * h + 2 * mlp * h) + 2 * 7 * h * h
             + 4 * h * n * n)
    embed = 2 * n * in_dim * h + 2 * (256 * h + h * h) + 2 * 3 * h
    out = 2 * n * (h * h + h * in_dim) + 2 * (h * h + 2 * in_dim * h)
    assert flops.denoiser(dit, 1) == block + embed + out
    assert flops.gin(2, 3, 4) == 2 * 2 * 4 * (3 * 12 + 12 * 3)
