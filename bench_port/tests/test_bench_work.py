"""work.py's counts against hand counts at one shape."""

import pytest

from bench_port import work
from bench_port.tests import tiny


def test_causal_pairs():
    assert work.causal_pairs(4, 4, True) == 10
    assert work.causal_pairs(4, 4, False) == 16
    assert work.causal_pairs(6, 4, True) == 10 + 2 * 4  # top-left aligned


def test_attention_kernel_by_hand():
    # b 1, s 4, h 2, d 8, causal bf16: 10 kept pairs a head
    fwd = work.attention_kernel("fwd", 1, 4, 4, 2, 8, True)
    assert fwd["flops"] == 2 * 8 * 2 * 1 * 2 * 10
    q = 1 * 4 * 2 * 8 * 2
    assert fwd["bytes"] == 2 * q + 2 * q + 1 * 2 * 4 * 4
    dkdv = work.attention_kernel("dkdv", 1, 4, 4, 2, 8, True)
    assert dkdv["flops"] == 2 * 8 * 4 * 1 * 2 * 10
    big = work.attention_kernel("fwd", 4, 4096, 4096, 32, 128, True)
    assert big["bound_by"] == "operations"
    assert big["bound_s"] == pytest.approx(big["flops"] / 989e12)


def test_decoder_flops_by_hand():
    conf = dict(tiny.DECODER)
    conf.update(tie_word_embeddings=False)
    h, i, v, n = 64, 128, 256, 2
    per_layer = h * 64 + 2 * h * 32 + 64 * h + 3 * h * i  # q, k+v, o, mlp
    assert work.decoder_layer_matmul_params(conf) == per_layer
    b, s = 2, 32
    attention = n * 4 * b * 4 * 16 * (s * (s + 1) // 2)
    assert work.decoder_train_flops(conf, b, s) == \
        6 * (n * per_layer + h * v) * b * s + 3 * attention
    assert work.decoder_score_flops(conf, s) == \
        2 * n * per_layer * s + attention // b + 2 * h * v

