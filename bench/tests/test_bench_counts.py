"""``counts.py`` against hand counts on a tiny shape."""

import pytest

import counts
import weights

DENSE = weights.sizes({"arch_type": "dense", "n_layers": 2, "d_model": 8,
                       "n_heads": 2, "n_kv_heads": 1, "head_dim": 4,
                       "d_ff": 16, "vocab": 10, "dtype": "bfloat16"})
SSM = weights.sizes({"arch_type": "ssm", "n_layers": 1, "d_model": 4,
                     "vocab": 6, "ssm_state": 2, "ssm_expand": 2,
                     "ssm_head_dim": 4, "ssm_conv": 3, "tie_embeddings": True,
                     "dtype": "bfloat16"})
HYBRID = weights.sizes({"arch_type": "hybrid", "n_layers": 5, "d_model": 4,
                        "n_heads": 2, "n_kv_heads": 2, "head_dim": 2,
                        "d_ff": 8, "vocab": 6, "ssm_state": 2,
                        "ssm_expand": 2, "ssm_head_dim": 4, "ssm_conv": 3,
                        "attn_every": 2, "dtype": "bfloat16"})


def test_matmul_params_by_hand():
    # per layer: q 8*8 + k,v 2*8*4 + o 8*8 + mlp 3*8*16; head 8*10
    assert counts.matmul_params(DENSE) == 2 * (64 + 64 + 64 + 384) + 80
    # in_proj 4*(2*8 + 2*2 + 2) + out_proj 8*4; tied head 4*6
    assert counts.matmul_params(SSM) == 4 * 22 + 32 + 24
    # 5 mamba layers, 2 shared-block calls (q,k,v,o 4*4 each + mlp 3*4*8)
    assert counts.matmul_params(HYBRID) == 5 * (88 + 32) + 2 * (64 + 96) + 24


def test_token_and_prefill_flops_by_hand():
    base = 2.0 * counts.matmul_params(DENSE)
    # attention at context 5: 4 * 5 * H 2 * hd 4 per layer, 2 layers
    assert counts.token_flops(DENSE, 5) == base + 4 * 5 * 2 * 4 * 2
    # prefill of 3 tokens: contexts 1 + 2 + 3
    assert counts.prefill_flops(DENSE, 3) == 3 * base + 4 * 2 * 4 * 2 * 6
    # SSD: 4 * d_inner 8 * N 2 + 2 * K 3 * conv 12 per layer
    assert counts.token_flops(SSM, 99) == 2.0 * counts.matmul_params(SSM) \
        + 64 + 72


def test_round_flops_counts_gamma_not_gamma_max():
    g = 3
    want = (g + 1) * counts.token_flops(DENSE, 10 + g / 2) \
        + g * counts.token_flops(DENSE, 10 + (g - 1) / 2)
    assert counts.round_flops(DENSE, DENSE, g, [10]) == pytest.approx(want)
    fused = counts.round_flops(DENSE, DENSE, 0, [10])
    assert fused == pytest.approx(counts.token_flops(DENSE, 10))


def test_attention_bytes_by_hand():
    # K,V of a position in a layer: 2 * Hkv 1 * hd 4 * 2 bytes = 16
    assert counts.kv_bytes_per_position(DENSE) == 16
    b, f = counts.attn_slot_round_cost(DENSE, DENSE, 10, 2, 3)
    # draft: 2 steps x 2 layers, 1 query; target: 2 layers, 3 queries
    q = 2 * 2 * 4 * 2      # q and output of one query: 2 * H * hd * bytes
    assert b == 4 * (10 * 16 + q) + 2 * (10 * 16 + 3 * q)
    assert f == 4 * 4.0 * 1 * 10 * 8 + 2 * 4.0 * 3 * 10 * 8
    # hybrid target: one verify (g + 1 queries) and `new` re-advance calls
    # per segment; an ssm draft has no attention
    b, f = counts.attn_slot_round_cost(HYBRID, SSM, 10, 2, 3)
    kv = 2 * 2 * 2 * 2
    q = 2 * 2 * 2 * 2
    assert b == 2 * (10 * kv + 3 * q) + 2 * 3 * (10 * kv + q)
    assert counts.attn_prefill_cost(DENSE, DENSE, 4)[0] == \
        2 * 2 * (4 * 16 + 4 * 2 * 4 * 2 * 2)


def test_ssd_and_bound():
    b, f = counts.ssd_launch_cost(SSM, 1, 3)
    # x (3 * nh 2 * hd 4) + B,C (2 * 3 * 2), bf16; dt f32; state in + out
    assert b == 3 * (2 * 8 + 4) * 2 + 3 * 2 * 4 + 2 * 2 * 4 * 2 * 4
    assert f == 2 * 9 * 2 + 2 * 9 * 8 + 4 * 3 * 8 * 2
    assert counts.ssd_slot_round_cost(SSM, 2) == counts.ssd_launch_cost(
        SSM, 1, 3)
    assert counts.bound_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert counts.bound_seconds(0, 989e12) == pytest.approx(1.0)
