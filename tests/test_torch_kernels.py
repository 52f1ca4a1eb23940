"""The port's decode-attention kernels (B1 dense, B2 paged), CPU side: the
plain PyTorch versions the wrappers run for CPU tensors, held against the
reference's Pallas kernels in interpret mode and its jnp oracle on the same
numpy inputs. (The CUDA kernels themselves are held against these plain
versions on the card by ``chip_smoke.py``.)

Tolerance: atol/rtol 1e-5 — float32 on both sides, differing only in the
order of the dot-product and softmax sums."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attn import (decode_attention,
                                       decode_attention_reference,
                                       paged_decode_attention)
from repro_torch.kernels.decode_attn import (
    decode_attention as t_decode_attention,
    decode_attn_call, paged_decode_attention as t_paged)

TOL = dict(atol=1e-5, rtol=1e-5)


def _pos_maps(rng, B, S, T, ring, empty_row):
    pos = rng.integers(S // 2, S - T, B)
    if ring:
        pm = np.stack([(np.arange(S) + (p // S) * S) for p in pos])
        pm = np.where(pm <= pos[:, None], pm, pm - S)
        pm = np.where(pm >= 0, pm, -1)
    else:
        pm = np.stack([np.where(np.arange(S) < p, np.arange(S), -1)
                       for p in pos])
        # stale speculative entries past the committed position + holes
        pm[:, -3:] = pos[:, None] + 5
        pm[:, 1] = -1
    if empty_row:
        pm[0] = -1
    q_pos = np.stack([p + np.arange(T) for p in pos]).astype(np.int32)
    return pm.astype(np.int32), q_pos


@pytest.mark.parametrize(
    "B,T,H,Hkv,hd,S,window,ring,empty_row",
    [(2, 1, 8, 2, 16, 40, 0, False, False),
     (2, 5, 8, 8, 16, 40, 0, False, True),
     (1, 4, 8, 2, 32, 64, 16, False, False),
     (3, 1, 4, 1, 16, 32, 8, True, False),
     (2, 9, 6, 2, 16, 50, 0, False, True)])
def test_decode_attn_plain_matches_pallas(B, T, H, Hkv, hd, S, window, ring,
                                          empty_row):
    rng = np.random.default_rng(B + T + S)
    q = rng.normal(size=(B, T, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, hd)).astype(np.float32)
    pm, q_pos = _pos_maps(rng, B, S, T, ring, empty_row)
    jargs = [jnp.asarray(a) for a in (q, k, v, pm, q_pos)]
    pallas = np.asarray(decode_attention(*jargs, window, interpret=True))
    oracle = np.asarray(decode_attention_reference(*jargs, window))
    out = t_decode_attention(*[torch.from_numpy(a) for a in
                               (q, k, v, pm, q_pos)], window).numpy()
    np.testing.assert_allclose(out, pallas, **TOL)
    np.testing.assert_allclose(out, oracle, **TOL)
    if empty_row:
        assert (out[0] == 0.0).all()


def test_decode_attn_wrapper_keeps_dtype_and_layout():
    """The grouped-layout wrapper returns q's dtype and shape on the CPU."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.normal(size=(2, 3, 2, 4, 16))).to(torch.bfloat16)
    k = torch.from_numpy(rng.normal(size=(2, 20, 2, 16))).to(torch.bfloat16)
    pm = torch.arange(20, dtype=torch.int32).expand(2, 20).contiguous()
    qp = torch.full((2, 3), 19, dtype=torch.int32)
    out = decode_attn_call(q, k, k, pm, qp)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape


def _paged_inputs(rng, quant, B=2, T=3, Hkv=2, G=3, hd=16, NB=12, bs=4,
                  n_log=5, length=18):
    q = rng.normal(size=(B, T, Hkv, G, hd)).astype(np.float32)
    if quant:
        k = rng.integers(-127, 128, size=(NB, bs, Hkv, hd)).astype(np.int8)
        v = rng.integers(-127, 128, size=(NB, bs, Hkv, hd)).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, size=(NB, bs, Hkv)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, size=(NB, bs, Hkv)).astype(np.float32)
    else:
        k = rng.normal(size=(NB, bs, Hkv, hd)).astype(np.float32)
        v = rng.normal(size=(NB, bs, Hkv, hd)).astype(np.float32)
        ks = vs = None
    perm = rng.permutation(NB)
    table = perm[:B * n_log].reshape(B, n_log).astype(np.int32)
    table[0, 2] = -1                        # an unmapped block mid-slot
    table[1, -1] = -1                       # an unreserved tail
    pm = rng.integers(-1, 25, size=(NB, bs)).astype(np.int32)
    q_pos = (np.array([[14], [17]]) + np.arange(T)[None, :]).astype(np.int32)
    return q, k, v, ks, vs, pm, table, q_pos, length


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [0, 6])
def test_paged_plain_matches_pallas(quant, window):
    rng = np.random.default_rng(7 + quant)
    q, k, v, ks, vs, pm, table, q_pos, length = _paged_inputs(rng, quant)
    j = lambda a: None if a is None else jnp.asarray(a)
    ref = np.asarray(paged_decode_attention(
        j(q), j(k), j(v), j(ks), j(vs), j(pm), j(table), j(q_pos),
        length=length, window=window, interpret=True))
    t = lambda a: None if a is None else torch.from_numpy(a)
    out = t_paged(t(q), t(k), t(v), t(ks), t(vs), t(pm), t(table), t(q_pos),
                  length, window).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
