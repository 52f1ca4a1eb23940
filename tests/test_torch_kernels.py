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


# ---- the split plan and the split-and-combine plain version (B1/B2's
# CUDA design, computed in PyTorch): held at atol/rtol 1e-5 in float32
# against the single-pass plain version and the reference's Pallas kernels
# in interpret mode

from repro_torch.kernels.decode_attn import (  # noqa: E402
    SPLIT_KEYS, WIDE_KV, decode_attention_grouped, decode_attention_split,
    paged_decode_attention_split, split_bounds, split_plan)


@pytest.mark.parametrize("hd,dtype,n_kv,bs", [
    (128, torch.bfloat16, 2, None), (64, torch.bfloat16, 32, None),
    (128, torch.float32, 8, None), (128, torch.bfloat16, 8, 16),
    (128, torch.int8, 2, 48), (64, torch.float32, 4, 7)])
def test_split_plan_depends_on_key_index_only(hd, dtype, n_kv, bs):
    split, _ = split_plan(1, hd, dtype, n_kv, bs)
    base = SPLIT_KEYS[(hd, dtype)] * (2 if n_kv >= WIDE_KV else 1)
    assert split >= min(base, 1024)
    if bs is not None:
        assert split % bs == 0 and split - min(base, 1024) < bs
    prev = None
    for n_keys in (0, 1, split - 1, split, split + 1, 3 * split + 5,
                   8 * split):
        sp, n = split_plan(n_keys, hd, dtype, n_kv, bs)
        assert sp == split                      # not a function of n_keys
        bounds = split_bounds(n_keys, sp)
        assert len(bounds) == n == max(1, -(-n_keys // sp))
        assert all(a % sp == 0 for a, _ in bounds)
        assert bounds[0][0] == 0 and bounds[-1][1] == n_keys
        assert all(b0[1] == b1[0] for b0, b1 in zip(bounds, bounds[1:]))
        if n_keys <= sp:
            assert n == 1
        if prev is not None:
            # a longer cache keeps every earlier split start
            assert [a for a, _ in bounds[:len(prev)]] == [a for a, _ in prev]
        prev = bounds


@pytest.mark.parametrize(
    "B,T,H,Hkv,hd,S,window,ring,empty_row,split,dead",
    [(2, 1, 8, 2, 16, 40, 0, False, False, 8, None),
     (2, 5, 8, 8, 16, 40, 0, False, True, 16, (16, 32)),
     (1, 4, 8, 2, 32, 64, 16, False, False, 16, None),
     (3, 1, 4, 1, 16, 32, 8, True, False, 8, None),
     (2, 9, 6, 2, 16, 48, 0, False, True, 8, (8, 24)),
     (2, 3, 4, 2, 16, 24, 0, False, False, 64, None)])
def test_split_plain_matches_pallas(B, T, H, Hkv, hd, S, window, ring,
                                    empty_row, split, dead):
    """Splits of ``split`` keys (S a multiple of 8, the Pallas s_tile), some
    wholly masked (``dead``), an empty row, ring caches, a sliding window,
    and one case with a single split."""
    rng = np.random.default_rng(100 + B + T + S)
    q = rng.normal(size=(B, T, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, hd)).astype(np.float32)
    pm, q_pos = _pos_maps(rng, B, S, T, ring, empty_row)
    if dead is not None:
        pm[:, dead[0]:dead[1]] = -1
    jargs = [jnp.asarray(a) for a in (q, k, v, pm, q_pos)]
    pallas = np.asarray(decode_attention(*jargs, window, s_tile=8,
                                         interpret=True)).reshape(
        B, T, Hkv, H // Hkv, hd)
    tq = torch.from_numpy(q).reshape(B, T, Hkv, H // Hkv, hd)
    targs = [torch.from_numpy(a) for a in (k, v, pm, q_pos)]
    out = decode_attention_split(tq, *targs, split, window).numpy()
    plain = decode_attention_grouped(tq, *targs, window).numpy()
    np.testing.assert_allclose(out, pallas, **TOL)
    np.testing.assert_allclose(out, plain, **TOL)
    if empty_row:
        assert (out[0] == 0.0).all()


@pytest.mark.parametrize("base", [[5, 13], [12, 0]])
def test_split_plain_tree_mask_across_split(base):
    """A tree region [base, base + Wn) that crosses a split boundary (8):
    the bitmap replaces the position rule inside it, on both sides."""
    rng = np.random.default_rng(3)
    B, T, Hkv, G, hd, S, Wn = 2, 5, 2, 3, 16, 32, 7
    q = torch.from_numpy(rng.normal(size=(B, T, Hkv, G, hd))
                         .astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(B, S, Hkv, hd)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(B, S, Hkv, hd)).astype(np.float32))
    wb = torch.tensor(base, dtype=torch.int32)
    pm = torch.where(torch.arange(S)[None, :] < wb[:, None].long(),
                     torch.arange(S)[None, :], torch.full((B, S), -1))
    pm = pm.to(torch.int32)
    pm[:, 20:] = 99                          # stale past the region
    mask = torch.from_numpy(np.tril(rng.random((T, Wn)) < 0.6))
    mask[:, 0] = True
    q_pos = (wb[:, None] + torch.arange(T)[None, :]).to(torch.int32)
    out = decode_attention_split(q, k, v, pm, q_pos, 8, 0, win_mask=mask,
                                 win_base=wb)
    plain = decode_attention_grouped(q, k, v, pm, q_pos, 0, mask, wb)
    np.testing.assert_allclose(out.numpy(), plain.numpy(), **TOL)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [0, 6])
def test_paged_split_plain_matches_pallas(quant, window):
    """B2's split version (splits of two 4-key blocks, unmapped blocks, an
    unreserved tail, int8 with the scales folded) against the reference's
    paged Pallas kernel in interpret mode and the gather-then-attend plain
    version."""
    rng = np.random.default_rng(11 + quant)
    q, k, v, ks, vs, pm, table, q_pos, length = _paged_inputs(rng, quant)
    j = lambda a: None if a is None else jnp.asarray(a)
    ref = np.asarray(paged_decode_attention(
        j(q), j(k), j(v), j(ks), j(vs), j(pm), j(table), j(q_pos),
        length=length, window=window, interpret=True))
    t = lambda a: None if a is None else torch.from_numpy(a)
    args = (t(q), t(k), t(v), t(ks), t(vs), t(pm), t(table), t(q_pos))
    out = paged_decode_attention_split(*args, length, window,
                                       split=8).numpy()
    plain = t_paged(*args, length, window).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(out, plain, **TOL)


def test_split_plain_rounds_p_in_bf16():
    """In bf16 the split version rounds P to bf16 before P·V (as the
    kernel and the reference's ``_attend_cached`` do): within bf16
    tolerance of the f32-P plain version, and not equal to it."""
    rng = np.random.default_rng(5)
    B, T, Hkv, G, hd, S = 2, 3, 2, 4, 32, 70
    q = torch.from_numpy(rng.normal(size=(B, T, Hkv, G, hd))).bfloat16()
    k = torch.from_numpy(rng.normal(size=(B, S, Hkv, hd))).bfloat16()
    v = torch.from_numpy(rng.normal(size=(B, S, Hkv, hd))).bfloat16()
    pm = torch.arange(S, dtype=torch.int32).expand(B, S).contiguous()
    qp = torch.full((B, T), S - 1, dtype=torch.int32)
    out = decode_attention_split(q, k, v, pm, qp, 32)
    plain = decode_attention_grouped(q, k, v, pm, qp)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), plain.float(), atol=2e-2,
                               rtol=2e-2)
    assert not torch.equal(out, plain)
