"""The port's dense model path (layers, KV caches, attention, model steps),
held against the JAX reference on the same numpy inputs and bridged
weights. Tiny configs in float32: d_model 64, 2 layers, 4 heads / 2 kv
heads, hd 16, vocab 128; the target has qk_norm (like qwen3), the draft
qkv bias (like qwen2.5). Norm scales and biases are perturbed away from
their zero init so their code paths count.

Tolerances: layers and attention atol/rtol 1e-5 (float32, sum order only);
model logits atol/rtol 1e-4 (two layers of matmuls in another order), with
equal argmax. Cache writes and block bookkeeping are exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JCfg
from repro.models import kvcache as jkv
from repro.models import layers as jl
from repro.models.attention import (attention_decode as j_attn,
                                    attention_decode_paged as j_attn_paged)
from repro.models.model import Model as JModel
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import ModelConfig as TCfg
from repro_torch.models import kvcache as tkv
from repro_torch.models import layers as tl
from repro_torch.models.attention import (attention_decode as t_attn,
                                          attention_decode_paged as
                                          t_attn_paged)
from repro_torch.models.model import Model as TModel

TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
CFG = dict(arch_type="dense", n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=2, d_ff=128, vocab=128, head_dim=16, dtype="float32",
           remat=False)
KINDS = {"target": dict(name="tiny-target", qk_norm=True),
         "draft": dict(name="tiny-draft", qkv_bias=True)}


def cfgs(kind):
    return JCfg(**CFG, **KINDS[kind]), TCfg(**CFG, **KINDS[kind])


def perturbed_params(jcfg, seed):
    p = jax.device_get(JModel(jcfg).init_params(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def walk(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v)
            elif k in ("ln1", "ln2", "final_norm", "bq", "bk", "bv",
                       "q_norm", "k_norm"):
                tree[k] = (v + 0.1 * rng.normal(size=v.shape)).astype(v.dtype)
    walk(p)
    return p


t = torch.from_numpy
j = jnp.asarray


# ------------------------------------------------------------------ layers

def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    pos = rng.integers(0, 300, size=(2, 5)).astype(np.int32)
    np.testing.assert_allclose(tl.rms_norm(t(x), t(scale), 1e-6).numpy(),
                               np.asarray(jl.rms_norm(j(x), j(scale), 1e-6)),
                               **TOL)
    np.testing.assert_allclose(
        tl.apply_rope(t(x), t(pos), 1e6).numpy(),
        np.asarray(jl.apply_rope(j(x), j(pos), 1e6)), **TOL)
    h = rng.normal(size=(3, 7, 32)).astype(np.float32)
    w = [rng.normal(size=s).astype(np.float32) * 0.2
         for s in ((32, 48), (32, 48), (48, 32))]
    np.testing.assert_allclose(
        tl.swiglu(t(h), *map(t, w)).numpy(),
        np.asarray(jl.swiglu(j(h), *map(j, w))), **TOL)


# ------------------------------------------------------------- dense cache

B, T, HKV, HD = 2, 3, 2, 8


@pytest.mark.parametrize("case", ["append", "ring", "overflow"])
def test_dense_cache_writes_match(case):
    """Per-sequence window writes, ring wrap, and drop-on-overflow (row 0
    straddles the edge, row 1 lies past it — the clamp victim keeps its
    value), all equal to the reference scatter."""
    rng = np.random.default_rng(1)
    S = 8
    ring = case == "ring"
    jk = jnp.zeros((B, S, HKV, HD)).at[:, S - 1].set(7.0)
    jv = jnp.zeros_like(jk)
    jpm = jnp.full((B, S), -1, jnp.int32)
    cache = tkv.init_attn_cache(1, B, S, HKV, HD, torch.float32, "cpu")
    cache.k_buf[0, :B, S - 1] = 7.0
    pos_seq = {"append": [[0, 2], [3, 5]], "ring": [[5, 6], [8, 9]],
               "overflow": [[S - 1, S + 2]]}[case]
    for pos in pos_seq:
        kn = rng.normal(size=(B, T, HKV, HD)).astype(np.float32)
        vn = rng.normal(size=(B, T, HKV, HD)).astype(np.float32)
        p = np.asarray(pos, np.int32)
        jk, jv, jpm = jkv.update_layer_cache(jk, jv, jpm, j(kn), j(vn), j(p),
                                             ring)
        tkv.update_layer_cache(cache.k_buf[0], cache.v_buf[0],
                               cache.pm_buf[0], t(kn), t(vn), t(p), ring)
    np.testing.assert_array_equal(cache.k[0].numpy(), np.asarray(jk))
    np.testing.assert_array_equal(cache.v[0].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(cache.pos_map[0].numpy(), np.asarray(jpm))


def test_insert_and_reset_slot():
    src = tkv.init_attn_cache(2, 1, 6, HKV, HD, torch.float32, "cpu")
    src.k_buf.fill_(3.0)
    src.pm_buf[:, 0] = torch.arange(6, dtype=torch.int32)
    dst = tkv.init_attn_cache(2, 3, 6, HKV, HD, torch.float32, "cpu")
    tkv.insert_slot(dst, src, torch.tensor([1]))
    assert (dst.k[:, 1] == 3.0).all() and (dst.k[:, [0, 2]] == 0).all()
    assert (dst.pos_map[:, 1] == torch.arange(6)).all()
    tkv.reset_slot(dst, 1)
    assert (dst.k == 0).all() and (dst.pos_map == -1).all()


# ------------------------------------------------------------- paged cache

@pytest.mark.parametrize("quant", [False, True])
def test_paged_writes_and_gather_match(quant):
    """Writes through a block table with an unmapped block and a window
    running past ``length`` (dropped), then the position-ordered gather,
    equal to the reference (int8 pools: codes and scales exactly)."""
    rng = np.random.default_rng(2 + quant)
    length, bs, NB = 18, 4, 16
    n_log = jkv.logical_blocks(length, bs)
    table = rng.permutation(NB)[:B * n_log].reshape(B, n_log).astype(np.int32)
    table[0, 1] = -1
    jpool = jkv.init_paged_attn_cache(1, B, length, NB, bs, HKV, HD,
                                      jnp.float32, quantize=quant)
    tpool = tkv.init_paged_attn_cache(1, B, length, NB, bs, HKV, HD,
                                      torch.float32, "cpu", quantize=quant)
    jk, jv, jks, jvs, jpm = (jpool.k[0], jpool.v[0], None, None,
                             jpool.pos_map[0])
    if quant:
        jks, jvs = jpool.k_scale[0], jpool.v_scale[0]
    for pos in ([0, 2], [3, 5], [6, 8], [16, 17]):
        kn = rng.normal(size=(B, T, HKV, HD)).astype(np.float32)
        vn = rng.normal(size=(B, T, HKV, HD)).astype(np.float32)
        p = np.asarray(pos, np.int32)
        jk, jv, jks, jvs, jpm = jkv.paged_update_layer(
            jk, jv, jks, jvs, jpm, j(table), j(kn), j(vn), j(p), False,
            length)
        tkv.paged_update_layer(
            tpool.k_buf[0], tpool.v_buf[0],
            tpool.ks_buf[0] if quant else None,
            tpool.vs_buf[0] if quant else None, tpool.pm_buf[0], t(table),
            t(kn), t(vn), t(p), False, length)
    np.testing.assert_array_equal(tpool.k[0].numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tpool.pos_map[0].numpy(), np.asarray(jpm))
    if quant:
        np.testing.assert_array_equal(tpool.k_scale[0].numpy(),
                                      np.asarray(jks))
    jg = jkv.gather_layer_paged(jk, jv, jks, jvs, jpm, j(table), length,
                                jnp.float32)
    tg = tkv.gather_layer_paged(tpool.k[0], tpool.v[0],
                                tpool.k_scale[0] if quant else None,
                                tpool.v_scale[0] if quant else None,
                                tpool.pos_map[0], t(table), length,
                                torch.float32)
    for a, b in zip(tg, jg):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_paged_insert_release_match():
    """Insert scrubs every mapped block (tail entries carry pos −1) and
    release unmaps so later writes drop — equal to the reference."""
    rng = np.random.default_rng(3)
    length, bs, NB, L = 12, 4, 8, 2
    k = rng.normal(size=(L, 1, length, HKV, HD)).astype(np.float32)
    pm = np.tile(np.arange(length, dtype=np.int32), (L, 1, 1))
    ids = np.array([5, 1, -1], np.int32)
    jrow = jkv.AttnCache(k=j(k), v=j(k * 2), pos_map=j(pm))
    jpool = jkv.init_paged_attn_cache(L, 2, length, NB, bs, HKV, HD,
                                      jnp.float32)
    jpool = jpool.replace(pos_map=jnp.full_like(jpool.pos_map, 99))
    jpool = jkv.paged_insert_row(jpool, jrow, j(ids), 1)
    trow = tkv.init_attn_cache(L, 1, length, HKV, HD, torch.float32, "cpu")
    trow.k_buf[:, 0], trow.v_buf[:, 0] = t(k[:, 0]), t(k[:, 0] * 2)
    trow.pm_buf[:, 0] = t(pm[:, 0])
    tpool = tkv.init_paged_attn_cache(L, 2, length, NB, bs, HKV, HD,
                                      torch.float32, "cpu")
    tpool.pm_buf.fill_(99)
    tkv.paged_insert_row(tpool, trow, t(ids), torch.tensor([1]))
    np.testing.assert_array_equal(tpool.k.numpy(), np.asarray(jpool.k))
    np.testing.assert_array_equal(tpool.v.numpy(), np.asarray(jpool.v))
    np.testing.assert_array_equal(tpool.pos_map.numpy(),
                                  np.asarray(jpool.pos_map))
    np.testing.assert_array_equal(tpool.block_table.numpy(),
                                  np.asarray(jpool.block_table))
    tkv.paged_release_slot(tpool, 1)
    assert (tpool.block_table[1] == -1).all()
    before = tpool.k.clone()
    tkv.paged_update_layer(tpool.k_buf[0], tpool.v_buf[0], None, None,
                           tpool.pm_buf[0], tpool.block_table,
                           torch.full((2, 1, HKV, HD), 5.0),
                           torch.full((2, 1, HKV, HD), 5.0),
                           torch.zeros(2, dtype=torch.int32), False, length)
    assert torch.equal(tpool.k, before)       # released ⇒ writes drop


def test_quantize_kv_matches():
    x = np.random.default_rng(4).normal(size=(16, HKV, HD)) * 3.0
    x = x.astype(np.float32)
    qj, sj = jkv.quantize_kv(j(x))
    qt, st = tkv.quantize_kv(t(x))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_block_allocator_matches_reference():
    """Same LIFO ids as the reference on one alloc/free script, the
    partition invariant throughout, and exhaustion exactly at the edge."""
    ja, ta = jkv.BlockAllocator(10), tkv.BlockAllocator(10)
    held = []
    for n, free_idx in [(3, None), (4, None), (0, 0), (2, None), (5, 1)]:
        if free_idx is not None:
            ids = held.pop(free_idx)
            ja.free(ids)
            ta.free(ids)
        if n:
            got = ta.alloc(n)
            assert got == ja.alloc(n)
            held.append(got)
        assert ta.free_blocks + ta.used_blocks == 10
        assert ta.free_blocks == ja.free_blocks
    with pytest.raises(RuntimeError):
        ta.alloc(ta.free_blocks + 1)


# --------------------------------------------------------------- attention

@pytest.mark.parametrize("kind", ["target", "draft"])
@pytest.mark.parametrize("paged", [False, True])
def test_attention_decode_matches(kind, paged):
    """One attention layer: output and written cache equal the reference
    (dense layer cache, or a paged pool through a block table)."""
    jcfg, tcfg = cfgs(kind)
    p_np = perturbed_params(jcfg, 5)["layers"]["attn"]
    p_np = {k: v[0] for k, v in p_np.items()}
    pt = params_from_numpy(p_np, "cpu")
    rng = np.random.default_rng(6)
    S = 20
    x = rng.normal(size=(B, T, 64)).astype(np.float32)
    pos = np.array([4, 9], np.int32)
    k0 = rng.normal(size=(B, S, 2, 16)).astype(np.float32)
    pm0 = np.where(np.arange(S)[None] < pos[:, None], np.arange(S)[None],
                   -1).astype(np.int32)
    jout, jk, jv, jpm = j_attn(j(x), {k: j(v) for k, v in p_np.items()},
                               jcfg, j(k0), j(k0), j(pm0), j(pos), False)
    if not paged:
        cache = tkv.init_attn_cache(1, B, S, 2, 16, torch.float32, "cpu")
        cache.k_buf[0, :B], cache.v_buf[0, :B] = t(k0), t(k0)
        cache.pm_buf[0, :B] = t(pm0)
        out = t_attn(t(x), pt, tcfg, cache.k_buf[0], cache.v_buf[0],
                     cache.pm_buf[0], t(pos), False)
        np.testing.assert_allclose(cache.k[0].numpy(), np.asarray(jk), **TOL)
        np.testing.assert_array_equal(cache.pos_map[0].numpy(),
                                      np.asarray(jpm))
    else:
        bs, NB = 4, 12
        n_log = S // bs
        table = np.arange(B * n_log, dtype=np.int32).reshape(B, n_log)[:, ::-1]
        table = np.ascontiguousarray(table)
        pool = tkv.init_paged_attn_cache(1, B, S, NB, bs, 2, 16,
                                         torch.float32, "cpu")
        flat = table.reshape(-1)
        pool.k_buf[0, flat] = t(k0.reshape(B * n_log, bs, 2, 16))
        pool.v_buf[0, flat] = t(k0.reshape(B * n_log, bs, 2, 16))
        pool.pm_buf[0, flat] = t(pm0.reshape(B * n_log, bs))
        out = t_attn_paged(t(x), pt, tcfg, pool.k_buf[0], pool.v_buf[0],
                           None, None, pool.pm_buf[0], t(table), t(pos),
                           False, S)
        jo2 = j_attn_paged(j(x), {k: j(v) for k, v in p_np.items()}, jcfg,
                           j(pool.k[0].numpy()), j(pool.v[0].numpy()), None,
                           None, j(pool.pos_map[0].numpy()), j(table),
                           j(pos), False, S)[0]
        np.testing.assert_allclose(out.numpy(), np.asarray(jo2), **TOL)
        kd, _, pmd = tkv.gather_layer_paged(pool.k[0], pool.v[0], None,
                                            None, pool.pos_map[0], t(table),
                                            S, torch.float32)
        np.testing.assert_allclose(kd.numpy(), np.asarray(jk), **TOL)
        np.testing.assert_array_equal(pmd.numpy(), np.asarray(jpm))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)


# ------------------------------------------------------------------- model

@pytest.fixture(scope="module", params=["target", "draft"])
def model_pair(request):
    jcfg, tcfg = cfgs(request.param)
    p_np = perturbed_params(jcfg, 11)
    return (JModel(jcfg), jax.tree.map(jnp.asarray, p_np), TModel(tcfg, "cpu"),
            params_from_numpy(p_np, "cpu"))


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, **LOGIT_TOL)
    np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))


def test_model_steps_match(model_pair):
    """prefill → decode_step → verify_step logits equal the reference
    (dense caches on both sides), within tolerance and with equal argmax."""
    jm, jp, tm, tp = model_pair
    rng = np.random.default_rng(12)
    toks = rng.integers(0, 128, size=(2, 7)).astype(np.int32)
    slots = 24
    jl_, jc = jm.prefill(jp, j(toks), slots)
    tl_, tc = tm.prefill(tp, t(toks), slots)
    _close(tl_.numpy(), jl_)
    pos = np.array([7, 7], np.int32)
    nxt = np.asarray(jl_[:, -1].argmax(-1)).astype(np.int32)
    jl_, jc = jm.decode_step(jp, j(nxt), jc, j(pos))
    tl_, tc = tm.decode_step(tp, t(nxt), tc, t(pos))
    _close(tl_.numpy(), jl_)
    win = rng.integers(0, 128, size=(2, 4)).astype(np.int32)
    pos = pos + 1
    jl_, jc = jm.verify_step(jp, j(win), jc, j(pos))
    tl_, tc = tm.verify_step(tp, t(win), tc, t(pos))
    _close(tl_.numpy(), jl_)
    np.testing.assert_array_equal(tc.pos_map.numpy(), np.asarray(jc.pos_map))


def test_paged_model_steps_match_dense_reference(model_pair):
    """The port's paged model path (kernel B2's plain version through a
    block table) gives the reference dense path's logits."""
    jm, jp, tm, tp = model_pair
    rng = np.random.default_rng(13)
    toks = rng.integers(0, 128, size=(2, 6)).astype(np.int32)
    length, bs = 20, 4
    jl_, jc = jm.prefill(jp, j(toks), length)
    pool = tm.init_paged_cache(2, length, 12, bs)
    pool.block_table.copy_(torch.tensor([[7, 2, 9, 0, 4], [1, 3, 5, 6, 8]],
                                        dtype=torch.int32))
    tl_, pool = tm.verify_step(tp, t(toks), pool,
                               torch.zeros(2, dtype=torch.int32))
    _close(tl_.numpy(), jl_)
    win = rng.integers(0, 128, size=(2, 3)).astype(np.int32)
    pos = np.array([6, 6], np.int32)
    jl_, jc = jm.verify_step(jp, j(win), jc, j(pos))
    tl_, pool = tm.verify_step(tp, t(win), pool, t(pos))
    _close(tl_.numpy(), jl_)


def test_prefill_refuses_overlong_prompt(model_pair):
    _, _, tm, tp = model_pair
    with pytest.raises(ValueError):
        tm.prefill(tp, torch.zeros((1, 9), dtype=torch.int32), 8)


@pytest.mark.parametrize("family", ["moe", "vlm", "encdec"])
def test_other_families_name_their_roadmap_item(family):
    cfg = dataclasses.replace(cfgs("target")[1], arch_type=family)
    with pytest.raises(NotImplementedError, match="A12"):
        TModel(cfg, "cpu")
