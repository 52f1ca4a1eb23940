"""Engine-owned slot pools (``repro_torch.core.pool``), on the CPU.

A session leases the engine's pool of its geometry and gives it back on
``close()``; a later session of that geometry reuses the pool's buffers
and its :class:`~repro_torch.core.capture.CapturedStep` objects, which on
the card hold the captured graphs. Here the steps run eagerly, and the
tests hold what makes the reuse safe:

- a second ``generate``, a second server run and a second tree wave of one
  geometry get the same pool: the same step objects and buffer addresses,
  and tokens equal to the first run's and to the JAX reference engine's;
- two live sessions of one geometry hold two pools;
- a pool left by a session with slots still live (dense, paged, ssm ←
  ssm) serves the next session with tokens equal to a fresh engine's;
- at T > 0 the re-seeded generator repeats a seed's tokens;
- an engine with pools is freed by reference counting alone.

Tiny float32 pairs (d_model 64, 2 layers, vocab 128); tokens and counts
compared exactly."""

import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import ModelConfig as JCfg
from repro.core.engine import SpecDecodeEngine as JEngine
from repro.core.window import StaticWindowPolicy as JStatic
from repro.models.model import Model as JModel
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import ModelConfig as TCfg
from repro_torch.core.engine import SpecDecodeEngine
from repro_torch.core.session import DecodeSession
from repro_torch.core.window import StaticWindowPolicy
from repro_torch.serving import (ServeRequest, ServerConfig,
                                 SpecDecodeServer, WaveSpecDecodeServer)

CFG = dict(arch_type="dense", n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=2, d_ff=128, vocab=128, head_dim=16, dtype="float32",
           remat=False)
SSM = dict(arch_type="ssm", n_layers=2, d_model=64, n_heads=0, n_kv_heads=0,
           d_ff=0, vocab=128, ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
           dtype="float32", remat=False, tie_embeddings=True)
GMAX = 4
MAX_NEW = 10


def _noised_pair():
    """(draft, target) numpy weights: the target and its noised copy, so
    acceptance lies strictly between 0 and 1."""
    t_np = jax.device_get(JModel(JCfg(name="t", **CFG)).init_params(
        jax.random.PRNGKey(1)))
    rng = np.random.default_rng(3)
    d_np = jax.tree.map(lambda a: (a + 0.02 * a.std() * rng.normal(
        size=a.shape)).astype(a.dtype), t_np)
    return d_np, t_np


@pytest.fixture(scope="module")
def weights():
    return _noised_pair()


def _engine(weights, temperature=0.0, d_kw=CFG, t_kw=CFG):
    d_np, t_np = weights
    return SpecDecodeEngine(
        TCfg(name="d", **d_kw), TCfg(name="t", **t_kw),
        draft_params=params_from_numpy(d_np, "cpu"),
        target_params=params_from_numpy(t_np, "cpu"),
        temperature=temperature, device="cpu")


def _prompts(seed=4):
    rng = np.random.default_rng(seed)
    lens = np.array([9, 5, 12], np.int32)
    p = np.zeros((3, 12), np.int32)
    for i, n in enumerate(lens):
        p[i, :n] = rng.integers(0, 128, n)
    return p, lens


def _pool_of(eng):
    pools = [p for ps in eng.pools.values() for p in ps]
    assert len(pools) == 1, len(pools)
    return pools[0]


def _addresses(pool) -> dict:
    st = pool.state
    leaves = {"pos": st.pos, "last_token": st.last_token,
              "k": st.target_cache.k_buf, "dk": st.draft_cache.k_buf,
              "pm": st.target_cache.pm_buf, "out": pool.out_buf,
              "cursor": pool.cursor, "done": pool.done, "nacc": pool.nacc}
    for name, step in pool.steps.items():
        leaves.update({f"{name}.{k}": v for k, v in step.inputs.items()})
    return {k: v.data_ptr() for k, v in leaves.items()}


def test_second_generate_reuses_the_pool(weights):
    """Two ``generate`` calls of one geometry: one pool, the same step
    objects and buffers, tokens and acceptance equal to the first call's
    and to the reference engine's."""
    eng = _engine(weights)
    p, lens = _prompts()
    t1, s1 = eng.generate(p, MAX_NEW, StaticWindowPolicy(3),
                          prompt_lens=lens, gamma_max=GMAX)
    pool = _pool_of(eng)
    assert not pool.leased
    steps, addr = dict(pool.steps), _addresses(pool)
    keys = set(eng.step_keys)
    t2, s2 = eng.generate(p, MAX_NEW, StaticWindowPolicy(3),
                          prompt_lens=lens, gamma_max=GMAX)
    assert _pool_of(eng) is pool and not pool.leased
    assert pool.steps == steps and _addresses(pool) == addr
    assert eng.step_keys == keys
    np.testing.assert_array_equal(t1, t2)
    assert s1.acceptance_seqs == s2.acceptance_seqs
    assert 0 < s1.accepted < s1.proposed

    d_np, t_np = weights
    jeng = JEngine(JCfg(name="d", **CFG), JCfg(name="t", **CFG),
                   draft_params=jax.tree.map(jnp.asarray, d_np),
                   target_params=jax.tree.map(jnp.asarray, t_np),
                   temperature=0.0, key=jax.random.PRNGKey(0))
    jt, js = jeng.generate(p, MAX_NEW, JStatic(3), prompt_lens=lens,
                           gamma_max=GMAX)
    np.testing.assert_array_equal(t1, np.asarray(jt))
    assert s1.acceptance_seqs == js.acceptance_seqs


def _requests(seed, n=5):
    rng = np.random.default_rng(seed)
    return [ServeRequest(i, rng.integers(0, 128, int(rng.integers(3, 14))
                                         ).astype(np.int32),
                         int(rng.integers(4, MAX_NEW + 1)))
            for i in range(n)]


@pytest.mark.parametrize("server,paged", [("continuous", False),
                                          ("continuous", True),
                                          ("wave", False)])
def test_second_server_run_reuses_the_pool(weights, server, paged):
    """A second server of one geometry on the engine leases the first
    one's pool after it closed: same steps and buffers, same tokens."""
    eng = _engine(weights)
    cfg = dict(max_batch=2, sync_every=3, max_prompt_len=16,
               max_new_cap=MAX_NEW, paged_kv=paged, kv_block_size=4)
    cls = SpecDecodeServer if server == "continuous" else \
        WaveSpecDecodeServer
    runs = []
    for _ in range(2):
        srv = cls(eng, StaticWindowPolicy(3), ServerConfig(**cfg))
        for r in _requests(5):
            srv.submit(r)
        res = {r.request_id: (r.tokens, r.acceptance_rate)
               for r in srv.run()}
        pool = _pool_of(eng)
        assert not pool.leased
        runs.append((res, pool, dict(pool.steps), _addresses(pool)))
    (r1, p1, st1, a1), (r2, p2, st2, a2) = runs
    assert p1 is p2 and st1 == st2 and a1 == a2
    assert set(st1) == {"round", "insert"}
    for k in r1:
        np.testing.assert_array_equal(r1[k][0], r2[k][0])
        assert r1[k][1] == r2[k][1]


def _tree_wave(eng, prompts, lens):
    with DecodeSession(eng, capacity=3, max_new_cap=MAX_NEW,
                       max_prompt_len=12, gamma_max=GMAX,
                       max_branches=2) as sess:
        sess.admit_batch(prompts, MAX_NEW, prompt_lens=lens)
        while sess.unfinished:
            sess.run_chunk(StaticWindowPolicy(3))
        return sess.snapshot()[0], sess._pool


def test_second_tree_wave_reuses_the_pool(weights):
    eng = _engine(weights)
    p, lens = _prompts()
    t1, pool1 = _tree_wave(eng, p, lens)
    steps = dict(pool1.steps)
    t2, pool2 = _tree_wave(eng, p, lens)
    assert pool1 is pool2 and pool2.steps == steps
    np.testing.assert_array_equal(t1, t2)


def test_two_live_sessions_hold_two_pools(weights):
    eng = _engine(weights)
    kw = dict(capacity=2, max_new_cap=MAX_NEW, max_prompt_len=12,
              gamma_max=GMAX)
    a, b = DecodeSession(eng, **kw), DecodeSession(eng, **kw)
    a.admit(np.arange(1, 6, dtype=np.int32), 4)
    b.admit(np.arange(1, 6, dtype=np.int32), 4)
    assert a._pool is not b._pool
    assert a._pool.key == b._pool.key
    assert a._state.target_cache.k_buf.data_ptr() != \
        b._state.target_cache.k_buf.data_ptr()
    a.close()
    c = DecodeSession(eng, **kw)
    c.admit(np.arange(1, 6, dtype=np.int32), 4)
    key = c._pool.key
    assert c._pool is not b._pool and len(eng.pools[key]) == 2
    b.close()
    c.close()
    with pytest.raises(RuntimeError, match="closed"):
        c._state
    assert not any(p.leased for p in eng.pools[key])


def _drive(sess, reqs, policy, stop_after=None):
    """Admit ``reqs`` as slots free up and decode; with ``stop_after``
    rounds, leave the session mid-stream (slots still live). Returns the
    tokens of the retired requests."""
    out, queue = {}, list(reqs)
    while queue or sess.occupied:
        while queue and sess.free and sess.can_admit(len(queue[0].prompt),
                                                     queue[0].max_new_tokens):
            r = queue.pop(0)
            sess.admit(r.prompt, r.max_new_tokens, request_id=r.request_id)
        sess.run_chunk(policy)
        if stop_after is not None and sess.iterations >= stop_after:
            return out
        for j in sess.finished_slots():
            tokens, rec = sess.retire(j)
            out[rec.request_id] = tokens
    return out


@pytest.mark.parametrize("kind", ["dense", "paged", "ssm"])
def test_reused_pool_leaks_nothing(weights, kind):
    """A session abandoned mid-stream (slots still decoding, KV and
    recurrent state written, paged blocks reserved) closes; the next
    session of its geometry leases the same pool and serves a new stream
    with the tokens of a fresh engine's session."""
    kw = dict(d_kw=SSM, t_kw=SSM) if kind == "ssm" else {}
    if kind == "ssm":
        d = JModel(JCfg(name="s", **SSM)).init_params(jax.random.PRNGKey(5))
        w = (jax.device_get(d), jax.device_get(d))
    else:
        w = weights
    skw = dict(capacity=2, max_new_cap=MAX_NEW, max_prompt_len=16,
               gamma_max=GMAX, sync_every=3, paged=kind == "paged",
               kv_block_size=4)
    pol = StaticWindowPolicy(3)
    eng = _engine(w, **kw)
    with DecodeSession(eng, **skw) as first:
        _drive(first, _requests(11), pol, stop_after=4)
        assert first.occupied
        pool = first._pool
    with DecodeSession(eng, **skw) as second:
        got = _drive(second, _requests(12), pol)
        assert second._pool is pool
    with DecodeSession(_engine(w, **kw), **skw) as fresh:
        want = _drive(fresh, _requests(12), pol)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_reseeded_generator_repeats_sampled_tokens(weights):
    """T 0.7: two ``generate(seed=s)`` on one engine (one pool) give equal
    tokens; another seed gives other tokens; both equal a fresh engine's
    run of that seed."""
    eng = _engine(weights, temperature=0.7)
    p, lens = _prompts()
    kw = dict(prompt_lens=lens, gamma_max=GMAX)
    a = eng.generate(p, MAX_NEW, StaticWindowPolicy(3), seed=7, **kw)[0]
    b = eng.generate(p, MAX_NEW, StaticWindowPolicy(3), seed=8, **kw)[0]
    c = eng.generate(p, MAX_NEW, StaticWindowPolicy(3), seed=7, **kw)[0]
    _pool_of(eng)
    np.testing.assert_array_equal(a, c)
    assert not np.array_equal(a, b)
    fresh = _engine(weights, temperature=0.7).generate(
        p, MAX_NEW, StaticWindowPolicy(3), seed=8, **kw)[0]
    np.testing.assert_array_equal(b, fresh)


def test_engine_with_pools_is_freed_without_the_collector(weights):
    """The pools' steps close over a weak proxy of the engine: dropping the
    last reference frees the engine (and its pools and weights) with the
    garbage collector off."""
    p, lens = _prompts()
    gc.disable()
    try:
        eng = _engine(weights)
        eng.generate(p, 4, StaticWindowPolicy(2), prompt_lens=lens,
                     gamma_max=GMAX)
        with DecodeSession(eng, capacity=2, max_new_cap=4,
                           max_prompt_len=12, gamma_max=GMAX) as sess:
            sess.admit(p[0, :lens[0]], 4)
            sess.run_chunk(StaticWindowPolicy(2))
        ref = weakref.ref(eng)
        del eng, sess
        assert ref() is None
    finally:
        gc.enable()


def test_pool_of_a_failed_wave_serves_the_next(weights):
    """A wave whose prefill raises after the lease (a vlm given a frontend)
    leaves a pool with no state; the next session of that geometry leases
    it and builds the state."""
    from repro_torch.configs import get_config
    cfg = get_config("internvl2-76b").reduced()
    eng = SpecDecodeEngine(cfg, cfg, seed=0, device="cpu")
    p, lens = _prompts()
    p = p % cfg.vocab
    fe = np.zeros((3, 2, cfg.d_model), np.float32)
    with DecodeSession(eng, capacity=3, max_new_cap=4, max_prompt_len=12,
                       gamma_max=GMAX) as sess:
        with pytest.raises(NotImplementedError):
            sess.admit_batch(p, 4, prompt_lens=lens, frontend=fe)
    assert [q.state for qs in eng.pools.values() for q in qs] == [None]
    with DecodeSession(eng, capacity=3, max_new_cap=4, max_prompt_len=12,
                       gamma_max=GMAX) as sess:
        sess.admit_batch(p, 4, prompt_lens=lens)
        while sess.unfinished:
            sess.run_chunk(StaticWindowPolicy(2))
        toks = sess.snapshot()[0]
    assert (toks >= 0).all()
