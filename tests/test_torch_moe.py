"""The port's MoE family (``repro_torch.models.moe`` and the moe branches of
``models/model.py``), held against the JAX reference on the same numpy
inputs and bridged weights, float32.

- ``moe_block`` for ``arctic-480b.reduced()`` (top-2, dense residual) and
  ``llama4-maverick-400b-a17b.reduced()`` (top-1), at capacity factor 1.25
  (assignments dropped) and 8 (none dropped): outputs and the aux loss;
  GShard grouping (``moe_group`` 16, S 64) against the reference's and
  against the ungrouped block run group by group; planted equal gates: the
  lowest expert index wins, as ``lax.top_k`` ranks it;
- model logits for prefill, decode and verify, dense and paged caches;
- greedy tokens, accept counts and acceptance bits of a moe target (arctic
  reduced at the tests' narrow widths) under a dense draft and under its
  noised moe copy at γ 4: dense, paged, int8 paged, tree and in-process
  transport sessions against the reference engine's sessions. Capacity is
  computed over the whole γ_max + 1 window in both packages, so with drops
  the tokens are the reference's (not the target's T = 1 greedy decode).

Tolerances: ``LOGIT_TOL`` atol = rtol = 1e-4; tokens and counts exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get
from repro.configs.base import ModelConfig as JCfg
from repro.core.engine import SpecDecodeEngine as JEngine
from repro.core.session import DecodeSession as JSession
from repro.core.window import StaticWindowPolicy as JStatic
from repro.distributed import InProcessTransport as JInProcess
from repro.models import moe as jmoe
from repro.models.model import Model as JModel
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as t_get
from repro_torch.configs.base import ModelConfig as TCfg
from repro_torch.core.engine import SpecDecodeEngine
from repro_torch.core.session import DecodeSession
from repro_torch.core.window import StaticWindowPolicy
from repro_torch.distributed import InProcessTransport
from repro_torch.models import moe as tmoe
from repro_torch.models.model import Model as TModel

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
MOES = ("arctic-480b", "llama4-maverick-400b-a17b")
# the session tests' narrow widths (the family's routing as published)
NARROW = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
              vocab=128)
DENSE = dict(name="tiny-dense", arch_type="dense", n_layers=2, d_model=64,
             n_heads=4, n_kv_heads=2, d_ff=128, vocab=128, head_dim=16,
             dtype="float32", remat=False)
GMAX = 4
MAX_NEW = 10


def cfgs(name, **kw):
    return (dataclasses.replace(j_get(name).reduced(), **kw),
            dataclasses.replace(t_get(name).reduced(), **kw))


def layer0(tree):
    return {k: (layer0(v) if isinstance(v, dict) else v[0])
            for k, v in tree.items()}


def moe_weights(jcfg, seed):
    """Layer 0's MoE weights of a reference init, as numpy."""
    p = jax.device_get(JModel(jcfg).init_params(jax.random.PRNGKey(seed)))
    return layer0(p["layers"])["moe"]


@pytest.mark.parametrize("cf", [1.25, 8.0])
@pytest.mark.parametrize("name", MOES)
def test_moe_block_matches_reference(name, cf):
    jcfg, tcfg = cfgs(name, capacity_factor=cf)
    w = moe_weights(jcfg, 1)
    x = np.random.default_rng(2).normal(size=(3, 24, jcfg.d_model)
                                        ).astype(np.float32)
    jy, jaux = jmoe.moe_block(jnp.asarray(x), jax.tree.map(jnp.asarray, w),
                              jcfg)
    tp = params_from_numpy(w, "cpu")
    ty, taux = tmoe.moe_block(torch.from_numpy(x), tp, tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LOGIT_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    dropped = float(tmoe.dropped_assignments(torch.from_numpy(x),
                                             tp["router"], tcfg))
    assert (dropped > 0) == (cf < 2), dropped


def test_grouped_moe_matches_reference_and_ungrouped():
    """S 64 over ``moe_group`` 16: four groups with their own capacity —
    the reference's grouped block, and the ungrouped block applied to each
    group alone."""
    jcfg, tcfg = cfgs("arctic-480b", moe_group=16)
    w = moe_weights(jcfg, 3)
    x = np.random.default_rng(4).normal(size=(2, 64, jcfg.d_model)
                                        ).astype(np.float32)
    jy, _ = jmoe.moe_block(jnp.asarray(x), jax.tree.map(jnp.asarray, w),
                           jcfg)
    tp = params_from_numpy(w, "cpu")
    ty, _ = tmoe.moe_block(torch.from_numpy(x), tp, tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LOGIT_TOL)
    per = [tmoe.moe_block(torch.from_numpy(x[:, g * 16:(g + 1) * 16]), tp,
                          tcfg)[0] for g in range(4)]
    np.testing.assert_allclose(ty.numpy(), torch.cat(per, 1).numpy(),
                               **LOGIT_TOL)
    whole, _ = tmoe.moe_block(torch.from_numpy(x), tp,
                              dataclasses.replace(tcfg, moe_group=4096))
    assert not np.allclose(whole.numpy(), ty.numpy(), **LOGIT_TOL)


@pytest.mark.parametrize("name", MOES)
def test_equal_gates_rank_the_lowest_expert_first(name):
    """Experts 1 and 3 get the same router column, scaled to win: their
    gates are equal in every token, and expert 1 ranks first, as in the
    reference (``lax.top_k``)."""
    jcfg, tcfg = cfgs(name)
    w = moe_weights(jcfg, 5)
    r = w["router"].copy()
    r[:, 1] = 4.0 * r[:, 1]
    r[:, 3] = r[:, 1]
    w["router"] = r
    x = np.random.default_rng(6).normal(size=(2, 8, jcfg.d_model)
                                        ).astype(np.float32)
    gates = torch.softmax(torch.from_numpy(x) @ torch.from_numpy(r), -1)
    _, idx = tmoe.top_k_lowest_first(gates, 2)
    _, jidx = jax.lax.top_k(jnp.asarray(gates.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    tie = (gates[..., 1] == gates[..., 3]) & (idx[..., 0] == 1)
    assert bool(tie.any())
    assert not bool((idx[..., 0] == 3).any())
    jy, _ = jmoe.moe_block(jnp.asarray(x), jax.tree.map(jnp.asarray, w),
                           jcfg)
    ty, _ = tmoe.moe_block(torch.from_numpy(x), params_from_numpy(w, "cpu"),
                           tcfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **LOGIT_TOL)


def test_router_stays_float32_through_the_bridge():
    jcfg, _ = cfgs("arctic-480b")
    p = jax.device_get(JModel(jcfg).init_params(jax.random.PRNGKey(0)))
    tp = params_from_numpy(p, "cpu", torch.bfloat16)
    assert tp["layers"]["moe"]["router"].dtype == torch.float32
    assert tp["layers"]["moe"]["w_gate"].dtype == torch.bfloat16
    own = TModel(dataclasses.replace(cfgs("arctic-480b")[1],
                                     dtype="bfloat16"), "cpu").init_params(0)
    assert own["layers"]["moe"]["router"].dtype == torch.float32


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, **LOGIT_TOL)
    np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))


@pytest.mark.parametrize("name", MOES)
def test_model_steps_match_reference(name):
    """prefill → decode_step → verify_step logits of the reduced config,
    dense cache and paged pool, equal the reference's."""
    jcfg, tcfg = cfgs(name)
    p_np = jax.device_get(JModel(jcfg).init_params(jax.random.PRNGKey(7)))
    jm, tm = JModel(jcfg), TModel(tcfg, "cpu")
    jp, tp = jax.tree.map(jnp.asarray, p_np), params_from_numpy(p_np, "cpu")
    rng = np.random.default_rng(8)
    V = jcfg.vocab
    toks = rng.integers(0, V, size=(2, 7)).astype(np.int32)
    jl, jc = jm.prefill(jp, jnp.asarray(toks), 24)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), 24)
    _close(tl.numpy(), jl)
    pool = tm.init_paged_cache(2, 24, 16, 4)
    pool.block_table.copy_(torch.arange(12, dtype=torch.int32).view(2, 6))
    pl, pool = tm.verify_step(tp, torch.from_numpy(toks), pool,
                              torch.zeros(2, dtype=torch.int32))
    _close(pl.numpy(), jl)
    pos = np.array([7, 7], np.int32)
    nxt = np.asarray(jl[:, -1].argmax(-1)).astype(np.int32)
    jl, jc = jm.decode_step(jp, jnp.asarray(nxt), jc, jnp.asarray(pos))
    tl, tc = tm.decode_step(tp, torch.from_numpy(nxt), tc,
                            torch.from_numpy(pos))
    _close(tl.numpy(), jl)
    win = rng.integers(0, V, size=(2, 5)).astype(np.int32)
    pos = pos + 1
    jl, jc = jm.verify_step(jp, jnp.asarray(win), jc, jnp.asarray(pos))
    tl, tc = tm.verify_step(tp, torch.from_numpy(win), tc,
                            torch.from_numpy(pos))
    _close(tl.numpy(), jl)


# ----------------------------------------------------------- sessions

@pytest.fixture(scope="module")
def weights():
    """(moe target, dense draft, noised moe draft) numpy weights."""
    jcfg, _ = cfgs("arctic-480b", **NARROW)
    t_np = jax.device_get(JModel(jcfg).init_params(jax.random.PRNGKey(11)))
    d_np = jax.device_get(JModel(JCfg(**DENSE)).init_params(
        jax.random.PRNGKey(12)))
    rng = np.random.default_rng(13)
    noised = jax.tree.map(lambda a: (a + 0.02 * a.std() * rng.normal(
        size=a.shape)).astype(a.dtype), t_np)
    return t_np, d_np, noised


def _pair(weights, draft):
    t_np, d_np, noised = weights
    jt, tt = cfgs("arctic-480b", **NARROW)
    if draft == "dense":
        jd, td, dw = JCfg(**DENSE), TCfg(**DENSE), d_np
    else:
        jd, td, dw = jt, tt, noised
    jeng = JEngine(jd, jt, draft_params=jax.tree.map(jnp.asarray, dw),
                   target_params=jax.tree.map(jnp.asarray, t_np),
                   temperature=0.0, key=jax.random.PRNGKey(0))
    teng = SpecDecodeEngine(td, tt, draft_params=params_from_numpy(dw, "cpu"),
                            target_params=params_from_numpy(t_np, "cpu"),
                            device="cpu")
    return jeng, teng


def _requests():
    rng = np.random.default_rng(14)
    return [(rng.integers(0, 128, n).astype(np.int32), m)
            for n, m in ((9, 10), (5, 7), (12, 9))]


def _serve(cls, eng, policy, **kw):
    """Two slots, three requests: retire each as it finishes and admit the
    next into its slot. Returns (tokens and bits per request, rounds,
    accepted, proposed)."""
    sess = cls(eng, capacity=2, max_new_cap=MAX_NEW, max_prompt_len=12,
               gamma_max=GMAX, sync_every=2, **kw)
    pending, outs = list(enumerate(_requests())), {}
    for _ in range(60):
        while pending and sess.free and sess.can_admit(
                pending[0][1][0].size, pending[0][1][1]):
            rid, (prompt, budget) = pending.pop(0)
            sess.admit(prompt, budget, request_id=rid)
        if not sess.occupied:
            break
        sess.run_chunk(policy)
        for j in sess.finished_slots():
            toks, rec = sess.retire(j)
            outs[rec.request_id] = (np.asarray(toks), list(rec.bits))
    return outs, sess.iterations, sess.accepted, sess.proposed


MODES = {
    "dense": {},
    "paged": dict(paged=True, kv_block_size=4, kv_pool_blocks=14),
    "int8_paged": dict(paged=True, kv_block_size=4, kv_pool_blocks=14,
                       kv_quantize=True),
    "tree": dict(max_branches=3),
    "in_process": "transport",
}


@pytest.mark.parametrize("draft", ["dense", "noised_moe"])
@pytest.mark.parametrize("mode", list(MODES))
def test_moe_sessions_match_reference(weights, mode, draft):
    jeng, teng = _pair(weights, draft)
    opts = MODES[mode]
    jkw = tkw = opts
    if opts == "transport":
        jkw, tkw = dict(transport=JInProcess()), \
            dict(transport=InProcessTransport())
    jout, *jstats = _serve(JSession, jeng, JStatic(GMAX), **jkw)
    tout, *tstats = _serve(DecodeSession, teng, StaticWindowPolicy(GMAX),
                           **tkw)
    assert tstats == jstats and set(tout) == set(jout) == {0, 1, 2}
    for rid, (toks, bits) in jout.items():
        np.testing.assert_array_equal(tout[rid][0], toks)
        assert tout[rid][1] == bits
    if draft == "noised_moe":
        assert 0 < tstats[1] < tstats[2]


def test_moe_generate_matches_reference(weights):
    """``generate`` (a batched wave) of the moe target under the dense
    draft: tokens and acceptance bits equal the reference engine's."""
    jeng, teng = _pair(weights, "dense")
    reqs = _requests()
    lens = np.array([r[0].size for r in reqs], np.int32)
    p = np.zeros((3, 12), np.int32)
    for i, (r, _) in enumerate(reqs):
        p[i, :r.size] = r
    jt, js = jeng.generate(p, MAX_NEW, JStatic(GMAX), prompt_lens=lens,
                           gamma_max=GMAX)
    tt, ts = teng.generate(p, MAX_NEW, StaticWindowPolicy(GMAX),
                           prompt_lens=lens, gamma_max=GMAX)
    np.testing.assert_array_equal(tt, np.asarray(jt))
    assert ts.acceptance_seqs == js.acceptance_seqs
