"""The port's speculative-decoding engine, session and server, held against
the JAX reference engine on bridged weights (tiny float32 pair: a qk_norm
target like qwen3, a qkv-bias draft like qwen2.5).

Discrete results are compared exactly: ``slot_stop_mask`` outputs, greedy
tokens (which must also equal the target's own greedy decode), accept
counts and per-request acceptance bit streams under the static policy,
and the AWC policy's decisions on fixed feature snapshots. (AWC reads a
wall-clock TPOT feature, so its γ sequence differs between two live runs;
its tokens do not, at temperature 0.)"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JCfg
from repro.core.engine import SpecDecodeEngine as JEngine
from repro.core import specdec as jsd
from repro.core.specdec import slot_stop_mask as j_slot_stop
from repro.core.window import FeatureSnapshot as JFeat
from repro.core.window import StaticWindowPolicy as JStatic
from repro.core.window import make_window_policy as j_make_policy
from repro.models.model import Model as JModel
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import ModelConfig as TCfg
from repro_torch.core.engine import SpecDecodeEngine
from repro_torch.core.session import DecodeSession
from repro_torch.core import specdec as tsd
from repro_torch.core.specdec import slot_stop_mask
from repro_torch.core.window import (FeatureSnapshot, StaticWindowPolicy,
                                     WindowDecision, make_window_policy)
from repro_torch.launch import serve
from repro_torch.serving import (RoundRobinPairRouter, ServeRequest,
                                 ServerConfig, ServingPair, SpecDecodeServer)

CFG = dict(arch_type="dense", n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=2, d_ff=128, vocab=128, head_dim=16, dtype="float32",
           remat=False)
TARGET = dict(name="tiny-target", qk_norm=True)
DRAFT = dict(name="tiny-draft", qkv_bias=True)
GMAX = 4
MAX_NEW = 10


def _np_params(kw, seed):
    p = jax.device_get(JModel(JCfg(**CFG, **kw)).init_params(
        jax.random.PRNGKey(seed)))
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


def _noised(p, scale, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (a + scale * a.std() * rng.normal(
        size=a.shape)).astype(a.dtype), p)


def _engines(d_kw, t_kw, d_np, t_np):
    jeng = JEngine(JCfg(**CFG, **d_kw), JCfg(**CFG, **t_kw),
                   draft_params=jax.tree.map(jnp.asarray, d_np),
                   target_params=jax.tree.map(jnp.asarray, t_np),
                   temperature=0.0, key=jax.random.PRNGKey(0))
    teng = SpecDecodeEngine(TCfg(**CFG, **d_kw), TCfg(**CFG, **t_kw),
                            draft_params=params_from_numpy(d_np, "cpu"),
                            target_params=params_from_numpy(t_np, "cpu"),
                            device="cpu")
    return jeng, teng


@pytest.fixture(scope="module")
def pair():
    """Random draft/target pair (low acceptance) and a noised self-draft
    pair (high acceptance), each as (reference engine, port engine)."""
    t_np = _np_params(TARGET, 1)
    d_np = _np_params(DRAFT, 2)
    return {"random": _engines(DRAFT, TARGET, d_np, t_np),
            "noised": _engines(TARGET, TARGET, _noised(t_np, 0.02, 3), t_np)}


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(4)
    lens = np.array([9, 5, 12], np.int32)
    p = np.zeros((3, 12), np.int32)
    for i, n in enumerate(lens):
        p[i, :n] = rng.integers(0, 128, n)
    return p, lens


def target_greedy(eng, prompt, n):
    """The target's own greedy continuation, one token per step."""
    m, params = eng.target, eng.target_params
    logits, cache = m.prefill(params, torch.as_tensor(prompt[None]),
                              prompt.size + n + 2)
    tok = logits[:, -1].argmax(-1).to(torch.int32)
    out, pos = [int(tok)], torch.tensor([prompt.size], dtype=torch.int32)
    for _ in range(n - 1):
        logits, cache = m.decode_step(params, tok, cache, pos)
        tok = logits.argmax(-1).to(torch.int32)
        out.append(int(tok))
        pos = pos + 1
    return np.array(out)


# ------------------------------------------------------ Eqs. 1-2, stopping

def test_analytic_formulas_match_reference():
    alphas = np.array([0.0, 0.3, 0.7, 0.999999, 1.0], np.float32)
    for g in (1, 4, 8):
        np.testing.assert_allclose(
            tsd.expected_accepted(torch.from_numpy(alphas), g).numpy(),
            np.asarray(jsd.expected_accepted(alphas, g)), rtol=1e-6)
        np.testing.assert_allclose(
            tsd.expected_speedup(torch.from_numpy(alphas), g, 0.12).numpy(),
            np.asarray(jsd.expected_speedup(alphas, g, 0.12)), rtol=1e-6)
    for a, c in ((0.5, 0.1), (0.8, 0.05), (0.95, 0.3)):
        assert tsd.optimal_gamma(a, c) == jsd.optimal_gamma(a, c)


@pytest.mark.parametrize("eos", [-1, 3])
def test_slot_stop_mask_matches_reference(eos):
    rng = np.random.default_rng(eos + 10)
    B, W = 6, 5
    for _ in range(40):
        num_new = rng.integers(1, W + 1, B).astype(np.int32)
        n_acc = (num_new - 1).astype(np.int32)
        toks = rng.integers(0, 6, (B, W)).astype(np.int32)
        toks = np.where(np.arange(W)[None] < num_new[:, None], toks, -1)
        cursor = rng.integers(0, 9, B).astype(np.int32)
        max_new = rng.integers(1, 12, B).astype(np.int32)
        done = rng.random(B) < 0.3
        ref = j_slot_stop(*map(jnp.asarray, (num_new, n_acc, toks, cursor,
                                             max_new, done)), eos)
        got = slot_stop_mask(*map(torch.from_numpy, (num_new, n_acc, toks,
                                                     cursor, max_new,
                                                     done)),
                             torch.tensor(eos, dtype=torch.int32))
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# -------------------------------------------------------------- generation

@pytest.mark.parametrize("kind", ["random", "noised"])
def test_static_generate_matches_reference(pair, prompts, kind):
    """Static γ=3 at width 4: tokens, accept counts and per-request bit
    streams equal the reference engine's; tokens equal the target's greedy
    decode."""
    jeng, teng = pair[kind]
    p, lens = prompts
    jt, js = jeng.generate(p, MAX_NEW, JStatic(3), prompt_lens=lens,
                           gamma_max=GMAX)
    tt, ts = teng.generate(p, MAX_NEW, StaticWindowPolicy(3),
                           prompt_lens=lens, gamma_max=GMAX)
    np.testing.assert_array_equal(tt, np.asarray(jt))
    assert (ts.accepted, ts.proposed, ts.iterations) == \
        (js.accepted, js.proposed, js.iterations)
    assert ts.acceptance_seqs == js.acceptance_seqs
    for i in range(3):
        np.testing.assert_array_equal(
            tt[i], target_greedy(teng, p[i, :lens[i]], MAX_NEW))
    if kind == "noised":
        assert ts.accepted > 0


def test_awc_generate_matches_reference(pair, prompts):
    jeng, teng = pair["random"]
    p, lens = prompts
    jt, _ = jeng.generate(p, MAX_NEW, j_make_policy("awc"), prompt_lens=lens,
                          gamma_max=GMAX)
    tt, _ = teng.generate(p, MAX_NEW, make_window_policy("awc"),
                          prompt_lens=lens, gamma_max=GMAX)
    np.testing.assert_array_equal(tt, np.asarray(jt))


def test_awc_decisions_match_reference():
    """Both AWC policies (default predictor + stabilizer) fed the same
    feature snapshots make the same decisions."""
    rng = np.random.default_rng(5)
    jp, tp = j_make_policy("awc"), make_window_policy("awc")
    for _ in range(60):
        f = [float(rng.uniform(0, 2)), float(rng.uniform(0, 1)),
             float(rng.choice([0.0, 5.0, 40.0, 200.0])),
             float(rng.uniform(5, 80)), float(rng.integers(1, 9)), 0.0, 1.0]
        a = jp.decide("pair0", JFeat(*f))
        b = tp.decide("pair0", FeatureSnapshot(*f))
        assert (a.gamma, a.mode, a.branches) == (b.gamma, b.mode, b.branches)


class _CyclePolicy:
    """γ changes every round, with a fused round in the cycle."""

    def __init__(self):
        self.i = 0

    def decide(self, pair_key, feats):
        self.i += 1
        if self.i % 5 == 0:
            return WindowDecision(1, "fused")
        return WindowDecision(1 + self.i % GMAX, "distributed")

    def gamma_bound(self):
        return GMAX


def test_changing_gamma_adds_no_step_key(pair, prompts):
    _, teng = pair["random"]
    p, lens = prompts
    teng.generate(p, MAX_NEW, StaticWindowPolicy(GMAX), prompt_lens=lens)
    before = set(teng.step_keys)
    tt, st = teng.generate(p, MAX_NEW, _CyclePolicy(), prompt_lens=lens)
    assert teng.step_keys == before == {("fused", GMAX)}
    assert len(set(st.gamma_seq)) > 2
    for i in range(3):
        np.testing.assert_array_equal(
            tt[i], target_greedy(teng, p[i, :lens[i]], MAX_NEW))


# -------------------------------------------------- continuous batching

def _drain(sess, pol, outs):
    for _ in range(64):
        if not sess.unfinished:
            break
        sess.run_chunk(pol)
        for j in sess.finished_slots():
            toks, rec = sess.retire(j)
            outs[rec.request_id] = toks
    assert not sess.unfinished


@pytest.mark.parametrize("paged", [False, True])
def test_staggered_cotenants_equal_solo(pair, paged):
    """Admit request 0 alone, co-admit 1 and 2 mid-flight, retire 0 and
    re-admit request 3 into its slot: every request commits the tokens of
    its solo run, with no new step key across the churn."""
    _, teng = pair["noised"]
    rng = np.random.default_rng(3)
    ps = [rng.integers(0, 128, int(n)).astype(np.int32)
          for n in (9, 13, 6, 11)]
    budgets = [12, 8, 12, 10]
    pol = StaticWindowPolicy(3)
    sess = DecodeSession(teng, capacity=3, max_new_cap=12, max_prompt_len=16,
                         gamma_max=GMAX, sync_every=2, paged=paged)
    outs = {}
    sess.admit(ps[0], budgets[0], request_id=0)
    sess.run_chunk(pol)
    warm = set(teng.step_keys)
    sess.admit(ps[1], budgets[1], request_id=1)
    sess.admit(ps[2], budgets[2], request_id=2)
    while 0 not in outs:
        sess.run_chunk(pol)
        for j in sess.finished_slots():
            toks, rec = sess.retire(j)
            outs[rec.request_id] = toks
    sess.admit(ps[3], budgets[3], request_id=3)
    _drain(sess, pol, outs)
    assert teng.step_keys - warm <= {("release",)}
    for rid in range(4):
        solo, _ = teng.generate(ps[rid][None], budgets[rid], pol,
                                gamma_max=GMAX)
        assert len(outs[rid]) == budgets[rid]
        np.testing.assert_array_equal(outs[rid], solo[0, :budgets[rid]])


def _serve(teng, reqs, **kw):
    srv = SpecDecodeServer(teng, StaticWindowPolicy(3), ServerConfig(
        max_batch=2, pad_to=4, **kw))
    for r in reqs:
        srv.submit(dataclasses.replace(r))
    return srv, {r.request_id: r for r in srv.run()}


@pytest.fixture(scope="module")
def requests():
    rng = np.random.default_rng(0)
    return [ServeRequest(i, rng.integers(0, 128, int(rng.integers(5, 14)))
                         .astype(np.int32), int(rng.integers(4, 9)),
                         arrival_s=0.01 * i) for i in range(6)]


def test_server_schema_and_paged_equals_dense(pair, requests):
    """Six requests served end to end with cursor-true payloads and
    arrival-anchored timing; the paged server (pool below dense parity, so
    admission waits on blocks) commits the dense server's tokens."""
    _, teng = pair["noised"]
    srv, dense = _serve(teng, requests)
    assert set(dense) == set(range(6))
    for r in requests:
        got = dense[r.request_id]
        assert len(got.tokens) == r.max_new_tokens
        assert (got.tokens >= 0).all() and (got.tokens < 128).all()
        assert 0.0 <= got.queue_ms <= got.ttft_ms <= got.e2e_ms
        assert got.tpot_ms > 0 and got.pair_id == "pair0"
    summ = srv.pair_summaries()["pair0"]
    assert summ["requests"] == 6 and summ["iterations"] > 0
    sess = srv._sessions[0]
    parity = sess.capacity * sess._n_logical()
    psrv, paged = _serve(teng, requests, paged_kv=True,
                         kv_pool_blocks=int(0.6 * parity))
    for rid in dense:
        np.testing.assert_array_equal(paged[rid].tokens, dense[rid].tokens)
    assert psrv.pair_summaries()["pair0"]["free_kv_blocks"] == \
        int(0.6 * parity)


def test_int8_paged_session_serves(pair, requests):
    """int8 K/V pools (approximate attention) serve complete in-range
    outputs through the same session path."""
    _, teng = pair["noised"]
    _, res = _serve(teng, requests, paged_kv=True, kv_quantize=True)
    for r in requests:
        got = res[r.request_id].tokens
        assert len(got) == r.max_new_tokens
        assert (got >= 0).all() and (got < 128).all()


def test_two_pairs_round_robin_and_drain(pair, requests):
    """Round-robin spreads the stream over two pairs and every request
    keeps its one-pair tokens; a drained pair admits nothing."""
    _, teng = pair["noised"]
    _, one = _serve(teng, requests)
    mk = lambda: [ServingPair(f"p{i}", teng, StaticWindowPolicy(3))
                  for i in range(2)]
    srv = SpecDecodeServer(cfg=ServerConfig(max_batch=2, pad_to=4),
                           pairs=mk(), router=RoundRobinPairRouter())
    for r in requests:
        srv.submit(dataclasses.replace(r))
    res = {r.request_id: r for r in srv.run()}
    assert {r.pair_id for r in res.values()} == {"p0", "p1"}
    for rid in one:
        np.testing.assert_array_equal(res[rid].tokens, one[rid].tokens)
    srv = SpecDecodeServer(cfg=ServerConfig(max_batch=2, pad_to=4),
                           pairs=mk())
    srv.drain("p0")
    for r in requests[:3]:
        srv.submit(dataclasses.replace(r))
    assert {r.pair_id for r in srv.run()} == {"p1"}
    assert srv.pair_summaries()["p0"]["requests"] == 0


def test_launcher_runs_on_cpu(capsys):
    assert serve.main(["--device", "cpu", "--requests", "3", "--max-new",
                       "5", "--gamma-max", "4", "--json"]) == 0
    assert '"requests": 3' in capsys.readouterr().out


def test_unported_features_name_their_roadmap_items(pair):
    _, teng = pair["random"]
    # sampled decoding (A8) is ported; tree sessions stay greedy-only
    sampled = SpecDecodeEngine(teng.draft_cfg, teng.target_cfg,
                               draft_params=teng.draft_params,
                               target_params=teng.target_params,
                               temperature=0.7, device="cpu")
    with pytest.raises(ValueError, match="greedy-only"):
        DecodeSession(sampled, capacity=1, max_new_cap=4, max_branches=2)
    with pytest.raises(NotImplementedError, match="A9"):
        DecodeSession(teng, capacity=1, max_new_cap=4,
                      mode_policy="pipeline")
    # tree speculation (A10) is ported: its policy and session construct
    assert make_window_policy("awc", max_branches=2).max_branches == 2
    sess = DecodeSession(teng, capacity=1, max_new_cap=4, max_branches=2)
    assert sess.max_branches == 2
    with pytest.raises(NotImplementedError, match="A9"):
        teng.generate(np.zeros((1, 4), np.int32), 4, transport=object())
