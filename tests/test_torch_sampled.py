"""The port's sampled speculative decoding (temperature > 0), held against
the JAX reference on the same numpy inputs and bridged weights (tiny
float32 dense pair: d_model 64, 2 layers, vocab 128; γ_max 4).

What is exact: the plain versions of the kernel pair B3 and the glue
``verify_window_fused`` against the reference's Pallas kernels in interpret
mode and its oracle ``verify_reference`` (accept counts, accept masks,
next tokens, p/q at the draft tokens), the engine rule's masked acceptance
for every active γ, and the Gumbel-max sampler with the reference's noise
injected. The residual mass is a float32 sum in another order: within
1e-6. What holds in distribution only (torch cannot reproduce threefry):
acceptance rates (within 4 binomial standard errors of the reference
engine's), Eq. 1, and the first committed token's marginal (chi-square).
The CUDA kernels are held against these plain versions on the card by
``chip_smoke.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from repro.configs.base import ModelConfig as JCfg
from repro.core import specdec as jsd
from repro.core.engine import SpecDecodeEngine as JEngine
from repro.core.session import DecodeSession as JSession
from repro.core.window import StaticWindowPolicy as JStatic
from repro.kernels.verify import verify_reference as j_verify_reference
from repro.kernels.verify import verify_window_fused as j_fused
from repro.kernels.verify.verify import cdf_sample_call, gather_reduce_call
from repro.models.model import Model as JModel
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import ModelConfig as TCfg
from repro_torch.core import specdec as tsd
from repro_torch.core.engine import SpecDecodeEngine
from repro_torch.core.session import DecodeSession
from repro_torch.core.window import StaticWindowPolicy, WindowDecision
from repro_torch.kernels.verify import (cdf_sample, cdf_sample_plain,
                                        gather_reduce, gather_reduce_plain,
                                        verify_reference, verify_window_fused)
from repro_torch.launch import serve
from repro_torch.serving import ServeRequest, ServerConfig, SpecDecodeServer

CFG = dict(arch_type="dense", n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=2, d_ff=128, vocab=128, head_dim=16, dtype="float32",
           remat=False)
TARGET = dict(name="tiny-target", qk_norm=True)
GMAX = 4
MAX_NEW = 12
TEMP = 1.0
TILE = 512                      # the Pallas kernels' vocab tile

t = torch.from_numpy


def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _window(B, G, V, seed, same_rows=None):
    """p (B, G+1, V), q (B, G, V) softmaxes of scaled normals, q == p on the
    first ``same_rows`` rows (the accept path), draft tokens drawn from q,
    u (B, G), r (B,) — all numpy, from ``seed``."""
    rng = np.random.default_rng(seed)
    p = _softmax(2 * rng.normal(size=(B, G + 1, V)))
    q = _softmax(2 * rng.normal(size=(B, G, V)))
    h = B // 2 if same_rows is None else same_rows
    q[:h] = p[:h, :G]
    cdf = np.cumsum(q.astype(np.float64), -1)
    toks = (cdf < rng.random((B, G, 1))).sum(-1).clip(0, V - 1)
    u = rng.random((B, G)).astype(np.float32)
    r = rng.random(B).astype(np.float32)
    return toks.astype(np.int32), q, p, u, r


def _pad(x):
    pad = (-x.shape[-1]) % TILE
    return jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (0, pad)))


def _assert_out_equal(got, want):
    for name in ("n_accepted", "next_token", "accept_mask"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


# ------------------------------------------------- kernel pair and glue

@pytest.mark.parametrize("B,G,V", [(4, 4, 1024), (2, 6, 2000)])
def test_plain_pair_and_glue_match_pallas_interpret(B, G, V):
    toks, q, p, u, r = _window(B, G, V, seed=V)
    pa, qa, ma = gather_reduce_call(jnp.asarray(toks), _pad(p), _pad(q),
                                    TILE, interpret=True)
    tp, tq, tm = gather_reduce_plain(t(toks), t(p), t(q))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(pa))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(qa))
    np.testing.assert_allclose(tm.numpy(), np.asarray(ma), rtol=0,
                               atol=1e-6)
    # pass B on every (row, branch) pairing, thresholds inside the CDF
    rng = np.random.default_rng(V + 1)
    for use in (0, 1):
        jrow = rng.integers(0, G + 1, B).astype(np.int32)
        qrow = np.minimum(jrow, G - 1).astype(np.int32)
        use_p = np.full(B, use, np.int32)
        tot = np.where(use, 1.0, np.asarray(ma)[np.arange(B), qrow])
        thresh = (rng.random(B) * tot).astype(np.float32)
        want = cdf_sample_call(jnp.asarray(jrow), jnp.asarray(qrow),
                               jnp.asarray(use_p), _pad(p), _pad(q),
                               jnp.asarray(thresh)[:, None], TILE,
                               interpret=True)[:, 0]
        got = cdf_sample_plain(t(jrow), t(qrow), t(use_p), t(p), t(q),
                               t(thresh))
        np.testing.assert_array_equal(got.numpy(),
                                      np.minimum(np.asarray(want), V - 1))
    _assert_out_equal(
        verify_window_fused(t(toks), t(q), t(p), t(u), t(r)),
        j_fused(jnp.asarray(toks), jnp.asarray(q), jnp.asarray(p),
                jnp.asarray(u), jnp.asarray(r), interpret=True))


def test_glue_matches_oracle_at_v50304():
    B, G, V = 2, 8, 50304
    toks, q, p, u, r = _window(B, G, V, seed=7)
    want = j_verify_reference(*map(jnp.asarray, (toks, q, p, u, r)))
    _assert_out_equal(verify_window_fused(t(toks), t(q), t(p), t(u), t(r)),
                      want)
    _assert_out_equal(verify_reference(t(toks), t(q), t(p), t(u), t(r)),
                      want)
    p_at, q_at, mass = gather_reduce_plain(t(toks), t(p), t(q))
    ii = np.arange(G)[None, :]
    bb = np.arange(B)[:, None]
    np.testing.assert_array_equal(p_at.numpy(), p[bb, ii, toks])
    np.testing.assert_array_equal(q_at.numpy(), q[bb, ii, toks])
    res = np.maximum(p[:, :G].astype(np.float64) - q, 0).sum(-1)
    np.testing.assert_allclose(mass.numpy(), res, rtol=0, atol=1e-6)


@pytest.mark.parametrize("ag", range(GMAX + 1))
def test_masked_acceptance_matches_engine_rule(ag):
    """The glue's active-γ masking against the reference engine rule
    ``specdec.verify_window`` (u from its key's own split): equal accept
    counts and masks; the next token is the oracle's on the window cut to
    ag, and at ag = 0 (a fused round) the inverse CDF of p row 0."""
    B, G, V = 6, GMAX, 300
    toks, q, p, _, r = _window(B, G, V, seed=20 + ag, same_rows=4)
    key = jax.random.PRNGKey(ag)
    ku, _ = jax.random.split(key)
    u = np.array(jax.random.uniform(ku, (B, G)))
    ref = jsd.verify_window(key, jnp.asarray(toks), jnp.asarray(q),
                            jnp.asarray(p), active_gamma=ag)
    for agt in (torch.tensor(ag, dtype=torch.int32),
                torch.full((B,), ag, dtype=torch.int32)):
        got = verify_window_fused(t(toks), t(q), t(p), t(u), t(r),
                                  active_gamma=agt)
        np.testing.assert_array_equal(got.n_accepted.numpy(),
                                      np.asarray(ref.n_accepted))
        np.testing.assert_array_equal(got.accept_mask.numpy(),
                                      np.asarray(ref.accept_mask))
        if ag:
            cut = j_verify_reference(
                jnp.asarray(toks[:, :ag]), jnp.asarray(q[:, :ag]),
                jnp.asarray(p[:, :ag + 1]), jnp.asarray(u[:, :ag]),
                jnp.asarray(r))
            want = np.asarray(cut.next_token)
        else:
            cdf = np.cumsum(p[:, 0].astype(np.float64), -1)
            want = (cdf <= r[:, None]).sum(-1).clip(max=V - 1)
        np.testing.assert_array_equal(got.next_token.numpy(), want)


def test_sample_from_probs_matches_categorical():
    rng = np.random.default_rng(3)
    probs = _softmax(3 * rng.normal(size=(64, 257)))
    probs[0, :200] = 0.0                     # clamped to 1e-20 in the log
    for s in range(3):
        key = jax.random.PRNGKey(s)
        g = np.array(jax.random.gumbel(key, probs.shape, jnp.float32))
        want = jax.random.categorical(
            key, jnp.log(jnp.maximum(jnp.asarray(probs), 1e-20)), axis=-1)
        got = tsd.sample_from_probs(t(probs), gumbel=t(g))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _edge_window(case):
    B, G, V = 4, 4, 1024
    toks, q, p, u, r = _window(B, G, V, seed=11)
    if case == "zero-mass residual":         # p == q at the reject row
        u[:] = 1.0 - 2.0 ** -24
        q[:, 0] = p[:, 0]
        toks[:, 0] = 0
        p[:, 0, 0], q[:, 0, 0] = 0.0, 0.5    # reject at 0 …
        q[:, 0, 1:] = p[:, 0, 1:] * (0.5 / p[:, 0, 1:].sum())
        p[:, 0] = np.minimum(p[:, 0], q[:, 0])   # … with an empty residual
    elif case == "all-zero p row":
        u[:] = 1.0 - 2.0 ** -24
        p[:, 0] = 0.0                        # reject at 0, residual 0, p 0
    elif case == "u and r at 0":
        u[:], r[:] = 0.0, 0.0
    elif case == "r at 1 - 2^-24":
        r[:] = 1.0 - 2.0 ** -24
    elif case == "tokens outside [0, V)":
        toks[0, 0], toks[1, 1], toks[2, 0] = -1, V, V + 600
    return toks, q, p, u, r


@pytest.mark.parametrize("case", [
    "zero-mass residual", "all-zero p row", "u and r at 0",
    "r at 1 - 2^-24", "tokens outside [0, V)"])
def test_edge_cases_match_pallas_interpret(case):
    toks, q, p, u, r = _edge_window(case)
    got = verify_window_fused(t(toks), t(q), t(p), t(u), t(r))
    _assert_out_equal(got, j_fused(*map(jnp.asarray, (toks, q, p, u, r)),
                                   interpret=True))
    if case == "all-zero p row":
        assert (got.next_token.numpy() == p.shape[-1] - 1).all()
    if case == "tokens outside [0, V)":
        p_at, q_at, _ = gather_reduce_plain(t(toks), t(p), t(q))
        assert p_at[0, 0] == q_at[0, 0] == p_at[1, 1] == p_at[2, 0] == 0


def test_bf16_inputs_equal_their_float32_values():
    """bf16 probabilities go through the same f32 arithmetic as their
    widened values, in the plain pair and in the reference's kernels."""
    toks, q, p, u, r = _window(3, 4, 1024, seed=5)
    pb = torch.from_numpy(p).to(torch.bfloat16)
    qb = torch.from_numpy(q).to(torch.bfloat16)
    for a, b in zip(gather_reduce_plain(t(toks), pb, qb),
                    gather_reduce_plain(t(toks), pb.float(), qb.float())):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    got = verify_window_fused(t(toks), qb, pb, t(u), t(r))
    _assert_out_equal(got, verify_window_fused(t(toks), qb.float(),
                                               pb.float(), t(u), t(r)))
    jb = lambda x: jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    _assert_out_equal(got, j_fused(jnp.asarray(toks), jb(qb), jb(pb),
                                   jnp.asarray(u), jnp.asarray(r),
                                   interpret=True))


def test_wrappers_refuse_other_devices():
    z = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        gather_reduce(z, z, z)
    with pytest.raises(ValueError, match="cuda or cpu"):
        cdf_sample(z[0], z[0], z[0], z, z, z[0])


# ------------------------------------------- the rule in distribution

def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def test_identical_distributions_accept_everything():
    B, G, V = 8, 5, 64
    rng = np.random.default_rng(0)
    p = t(_softmax(rng.normal(size=(B, G + 1, V))))
    q = p[:, :G].contiguous()
    toks = tsd.sample_from_probs(q, _gen(1))
    res = tsd.verify_window(_gen(2), toks, q, p)
    assert (res.n_accepted == G).all() and (res.num_new == G + 1).all()


def test_disjoint_supports_reject_immediately():
    B, G, V = 4, 4, 32
    q = torch.full((B, G, V), 1e-9)
    q[:, :, 0] = 1.0
    p = torch.full((B, G + 1, V), 1e-9)
    p[:, :, V - 1] = 1.0
    res = tsd.verify_window(_gen(0), torch.zeros((B, G), dtype=torch.int32),
                            q, p)
    assert (res.n_accepted == 0).all() and (res.next_token == V - 1).all()


def test_empirical_acceptance_matches_eq1():
    """p(t)/q(t) = α at every drafted token: mean tokens per round within
    5 % of Eq. (1)."""
    alpha, G, V, N = 0.7, 6, 128, 2000
    rng = np.random.default_rng(0)
    toks = rng.integers(0, V, (N, G))
    onehot = np.eye(V, dtype=np.float32)[toks]
    q = np.full((N, G, V), 1.0 / V, np.float32)
    p_g = (1 - onehot) * ((1 - alpha / V) / (V - 1)) + onehot * (alpha / V)
    p = np.concatenate([p_g, np.full((N, 1, V), 1.0 / V)], 1)
    res = tsd.verify_window(_gen(1), t(toks.astype(np.int32)), t(q),
                            t(p.astype(np.float32)))
    emp = float(res.num_new.float().mean())
    theory = float(jsd.expected_accepted(alpha, G))
    assert abs(emp - theory) / theory < 0.05, (emp, theory)


def test_first_committed_token_is_distributed_as_p0():
    """2^16 rows of one fixed (p, q) window at V 16: the first committed
    token (draft token 0 if accepted, else the resample) follows p_0."""
    N, G, V = 1 << 16, 4, 16
    rng = np.random.default_rng(9)
    p1 = _softmax(rng.normal(size=(G + 1, V)))
    q1 = _softmax(rng.normal(size=(G, V)))
    p = t(np.broadcast_to(p1, (N, G + 1, V)).copy())
    q = t(np.broadcast_to(q1, (N, G, V)).copy())
    toks = tsd.sample_from_probs(q, _gen(3))
    res = tsd.verify_window(_gen(4), toks, q, p)
    first = torch.where(res.n_accepted > 0, toks[:, 0], res.next_token)
    counts = np.bincount(first.numpy(), minlength=V)
    pval = stats.chisquare(counts, p1[0].astype(np.float64) * N).pvalue
    assert pval > 1e-4, (pval, counts)


# ------------------------------------------------------- engine level

def _target_np(seed=1):
    """Weights in the reference's parameter layout (shapes from
    ``jax.eval_shape`` of its ``init_params``), drawn with numpy at its
    init scales N(0, 1/fan_in); norm scales moved off zero."""
    shapes = jax.eval_shape(JModel(JCfg(**CFG, **TARGET)).init_params,
                            jax.random.PRNGKey(seed))
    fan_in = {"wo": CFG["n_heads"] * CFG["head_dim"], "w_down": CFG["d_ff"]}
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name in ("ln1", "ln2", "final_norm", "q_norm", "k_norm"):
            scale = 0.1
        else:
            scale = fan_in.get(name, CFG["d_model"]) ** -0.5
        return (scale * rng.normal(size=leaf.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _noised(p, scale, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (a + scale * a.std() * rng.normal(
        size=a.shape)).astype(a.dtype), p)


def _port(d_np, t_np, temp=TEMP):
    cfg = TCfg(**CFG, **TARGET)
    return SpecDecodeEngine(cfg, cfg, draft_params=params_from_numpy(d_np,
                                                                    "cpu"),
                            target_params=params_from_numpy(t_np, "cpu"),
                            temperature=temp, device="cpu")


@pytest.fixture(scope="module")
def weights():
    t_np = _target_np()
    return {"self": (t_np, t_np), "noised": (_noised(t_np, 0.5, 3), t_np)}


@pytest.fixture(scope="module")
def engines(weights):
    return {k: _port(*v) for k, v in weights.items()}


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(4)
    lens = np.array([9, 5, 12], np.int32)
    p = np.zeros((3, 12), np.int32)
    for i, n in enumerate(lens):
        p[i, :n] = rng.integers(0, 128, n)
    return p, lens


def test_self_speculation_accepts_everything(engines, prompts):
    p, lens = prompts
    toks, st = engines["self"].generate(p, MAX_NEW, StaticWindowPolicy(3),
                                        prompt_lens=lens, gamma_max=GMAX)
    assert st.acceptance_rate >= 0.99, st.acceptance_rate
    assert ((toks >= 0) & (toks < 128)).all()


def test_same_seed_same_tokens(engines, prompts):
    p, lens = prompts
    eng = engines["noised"]
    run = lambda s: eng.generate(p, MAX_NEW, StaticWindowPolicy(3),
                                 prompt_lens=lens, gamma_max=GMAX, seed=s)
    (a, sa), (b, sb), (c, _) = run(5), run(5), run(6)
    np.testing.assert_array_equal(a, b)
    assert sa.acceptance_seqs == sb.acceptance_seqs
    assert not np.array_equal(a, c)


@pytest.mark.parametrize("temp", [0.7, 1.0])
def test_acceptance_matches_reference_engine(weights, prompts, temp):
    """Same weights, prompts and temperature, independent draws: the port's
    acceptance rate lies within 4 binomial standard errors of the reference
    engine's (pooled over 4 seeds each)."""
    d_np, t_np = weights["noised"]
    jeng = JEngine(JCfg(**CFG, **TARGET), JCfg(**CFG, **TARGET),
                   draft_params=jax.tree.map(jnp.asarray, d_np),
                   target_params=jax.tree.map(jnp.asarray, t_np),
                   temperature=temp, key=jax.random.PRNGKey(0))
    port = _port(d_np, t_np, temp)
    p, lens = prompts
    counts = {"port": [0, 0], "ref": [0, 0]}
    for s in range(4):
        _, js = jeng.generate(p, 20, JStatic(3), prompt_lens=lens,
                              gamma_max=GMAX, key=jax.random.PRNGKey(s))
        _, ts = port.generate(p, 20, StaticWindowPolicy(3),
                              prompt_lens=lens, gamma_max=GMAX, seed=s)
        for k, st in (("ref", js), ("port", ts)):
            counts[k][0] += st.accepted
            counts[k][1] += st.proposed
    a_p, a_r = (a / n for a, n in counts.values())
    pooled = (counts["port"][0] + counts["ref"][0]) / (
        counts["port"][1] + counts["ref"][1])
    se = np.sqrt(pooled * (1 - pooled) * (1 / counts["port"][1]
                                          + 1 / counts["ref"][1]))
    assert 0.0 < pooled < 1.0
    assert abs(a_p - a_r) <= 4 * se, (a_p, a_r, se)


@pytest.mark.parametrize("temp", [0.7, 1.0])
def test_first_token_is_sampled_at_temperature(weights, temp):
    """The anchor token of a sampled prefill, over 2^13 copies of one
    prompt: the port's softmax at T equals the reference's on the same
    logits (rtol 1e-6), and the tokens follow the reference model's
    softmax(logits / T) (chi-square p > 1e-4) and not the other
    temperature's (p < 1e-4): T enters the anchor draw once."""
    _, t_np = weights["self"]
    N, L = 1 << 13, 9
    prompt = np.random.default_rng(4).integers(0, 128, L).astype(np.int32)
    jl, _ = JModel(JCfg(**CFG, **TARGET)).prefill(
        jax.tree.map(jnp.asarray, t_np), jnp.asarray(prompt[None]), 16)
    last = np.array(jl[0, -1])
    np.testing.assert_allclose(
        tsd._temperature_probs(t(last), temp).numpy(),
        np.asarray(jsd._temperature_probs(jnp.asarray(last), temp)),
        rtol=1e-6, atol=0)
    eng = _port(t_np, t_np, temp)
    st = eng._prefill(torch.as_tensor(np.broadcast_to(prompt, (N, L))
                                      .astype(np.int64)), 16,
                      generator=_gen(7))
    counts = np.bincount(st.last_token.numpy(), minlength=128)
    for tt in (0.7, 1.0):
        pe = np.asarray(jsd._temperature_probs(jnp.asarray(last), tt),
                        np.float64)
        pval = stats.chisquare(counts, pe / pe.sum() * N).pvalue
        assert (pval > 1e-4) if tt == temp else (pval < 1e-4), (tt, pval)


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


def test_changing_gamma_adds_no_step_key(weights, prompts):
    eng = _port(*weights["noised"])
    p, lens = prompts
    eng.generate(p, MAX_NEW, StaticWindowPolicy(GMAX), prompt_lens=lens)
    before = set(eng.step_keys)
    toks, st = eng.generate(p, MAX_NEW, _CyclePolicy(), prompt_lens=lens)
    assert eng.step_keys == before == {("fused", GMAX)}
    assert len(set(st.gamma_seq)) > 2
    assert ((toks >= 0) & (toks < 128)).all()
    assert (st.produced == MAX_NEW).all()


def _serve(eng, reqs, **kw):
    srv = SpecDecodeServer(eng, StaticWindowPolicy(3), ServerConfig(
        max_batch=2, pad_to=4, **kw))
    for r in reqs:
        srv.submit(dataclasses.replace(r))
    return {r.request_id: r for r in srv.run()}


@pytest.fixture(scope="module")
def requests():
    rng = np.random.default_rng(0)
    return [ServeRequest(i, rng.integers(0, 128, int(rng.integers(5, 14)))
                         .astype(np.int32), int(rng.integers(4, 9)),
                         arrival_s=0.01 * i) for i in range(6)]


@pytest.mark.parametrize("quant", [False, True])
def test_paged_sampled_sessions_serve(engines, requests, quant):
    """Paged (fp: the dense server's tokens, draw for draw) and int8-paged
    sampled sessions serve complete in-range outputs."""
    eng = engines["noised"]
    paged = _serve(eng, requests, paged_kv=True, kv_quantize=quant)
    dense = _serve(eng, requests) if not quant else None
    for r in requests:
        got = paged[r.request_id].tokens
        assert len(got) == r.max_new_tokens
        assert (got >= 0).all() and (got < 128).all()
        if dense is not None:
            np.testing.assert_array_equal(got, dense[r.request_id].tokens)


def test_launcher_samples_on_cpu(capsys):
    assert serve.main(["--device", "cpu", "--requests", "3", "--max-new",
                       "5", "--gamma-max", "4", "--temperature", "0.7",
                       "--json"]) == 0
    out = capsys.readouterr().out
    assert '"requests": 3' in out and '"temperature": 0.7' in out


def test_tree_with_temperature_raises_as_in_reference(weights, engines):
    d_np, t_np = weights["noised"]
    jeng = JEngine(JCfg(**CFG, **TARGET), JCfg(**CFG, **TARGET),
                   draft_params=jax.tree.map(jnp.asarray, d_np),
                   target_params=jax.tree.map(jnp.asarray, t_np),
                   temperature=TEMP)
    with pytest.raises(ValueError, match="greedy-only"):
        JSession(jeng, capacity=1, max_new_cap=4, max_branches=2)
    with pytest.raises(ValueError, match="greedy-only"):
        DecodeSession(engines["noised"], capacity=1, max_new_cap=4,
                      max_branches=2)
    with pytest.raises(NotImplementedError, match="greedy-only"):
        engines["noised"]._tree_step(GMAX, 2)


def test_capture_traces_are_acceptance_bits(engines, prompts):
    p, lens = prompts
    seqs = engines["noised"].capture_traces(p[:, :5], 8, gamma=3, seed=1)
    assert len(seqs) == 3
    assert all(set(s) <= {0, 1} and len(s) > 0 for s in seqs)
