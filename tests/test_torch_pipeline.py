"""The port's pipelined mode (``DecodeSession(mode_policy="pipeline")``)
against the JAX reference's, on the CPU, on bridged weights.

The pair is a noised copy: the draft is the target plus N(0, (0.02·std)²)
per tensor (numpy draws), γ_max 6, budgets up to 32, three requests
admitted per slot. Every port run is held to the reference's pipelined
session on the same weights:

- the committed tokens per request, which also equal the reference's
  half-duplex stream;
- ``pipeline_hits`` and ``pipeline_misses`` (both > 0), ``gamma_seq`` and
  the rounds;
- every window posted, discarded ones included (tokens, γ, round id,
  ``speculative``), recorded by wrapping ``post_window`` — which holds the
  draft's cursor rule: a speculative window proposed from anything but the
  predicted anchor and start would differ;
- on the emulated link the unhidden link ms, with the transports' clock
  frozen to its virtual part (compute takes no time), so the overlap the
  protocol buys is a function of the message sequence alone.

Families: dense, paged (block size 4), int8 paged and ssm on in-process,
emulated-on-the-virtual-clock and socket-loopback transports; the hybrid
(a Mamba2 backbone with a shared attention block) in-process and on the
link. Then the host
mirror of ``slot_stop_mask`` against the device rule, EOS and budgets that
end inside a window, AWC's ``pipe_hit_recent`` feature, the step keys and
captured steps flat over hits and misses, the constructor gates, sampled
self-speculation and the launcher.

Equality is exact unless a test states a tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JCfg
from repro.core.engine import SpecDecodeEngine as JEngine
from repro.core.session import DecodeSession as JSession
from repro.core.window import AWCWindowPolicy as JAWC
from repro.core.window import StaticWindowPolicy as JStatic
from repro.distributed import EmulatedLinkTransport as JEmulated
from repro.distributed import InProcessTransport as JInProcess
from repro.models.model import Model as JModel
from repro.sim.network import LinkSpec as JLinkSpec
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import ModelConfig as TCfg
from repro_torch.core.engine import SpecDecodeEngine
from repro_torch.core.session import DecodeSession, predict_verdict
from repro_torch.core.specdec import slot_stop_mask
from repro_torch.core.window import AWCWindowPolicy, StaticWindowPolicy
from repro_torch.distributed import (EmulatedLinkTransport,
                                     InProcessTransport, SocketTransport)
from repro_torch.launch import serve
from repro_torch.sim.network import LinkSpec

DENSE = dict(name="t", arch_type="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, d_ff=128, vocab=128, head_dim=16,
             dtype="float32", remat=False, qk_norm=True)
SSM = dict(name="ts", arch_type="ssm", n_layers=2, d_model=64, n_heads=0,
           n_kv_heads=0, d_ff=0, vocab=128, ssm_state=16, ssm_head_dim=16,
           ssm_chunk=8, dtype="float32", remat=False, tie_embeddings=True)
# the tiny hybrid of tests/test_torch_ssm.py
HYBRID = dict(name="th", arch_type="hybrid", n_layers=4, d_model=64,
              n_heads=4, n_kv_heads=4, d_ff=128, head_dim=16, vocab=128,
              ssm_state=16, ssm_head_dim=16, ssm_chunk=8, attn_every=2,
              dtype="float32", remat=False)
NOISE = 0.02
GMAX = 6
CAP = 32
BUDGETS = (32, 27, 30)
SYNC = 4
LINK = dict(rtt_ms=20.0, jitter_ms=1.6)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's tiny models: faster than many,
    and the suite's parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def noised_pair(kw, seed: int = 2, noise: float = NOISE):
    """(reference engine, port engine) on one set of weights: a target
    drawn by the reference and a draft that is its noised copy."""
    t_np = jax.device_get(JModel(JCfg(**kw)).init_params(
        jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    d_np = jax.tree.map(lambda a: (a + noise * a.std() * rng.normal(
        size=a.shape)).astype(a.dtype) if a.ndim else a, t_np)
    jeng = JEngine(JCfg(**kw), JCfg(**kw),
                   draft_params=jax.tree.map(jnp.asarray, d_np),
                   target_params=jax.tree.map(jnp.asarray, t_np),
                   temperature=0.0, key=jax.random.PRNGKey(0))
    teng = SpecDecodeEngine(TCfg(**kw), TCfg(**kw),
                            draft_params=params_from_numpy(d_np, "cpu"),
                            target_params=params_from_numpy(t_np, "cpu"),
                            device="cpu")
    return jeng, teng


@pytest.fixture(scope="module")
def engines():
    return {"dense": noised_pair(DENSE), "ssm": noised_pair(SSM),
            "hybrid": noised_pair(HYBRID)}


PROMPTS = [np.random.default_rng(4).integers(0, 128, n).astype(np.int32)
           for n in (9, 5, 12)]


def frozen_clock(tr):
    """Freeze a transport's clock to its virtual part: compute takes no
    time, so every wait is decided by the message sequence alone."""
    tr._now_s = lambda: tr._voffset_s
    return tr


def transport(pkg: str, kind: str):
    if kind == "inproc":
        return InProcessTransport() if pkg == "port" else JInProcess()
    if kind == "socket":
        return SocketTransport.loopback()
    link = (LinkSpec if pkg == "port" else JLinkSpec)(**LINK)
    cls = EmulatedLinkTransport if pkg == "port" else JEmulated
    return frozen_clock(cls(link, seed=0, sleep=False))


def record_windows(tr) -> list:
    """Wrap ``post_window``: every window posted, discarded ones included."""
    log, post = [], tr.post_window

    def wrapped(msg):
        log.append((np.asarray(msg.tokens).tolist(), msg.gamma, msg.round_id,
                    msg.speculative))
        return post(msg)

    tr.post_window = wrapped
    return log


def drive(pkg, eng, tr, mode="pipeline", policy=None, layout="dense",
          budgets=BUDGETS, eos_id=-1, on_chunk=None):
    """Admit the three prompts one per slot, run chunks to the end, retire;
    returns (tokens by request, session, posted windows). ``on_chunk``
    takes each chunk's hit flags (port, static policy: the feature list is
    emptied before every chunk)."""
    Session = DecodeSession if pkg == "port" else JSession
    kw = {} if pkg == "port" else {"key": jax.random.PRNGKey(0)}
    sess = Session(eng, capacity=3, max_new_cap=CAP, max_prompt_len=12,
                   gamma_max=GMAX, sync_every=SYNC, eos_id=eos_id,
                   transport=tr, mode_policy=mode,
                   paged=layout != "dense", kv_block_size=4,
                   kv_quantize=layout == "int8", **kw)
    log = record_windows(tr) if tr is not None else []
    for i, p in enumerate(PROMPTS):
        sess.admit(p, budgets[i], request_id=i)
    if policy is None:
        policy = (StaticWindowPolicy if pkg == "port" else JStatic)(4)
    while sess.unfinished:
        if on_chunk is not None:
            sess._pipe_recent.clear()
        sess.run_chunk(policy)
        if on_chunk is not None:
            on_chunk([bool(h) for h in sess._pipe_recent])
    out = {}
    for j in list(sess.occupied):
        toks, rec = sess.retire(j)
        out[rec.request_id] = np.asarray(toks).tolist()
    return out, sess, log


_REF: dict = {}


def reference(engines, family, layout="dense", **kw):
    """The reference's pipelined run over the frozen-clock link and its
    half-duplex in-process run (cached per case)."""
    key = (family, layout, tuple(sorted(kw.items())))
    if key not in _REF:
        jeng = engines[family][0]
        _REF[key] = (drive("ref", jeng, transport("ref", "link"),
                           layout=layout, **kw),
                     drive("ref", jeng, transport("ref", "inproc"),
                           mode="distributed", layout=layout, **kw)[0])
    return _REF[key]


CASES = [(family, layout, kind)
         for family, layout in (("dense", "dense"), ("dense", "paged"),
                                ("dense", "int8"), ("ssm", "dense"))
         for kind in ("inproc", "link", "socket")] + [
    ("hybrid", "dense", kind) for kind in ("inproc", "link")]


@pytest.mark.parametrize("family,layout,kind", CASES,
                         ids=["-".join(c) for c in CASES])
def test_pipeline_matches_reference(engines, family, layout, kind):
    (jtok, jsess, jlog), jhalf = reference(engines, family, layout)
    tr = transport("port", kind)
    tok, sess, log = drive("port", engines[family][1], tr, layout=layout)
    assert tok == jtok == jhalf
    assert (sess.pipeline_hits, sess.pipeline_misses) == \
        (jsess.pipeline_hits, jsess.pipeline_misses)
    assert sess.pipeline_hits > 0 and sess.pipeline_misses > 0
    assert sess.gamma_seq == jsess.gamma_seq
    assert sess.iterations == jsess.iterations
    assert log == jlog
    assert sum(1 for w in log if w[3]) > 0
    # every posted window was verified (one per round) or discarded
    assert len(log) == sess.iterations + tr.discarded_messages
    assert tr.discarded_messages > 0
    if kind == "link":
        assert sess.link_ms == jsess.link_ms
    _, stats = sess.snapshot()
    assert (stats.pipeline_hits, stats.pipeline_misses) == \
        (sess.pipeline_hits, sess.pipeline_misses)
    if kind == "socket":
        tr.close()


def spurious_misses(log, verdicts, hits) -> int:
    """Misses of a window whose proposals were all right (every live row
    accepted γ and committed proposal γ as its bonus): the prediction can
    only have differed through the host's stop mirror."""
    by_rid = {w[2]: w for w in log}
    done = np.zeros(3, bool)
    n = 0
    for v, hit in zip(verdicts, hits):
        toks, gamma = np.asarray(by_rid[v["round_id"]][0]), \
            by_rid[v["round_id"]][1]
        live = ~done
        right = (np.all(v["n_accepted"][live] == gamma)
                 and np.all(v["next_token"][live] == toks[live, gamma]))
        n += int(right and not hit)
        done = v["done"]
    return n


@pytest.mark.parametrize("case", ["eos", "budgets"])
def test_stop_prediction_at_eos_and_budget(engines, case):
    """EOS taken from the greedy stream, and budgets that end inside a
    window: the port's hits, misses, windows and tokens equal the
    reference's, and the host's stop prediction causes no spurious miss
    (verdicts recorded off the wire, hit flags per round)."""
    jeng, teng = engines["dense"]
    kw = {}
    if case == "eos":
        base, _, _ = drive("port", teng, transport("port", "inproc"))
        kw["eos_id"] = int(base[1][7])
    else:
        kw["budgets"] = (7, 11, 13)
    (jtok, jsess, jlog), jhalf = reference(engines, "dense", **kw)
    tr = transport("port", "link")
    verdicts, post_v = [], tr.post_verdict

    def wrapped(msg):
        verdicts.append(dict(round_id=msg.round_id,
                             n_accepted=msg.n_accepted.copy(),
                             next_token=msg.next_token.copy(),
                             done=msg.done.copy()))
        return post_v(msg)

    tr.post_verdict = wrapped
    hits = []
    tok, sess, log = drive("port", teng, tr, on_chunk=hits.extend, **kw)
    assert tok == jtok == jhalf
    assert log == jlog
    assert (sess.pipeline_hits, sess.pipeline_misses) == \
        (jsess.pipeline_hits, jsess.pipeline_misses)
    assert len(hits) == len(verdicts) == sess.iterations
    assert sum(hits) == sess.pipeline_hits
    assert spurious_misses(log, verdicts, hits) == 0
    if case == "eos":
        assert any(kw["eos_id"] in t[1:] and len(t) < CAP
                   for t in tok.values())
    else:
        assert [len(tok[i]) for i in range(3)] == [7, 11, 13]


def test_predict_verdict_mirrors_slot_stop_mask():
    """The host's optimistic verdict equals the device rule applied to the
    all-accepted window with proposal γ as the bonus, at random budgets,
    cursors, done flags and EOS positions."""
    rng = np.random.default_rng(0)
    for trial in range(200):
        B, G = 5, 6
        gamma = int(rng.integers(1, G))
        toks = rng.integers(0, 6, (B, G)).astype(np.int32)
        last = rng.integers(0, 6, B).astype(np.int32)
        done = rng.random(B) < 0.3
        max_new = rng.integers(1, 12, B).astype(np.int32)
        cursor = rng.integers(0, 12, B).astype(np.int32)
        eos = int(rng.integers(-1, 6))
        num, dn, lt = predict_verdict(toks, last, gamma, done, cursor,
                                      max_new, eos)
        committed = np.full((B, G + 1), -1, np.int32)
        committed[:, :gamma + 1] = toks[:, :gamma + 1]
        t = lambda a: torch.as_tensor(np.asarray(a))
        stop = slot_stop_mask(t(np.full(B, gamma + 1, np.int32)),
                              t(np.full(B, gamma, np.int32)), t(committed),
                              t(cursor), t(max_new), t(done),
                              torch.tensor(eos, dtype=torch.int32))
        np.testing.assert_array_equal(num, stop.num_new.numpy())
        np.testing.assert_array_equal(dn, stop.done.numpy())
        np.testing.assert_array_equal(
            lt, np.where(done, last, toks[:, gamma]))


class Recorder:
    """AWC predictor that records ``pipe_hit_recent`` (feature 5) and
    decides from acceptance and hit rate only (wall-clock TPOT would
    differ between the packages)."""

    def __init__(self):
        self.seen = []

    def __call__(self, feats):
        self.seen.append(round(float(feats[5]), 12))
        return 2.0 + 3.0 * float(feats[1]) + 2.0 * float(feats[5])


def test_awc_pipe_hit_feature_matches_reference(engines):
    """AWC under pipeline: the ``pipe_hit_recent`` sequence the predictor
    sees, the γ it picks and the tokens equal the reference's; the
    half-duplex mode reports 0."""
    jeng, teng = engines["dense"]
    jrec, trec = Recorder(), Recorder()
    jtok, jsess, _ = drive("ref", jeng, transport("ref", "link"),
                           policy=JAWC(jrec))
    tok, sess, _ = drive("port", teng, transport("port", "link"),
                         policy=AWCWindowPolicy(trec))
    assert tok == jtok
    assert trec.seen == jrec.seen and max(trec.seen) > 0.0
    assert sess.gamma_seq == jsess.gamma_seq
    hd = Recorder()
    drive("port", teng, transport("port", "link"), mode="distributed",
          policy=AWCWindowPolicy(hd))
    assert set(hd.seen) == {0.0}


@pytest.mark.parametrize("family", ["dense", "ssm"])
def test_steps_flat_over_hits_and_misses(engines, family):
    """The pipelined session's worker steps (one captured graph each on
    the card) and the engine's step keys: attention draft propose,
    speculative propose, verify; a recurrent draft adds the checkpoint and
    the rollback. A second session with other budgets (other hits and
    misses) adds nothing."""
    teng = engines[family][1]
    _, sess, _ = drive("port", teng, transport("port", "link"))
    keys = teng.step_programs()
    names = set(sess._wire["steps"])
    want = {"propose", "propose_spec", "verify"}
    if family == "ssm":
        want |= {"checkpoint", "rollback"}
    assert names == want
    assert sess.pipeline_hits > 0 and sess.pipeline_misses > 0
    _, sess2, _ = drive("port", teng, transport("port", "link"),
                        budgets=(9, 31, 20))
    assert set(sess2._wire["steps"]) == want
    assert teng.step_programs() == keys
    assert (sess2.pipeline_hits, sess2.pipeline_misses) != \
        (sess.pipeline_hits, sess.pipeline_misses)


GATES = {"no transport": dict(transport=None),
         "gamma_max 1": dict(gamma_max=1),
         "tree": dict(max_branches=2)}


@pytest.mark.parametrize("gate", sorted(GATES))
def test_constructor_gates_match_reference(engines, gate):
    """Pipeline needs a transport and γ_max ≥ 2 and refuses trees: the
    port raises where the reference does."""
    jeng, teng = engines["dense"]
    for pkg, eng, exc in (("ref", jeng, (AssertionError, ValueError)),
                          ("port", teng, ValueError)):
        kw = dict(transport=transport(pkg, "inproc"), gamma_max=GMAX)
        kw.update(GATES[gate])
        Session = DecodeSession if pkg == "port" else JSession
        with pytest.raises(exc):
            Session(eng, capacity=2, max_new_cap=8, max_prompt_len=8,
                    mode_policy="pipeline", **kw)


def test_sampled_self_speculation_pipeline():
    """T = 1.0, the draft the target itself: every proposal is accepted
    (acceptance ≥ 0.99; budget 21 = 1 + 4 full windows of γ 4, so no
    budget clamp counts against it), while the bonus guess is an
    independent draw, so most speculative windows miss; one seed fixes the
    stream (two runs equal), another seed changes it."""
    t_np = jax.device_get(JModel(JCfg(**DENSE)).init_params(
        jax.random.PRNGKey(5)))
    params = lambda: params_from_numpy(t_np, "cpu")
    eng = SpecDecodeEngine(TCfg(**DENSE), TCfg(**DENSE),
                           draft_params=params(), target_params=params(),
                           temperature=1.0, device="cpu")
    p = np.stack([PROMPTS[0], PROMPTS[2][:9]])
    runs = []
    for seed in (3, 3, 4):
        tok, st = eng.generate(p, 21, StaticWindowPolicy(4), gamma_max=GMAX,
                               transport=InProcessTransport(),
                               mode_policy="pipeline", seed=seed)
        runs.append(tok)
        assert st.accepted / st.proposed >= 0.99
        assert st.pipeline_hits + st.pipeline_misses == st.iterations
        assert st.pipeline_misses > 0
    np.testing.assert_array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])


def test_launcher_pipeline_mode():
    """``--mode-policy pipeline`` serves end to end over the in-process
    link: the pair's summary carries hits and misses, and the greedy
    tokens equal the half-duplex run's."""
    argv = ["--device", "cpu", "--requests", "3", "--max-new", "10",
            "--max-batch", "2", "--link-rtt-ms", "0", "--gamma-max", "4"]
    pipe = serve.run(argv + ["--mode-policy", "pipeline"])
    half = serve.run(argv + ["--mode-policy", "distributed"])
    row = pipe.summary["pairs"]["pair0"]
    assert row["mode_policy"] == "pipeline"
    assert row["pipeline_hits"] + row["pipeline_misses"] > 0
    by_id = lambda r: {x.request_id: x.tokens.tolist() for x in r.results}
    assert by_id(pipe) == by_id(half)


def test_pipeline_refuses_a_ring_cache(engines):
    """The attention draft rolls back by position alone, which a ring
    cache would break (its speculative writes could wrap onto committed
    slots): a session whose cache is a ring refuses the pipelined mode.
    Session caches are never rings today; the check keeps it so."""
    teng = engines["dense"][1]
    sess = DecodeSession(teng, capacity=1, max_new_cap=4, max_prompt_len=12,
                         gamma_max=GMAX, transport=InProcessTransport(),
                         mode_policy="pipeline")
    sess.admit(PROMPTS[1], 4)
    assert not sess._state.draft_cache.ring
    sess._state.draft_cache.ring = True
    with pytest.raises(ValueError, match="ring"):
        sess.run_chunk(StaticWindowPolicy(2))
