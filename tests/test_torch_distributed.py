"""Distributed draft–target sessions of the port (``repro_torch.distributed``
+ ``DecodeSession(transport=...)``) against the JAX reference's and the
port's colocated sessions, on the CPU, on bridged weights (d_model 64,
2 layers, vocab 128).

- In-process transport sessions commit the port's colocated tokens and
  the reference's in-process tokens: tokens, acceptance bits, rounds and
  ``gamma_seq`` — static γ, fused/distributed switching, forced fused; the
  server stream with staggered admission, dense and paged (block size 4);
  a tree session (``max_branches=3``) with γ × b and fused rounds
  changing.
- The recurrent pairs (ssm ← ssm, hybrid ← dense) over the transport equal
  the port's colocated split session (the reference's own transport cases
  for these families are its slow tests; ``tests/test_torch_ssm.py`` holds
  the colocated split session to the reference).
- A seeded ``EmulatedLinkTransport(sleep=False)``: delays, bytes, messages
  and measured RTT equal the reference session's; the imposed delay stays
  out of the TPOT feature and lands on the virtual clock.
- A socket loopback session equals the in-process one; at T = 1.0 in
  ``distributed`` mode an in-process session equals the colocated one on
  one seed, and self-speculation accepts everything.
- Interop: the port's ``DraftWorker`` and the reference's ``TargetWorker``
  drive greedy rounds over framed TCP, each side with its own package's
  codec; the committed tokens equal the reference's in-process session.
- Refusals, the worker programs' step keys flat over γ changes and
  admission churn, their buffers at fixed addresses (what a captured
  graph needs), and the launcher's flat link keys.

Equality is exact unless a test states a tolerance.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JCfg
from repro.core.engine import SpecDecodeEngine as JEngine
from repro.core.session import DecodeSession as JSession
from repro.core.specdec import SpecDecodeState as JState
from repro.core.window import StaticWindowPolicy as JStatic
from repro.distributed import EmulatedLinkTransport as JEmulated
from repro.distributed import InProcessTransport as JInProcess
from repro.distributed import socket_transport as j_sock
from repro.distributed import wire as j_wire
from repro.models.model import Model as JModel
from repro.serving import ServeRequest as JRequest
from repro.serving import ServerConfig as JServerConfig
from repro.serving import SpecDecodeServer as JServer
from repro.sim.network import LinkSpec as JLinkSpec
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import ModelConfig as TCfg
from repro_torch.core.engine import SpecDecodeEngine
from repro_torch.core.session import DecodeSession
from repro_torch.core.window import StaticWindowPolicy, WindowDecision
from repro_torch.distributed import (EmulatedLinkTransport,
                                     InProcessTransport, SocketTransport,
                                     TransportProtocolError)
from repro_torch.distributed import socket_transport as t_sock
from repro_torch.distributed import wire as t_wire
from repro_torch.distributed.workers import DraftWindow
from repro_torch.launch import serve
from repro_torch.serving import ServeRequest, ServerConfig, SpecDecodeServer
from repro_torch.sim.network import LinkSpec

CFG = dict(arch_type="dense", n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=2, d_ff=128, vocab=128, head_dim=16, dtype="float32",
           remat=False)
TARGET = dict(name="tiny-target", qk_norm=True)
SSM = dict(arch_type="ssm", n_layers=2, d_model=64, n_heads=0, n_kv_heads=0,
           d_ff=0, vocab=128, ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
           dtype="float32", remat=False, tie_embeddings=True)
HYBRID = dict(arch_type="hybrid", n_layers=4, d_model=64, n_heads=4,
              n_kv_heads=4, d_ff=128, head_dim=16, vocab=128, ssm_state=16,
              ssm_head_dim=16, ssm_chunk=8, attn_every=2, dtype="float32",
              remat=False)
GMAX = 4
MAX_NEW = 10
SYNC = 3


def _np_params(kw, seed):
    p = jax.device_get(JModel(JCfg(**CFG, **kw)).init_params(
        jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def walk(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v)
            elif k in ("ln1", "ln2", "final_norm", "q_norm", "k_norm"):
                tree[k] = (v + 0.1 * rng.normal(size=v.shape)).astype(v.dtype)
    walk(p)
    return p


@pytest.fixture(scope="module")
def pair():
    """A draft that is a noised copy of the target (acceptance strictly
    between 0 and 1), as (reference engine, port engine) on one set of
    weights."""
    t_np = _np_params(TARGET, 1)
    rng = np.random.default_rng(3)
    d_np = jax.tree.map(lambda a: (a + 0.02 * a.std() * rng.normal(
        size=a.shape)).astype(a.dtype), t_np)
    jeng = JEngine(JCfg(**CFG, **TARGET), JCfg(**CFG, **TARGET),
                   draft_params=jax.tree.map(jnp.asarray, d_np),
                   target_params=jax.tree.map(jnp.asarray, t_np),
                   temperature=0.0, key=jax.random.PRNGKey(0))
    teng = SpecDecodeEngine(TCfg(**CFG, **TARGET), TCfg(**CFG, **TARGET),
                            draft_params=params_from_numpy(d_np, "cpu"),
                            target_params=params_from_numpy(t_np, "cpu"),
                            device="cpu")
    return jeng, teng


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(4)
    lens = np.array([9, 5, 12], np.int32)
    p = np.zeros((3, 12), np.int32)
    for i, n in enumerate(lens):
        p[i, :n] = rng.integers(0, 128, n)
    return p, lens


class Alternator:
    """γ changes every round; every third round is fused (γ 0)."""

    def __init__(self, b_max: int = 1):
        self.i, self.b_max = 0, b_max

    def decide(self, pair_key, feats):
        self.i += 1
        if self.i % 3 == 0:
            return WindowDecision(1, "fused")
        return WindowDecision(1 + self.i % GMAX, "distributed",
                              branches=1 + self.i % self.b_max)

    def gamma_bound(self):
        return GMAX


POLICIES = {"static": (lambda: StaticWindowPolicy(3), "auto"),
            "mixed": (Alternator, "auto"),
            "fused": (lambda: StaticWindowPolicy(3), "fused")}


def _stats_key(st):
    """What a transport session shares with the reference's transport
    session: acceptance bits, accept counts, rounds, γ sequence."""
    return (st.acceptance_seqs, st.accepted, st.proposed, st.iterations,
            st.gamma_seq)


def _bits_key(st):
    """What it shares with a colocated session, which runs whole chunks of
    rounds where a transport session stops once every row is done (more
    rounds, and their γ decisions, in the colocated count)."""
    return (st.acceptance_seqs, st.accepted, st.proposed)


@pytest.mark.parametrize("case", sorted(POLICIES))
def test_inprocess_generate_matches_reference_and_colocated(pair, prompts,
                                                            case):
    """One wave through the split workers over the in-process transport
    commits the port's colocated tokens and acceptance bits, and the
    reference's in-process session's tokens, bits, rounds and γ
    sequence."""
    jeng, teng = pair
    p, lens = prompts
    make, mode = POLICIES[case]
    kw = dict(prompt_lens=lens, gamma_max=GMAX, sync_every=SYNC,
              mode_policy=mode)
    jtok, jst = jeng.generate(p, MAX_NEW, make(), transport=JInProcess(),
                              **kw)
    ctok, cst = teng.generate(p, MAX_NEW, make(), **kw)
    tr = InProcessTransport()
    ttok, tst = teng.generate(p, MAX_NEW, make(), transport=tr, **kw)
    np.testing.assert_array_equal(ttok, np.asarray(jtok))
    np.testing.assert_array_equal(ttok, ctok)
    assert _stats_key(tst) == _stats_key(jst)
    assert _bits_key(tst) == _bits_key(cst)
    if case == "fused":
        assert tst.proposed == 0 and tr.bytes_sent < 64 * tst.iterations
    else:
        assert 0 < tst.accepted < tst.proposed
    assert (tst.pipeline_hits, tst.pipeline_misses) == (0, 0)


def _requests():
    rng = np.random.default_rng(0)
    return [(i, rng.integers(0, 128, int(rng.integers(5, 14)))
             .astype(np.int32), int(rng.integers(4, 9))) for i in range(6)]


def _serve(srv, req_cls):
    for rid, prompt, n in _requests():
        srv.submit(req_cls(rid, prompt, n))
    res = srv.run()
    return ({r.request_id: r for r in res}, [r.request_id for r in res],
            srv.pair_summaries()["pair0"])


@pytest.mark.parametrize("paged", [False, True])
def test_server_stream_over_transport_matches_reference(pair, paged):
    """Six requests through two slots (admission into freed slots as
    requests retire) over the in-process transport: per request the tokens
    and acceptance rate, the retirement order and the rounds equal the
    reference server's over its in-process transport, and the tokens equal
    the port's colocated server's; paged: block size 4, pool below dense
    parity."""
    jeng, teng = pair
    kw = dict(max_batch=2, pad_to=4, sync_every=SYNC)
    if paged:
        kw.update(paged_kv=True, kv_block_size=4, kv_pool_blocks=14)
    jres, jorder, jsum = _serve(JServer(jeng, JStatic(3), JServerConfig(
        transport=JInProcess(), **kw)), JRequest)
    tres, torder, tsum = _serve(SpecDecodeServer(
        teng, StaticWindowPolicy(3), ServerConfig(
            transport=InProcessTransport(), **kw)), ServeRequest)
    cres, _, _ = _serve(SpecDecodeServer(teng, StaticWindowPolicy(3),
                                         ServerConfig(**kw)), ServeRequest)
    assert torder == jorder
    for rid, j in jres.items():
        np.testing.assert_array_equal(tres[rid].tokens, np.asarray(j.tokens))
        np.testing.assert_array_equal(tres[rid].tokens, cres[rid].tokens)
        assert tres[rid].acceptance_rate == j.acceptance_rate
    for k in ("requests", "iterations", "acceptance_rate", "messages",
              "bytes_sent", "recent_rtt_ms", "pipeline_hits",
              "pipeline_misses", "transport"):
        assert tsum[k] == jsum[k], k
    assert tsum["acceptance_rate"] > 0


def _drive_tree(sess, policy, p, lens):
    sess.admit_batch(p, MAX_NEW, prompt_lens=lens)
    while sess.unfinished:
        sess.run_chunk(policy)
    return sess.snapshot()


def test_tree_session_over_transport_matches_reference(pair, prompts):
    """A tree session (γ_max 4, b_max 3) with γ × b changing every round and
    a fused round every third: over the in-process transport the grid
    crosses with its parent table and the verdict carries the winning path
    back; tokens, bits, rounds and γ sequence equal the reference's
    in-process tree session, tokens and bits the port's colocated one."""
    jeng, teng = pair
    p, lens = prompts
    kw = dict(capacity=3, max_new_cap=MAX_NEW, gamma_max=GMAX,
              sync_every=SYNC, max_branches=3)
    jtok, jst = _drive_tree(JSession(jeng, transport=JInProcess(), **kw),
                            Alternator(3), p, lens)
    ctok, cst = _drive_tree(DecodeSession(teng, **kw), Alternator(3), p,
                            lens)
    tr = InProcessTransport()
    sess = DecodeSession(teng, transport=tr, **kw)
    ttok, tst = _drive_tree(sess, Alternator(3), p, lens)
    np.testing.assert_array_equal(ttok, np.asarray(jtok))
    np.testing.assert_array_equal(ttok, ctok)
    assert _stats_key(tst) == _stats_key(jst)
    assert _bits_key(tst) == _bits_key(cst)
    assert 0 < tst.accepted < tst.proposed and sess.fused_iterations > 0
    assert {("dw_propose_tree", GMAX, 3), ("tw_verify_tree", GMAX, 3),
            ("dw_ingest_tree", GMAX, 3), ("tw_verify", GMAX),
            ("dw_ingest",)} <= teng.step_keys


def _recurrent_engine(kind):
    d_kw, t_kw = {"ssm": (SSM, SSM), "hybrid": (CFG, HYBRID)}[kind]
    return SpecDecodeEngine(TCfg(name="d", **d_kw), TCfg(name="t", **t_kw),
                            seed=0, device="cpu")


def _staggered(eng, transport, policy, **kw):
    """Admit two requests into a 2-slot session, a third as the first
    retires; returns tokens by request, per-request bits, and the
    session."""
    rng = np.random.default_rng(5)
    ps = [rng.integers(0, 128, n).astype(np.int32) for n in (9, 6, 11)]
    sess = DecodeSession(eng, capacity=2, max_new_cap=MAX_NEW,
                         max_prompt_len=12, gamma_max=GMAX, sync_every=SYNC,
                         transport=transport, **kw)
    outs, bits = {}, {}
    sess.admit(ps[0], MAX_NEW, request_id=0)
    sess.run_chunk(policy)
    sess.admit(ps[1], 7, request_id=1)
    for _ in range(64):
        if not sess.unfinished:
            break
        sess.run_chunk(policy)
        for j in sess.finished_slots():
            toks, rec = sess.retire(j)
            outs[rec.request_id], bits[rec.request_id] = toks, rec.bits
            if 2 not in outs and sess.free:
                sess.admit(ps[2], 8, request_id=2)
                outs[2] = None
    assert not sess.unfinished and len(outs) == 3
    return outs, bits, sess


@pytest.mark.parametrize("kind", ["ssm", "hybrid"])
def test_recurrent_pairs_over_transport_equal_colocated_split(kind):
    """ssm ← ssm (the draft re-advanced by the received verdict's num_new)
    and hybrid ← dense over the in-process transport, with staggered
    admission and fused/distributed switching: the colocated split
    session's tokens and acceptance bits."""
    eng = _recurrent_engine(kind)
    col = _staggered(eng, None, Alternator())
    got = _staggered(eng, InProcessTransport(), Alternator())
    assert col[0].keys() == got[0].keys()
    for rid in col[0]:
        np.testing.assert_array_equal(got[0][rid], col[0][rid])
    assert got[1] == col[1]
    assert got[2].fused_iterations > 0
    keys = {("dw_propose", GMAX), ("tw_verify", GMAX), ("dw_ingest",)}
    if kind == "ssm":
        keys.add(("dw_advance", GMAX))
    assert keys <= eng.step_keys


def _link_session(eng_or_j, transport, p, lens, policy):
    is_ref = isinstance(eng_or_j, JEngine)
    cls = JSession if is_ref else DecodeSession
    sess = cls(eng_or_j, capacity=3, max_new_cap=MAX_NEW, gamma_max=GMAX,
               sync_every=SYNC, transport=transport)
    sess.admit_batch(p, MAX_NEW, prompt_lens=lens)
    while sess.unfinished:
        sess.run_chunk(policy)
    return sess, sess.snapshot()


def test_emulated_link_session_matches_reference(pair, prompts):
    """A seeded 20 ms emulated link on the virtual clock (fused and
    distributed rounds, so windows, verdicts and stream flushes cross):
    the tokens, the sampled delays of both directions, the priced bytes,
    the messages and the measured RTT equal the reference session's; each
    session's unhidden link time is the sum of the sampled delays within
    0.05 ms per message (the clock runs between post and receive)."""
    jeng, teng = pair
    p, lens = prompts
    jtr = JEmulated(JLinkSpec(20.0, 1.0, 1.0), seed=0, sleep=False)
    ttr = EmulatedLinkTransport(LinkSpec(20.0, 1.0, 1.0), seed=0,
                                sleep=False)
    jsess, (jtok, _) = _link_session(jeng, jtr, p, lens, Alternator())
    tsess, (ttok, _) = _link_session(teng, ttr, p, lens, Alternator())
    np.testing.assert_array_equal(ttok, np.asarray(jtok))
    assert ttr.delay_log == jtr.delay_log
    assert (ttr.bytes_sent, ttr.messages_sent, ttr.recent_rtt_ms) == \
        (jtr.bytes_sent, jtr.messages_sent, jtr.recent_rtt_ms)
    assert tsess.fused_iterations > 0 and tsess.control_roundtrips > 0
    n_dist = tsess.iterations - tsess.fused_iterations
    assert ttr.messages_sent == 2 * n_dist + 2 * tsess.control_roundtrips
    total = sum(ttr.delay_log["window"] + ttr.delay_log["verdict"])
    for sess in (jsess, tsess):
        assert abs(sess.link_ms - total) <= 0.05 * ttr.messages_sent
    # the delay never slept: it is on the virtual clock, and the TPOT
    # feature (target service time) was not clamped by subtracting it
    assert tsess.virtual_ms >= tsess.link_ms
    feats = tsess._features(0.0)
    assert feats.tpot_recent_ms > 0.0
    assert feats.rtt_recent_ms == ttr.recent_rtt_ms


def test_sleeping_link_stays_out_of_tpot(pair, prompts):
    """A sleeping 10 ms link: the delay is slept into wall time, measured
    in ``link_ms``, and kept out of the TPOT feature, which stays below the
    wall per round."""
    _, teng = pair
    p, lens = prompts
    tr = EmulatedLinkTransport(LinkSpec(10.0, 0.5), seed=1)
    sess, _ = _link_session(teng, tr, p, lens, StaticWindowPolicy(3))
    n = sess.iterations
    assert sess.link_ms >= 0.95 * sum(tr.delay_log["window"]
                                      + tr.delay_log["verdict"])
    assert sess._features(0.0).tpot_recent_ms < \
        sess.decode_wall_s * 1e3 / max(1, n)


def test_socket_loopback_session_equals_inprocess(pair, prompts):
    """Every window and verdict through two real TCP streams, decoded from
    the bytes: the in-process session's tokens, bits and rounds, and the
    same priced bytes and messages."""
    _, teng = pair
    p, lens = prompts
    ref_tr = InProcessTransport()
    _, (rtok, rst) = _link_session(teng, ref_tr, p, lens, Alternator())
    tr = SocketTransport.loopback(timeout_s=10.0)
    try:
        _, (tok, st) = _link_session(teng, tr, p, lens, Alternator())
        np.testing.assert_array_equal(tok, rtok)
        assert _stats_key(st) == _stats_key(rst)
        assert (tr.bytes_sent, tr.messages_sent) == \
            (ref_tr.bytes_sent, ref_tr.messages_sent)
        assert tr.wire_bytes > 0 and tr.in_flight == 0
    finally:
        tr.close()


@pytest.mark.parametrize("kind", ["dense", "ssm"])
def test_sampled_distributed_equals_colocated_on_seed(pair, prompts, kind):
    """T = 1.0, mode ``distributed``: the session generator feeds the
    draft's Gumbel draws and the verify's uniforms in the colocated step's
    order, so an in-process session on seed s commits the colocated
    session's tokens and bits on seed s; self-speculation (draft = target
    weights) accepts everything."""
    p, lens = prompts
    if kind == "dense":
        _, base = pair
        d_cfg, t_cfg = base.draft_cfg, base.target_cfg
        d_par, t_par = base.draft_params, base.target_params
    else:
        base = _recurrent_engine("ssm")
        d_cfg, t_cfg = base.draft_cfg, base.target_cfg
        d_par, t_par = base.draft_params, base.target_params
    mk = lambda dp: SpecDecodeEngine(d_cfg if dp is d_par else t_cfg, t_cfg,
                                     draft_params=dp, target_params=t_par,
                                     temperature=1.0, device="cpu")
    eng = mk(d_par)
    kw = dict(prompt_lens=lens, gamma_max=GMAX, sync_every=SYNC, seed=11,
              mode_policy="distributed")
    ctok, cst = eng.generate(p, MAX_NEW, StaticWindowPolicy(3), **kw)
    ttok, tst = eng.generate(p, MAX_NEW, StaticWindowPolicy(3),
                             transport=InProcessTransport(), **kw)
    np.testing.assert_array_equal(ttok, ctok)
    assert _bits_key(tst) == _bits_key(cst)
    assert 0 < tst.accepted < tst.proposed
    _, sst = mk(t_par).generate(p, MAX_NEW, StaticWindowPolicy(3),
                                transport=InProcessTransport(), **kw)
    bits = [b for seq in sst.acceptance_seqs for b in seq]
    assert bits and all(bits)


def test_interop_port_draft_reference_target(pair, prompts):
    """The port's DraftWorker (its propose program on its own state) and the
    reference's TargetWorker (its verify/commit program on the reference
    session's state) drive greedy rounds by hand over a framed TCP socket
    pair, each side with its own package's codec and frames: the committed
    tokens equal the reference's all-reference in-process session."""
    jeng, teng = pair
    p, lens = prompts
    B = p.shape[0]
    ref_tok, _ = jeng.generate(p, MAX_NEW, JStatic(3), prompt_lens=lens,
                               gamma_max=GMAX, sync_every=SYNC,
                               transport=JInProcess())
    # target side: a reference session's state, driven round by round
    jsess = JSession(jeng, capacity=B, max_new_cap=MAX_NEW, gamma_max=GMAX,
                     sync_every=SYNC, transport=JInProcess())
    jsess.admit_batch(p, MAX_NEW, prompt_lens=lens)
    _, tw = jeng.split_workers()
    # draft side: the port's own prefill and propose program
    dw, _ = teng.split_workers()
    st = teng._prefill(torch.as_tensor(p), jsess.slots_len,
                       prompt_lens=torch.as_tensor(lens))
    np.testing.assert_array_equal(st.last_token.numpy(),
                                  np.asarray(jsess._state.last_token))
    win = DraftWindow.empty(B, GMAX, "cpu")
    propose = dw.propose(GMAX)
    w_tx, w_rx = t_sock._tcp_pair(10.0)
    v_tx, v_rx = t_sock._tcp_pair(10.0)
    rounds = 0
    try:
        done = np.zeros(B, bool)
        while not done.all() and rounds < 4 * MAX_NEW:
            # edge: propose, encode (port codec), frame (port)
            propose(st.draft_cache, st.last_token, st.pos, win)
            msg = t_wire.WindowMsg(tokens=win.tokens.numpy().copy(), gamma=3,
                                   n_active=int((~done).sum()),
                                   round_id=rounds)
            t_sock.send_frame(w_tx, t_sock.FRAME_WINDOW,
                              t_wire.encode_window(msg))
            # cloud: unframe + decode (reference), verify/commit, verdict
            kind, payload, _, _ = j_sock.recv_frame(w_rx)
            assert kind == j_sock.FRAME_WINDOW
            got = j_wire.decode_window(payload)
            state = jsess._state
            window = np.concatenate([np.asarray(state.last_token)[:, None],
                                     got.tokens], axis=1)
            (tcache, new_pos, new_last, num_new, nacc, next_raw) = \
                jsess._verify_commit_round(tw, window, got.gamma,
                                           rounds % SYNC, None, False,
                                           jax.random.PRNGKey(0))
            jsess._state = JState(draft_cache=state.draft_cache,
                                  target_cache=tcache, last_token=new_last,
                                  pos=new_pos)
            verdict = j_wire.VerdictMsg(
                n_accepted=np.asarray(nacc), num_new=np.asarray(num_new),
                next_token=np.asarray(next_raw),
                last_token=np.asarray(new_last),
                done=np.asarray(jsess._done), gamma=got.gamma,
                n_active=got.n_active, round_id=got.round_id)
            j_sock.send_frame(v_tx, j_sock.FRAME_VERDICT,
                              j_wire.encode_verdict(verdict))
            # edge: unframe + decode (port), apply to the draft's view
            kind, payload, _, _ = t_sock.recv_frame(v_rx)
            assert kind == t_sock.FRAME_VERDICT
            v = t_wire.decode_verdict(payload)
            assert v.round_id == rounds
            st.last_token = torch.as_tensor(v.last_token)
            st.pos = st.pos + torch.as_tensor(v.num_new)
            done = v.done
            rounds += 1
    finally:
        for s in (w_tx, w_rx, v_tx, v_rx):
            s.close()
    assert done.all()
    np.testing.assert_array_equal(np.asarray(jsess._out_buf),
                                  np.asarray(ref_tok))


# ------------------------------------------------------------ contracts

def test_refusals(pair):
    """The pipelined mode names its ROADMAP item; tree sessions stay greedy;
    a transport must be a Transport; a sampled window does not cross a
    socket (its distributions stay on the device)."""
    _, teng = pair
    with pytest.raises(NotImplementedError, match="A9"):
        DecodeSession(teng, capacity=1, max_new_cap=4,
                      transport=InProcessTransport(), mode_policy="pipeline")
    with pytest.raises(NotImplementedError, match="A9"):
        teng.generate(np.zeros((1, 4), np.int32), 4,
                      transport=InProcessTransport(), mode_policy="pipeline")
    with pytest.raises(TypeError, match="Transport"):
        DecodeSession(teng, capacity=1, max_new_cap=4, transport=object())
    sampled = SpecDecodeEngine(teng.draft_cfg, teng.target_cfg,
                               draft_params=teng.draft_params,
                               target_params=teng.target_params,
                               temperature=0.7, device="cpu")
    with pytest.raises(ValueError, match="greedy-only"):
        DecodeSession(sampled, capacity=1, max_new_cap=4, max_branches=2,
                      transport=InProcessTransport())
    tr = SocketTransport.loopback(timeout_s=10.0)
    try:
        with pytest.raises(TransportProtocolError, match="q_probs"):
            sampled.generate(np.ones((1, 4), np.int32), 4, transport=tr)
    finally:
        tr.close()


def _addresses(sess) -> dict:
    st, w = sess._state, sess._wire
    leaves = {"pos": st.pos, "last_token": st.last_token}
    for side, cache in (("draft", st.draft_cache),
                        ("target", st.target_cache)):
        for f in dataclasses.fields(cache):
            v = getattr(cache, f.name)
            if isinstance(v, torch.Tensor):
                leaves[f"{side}.{f.name}"] = v
    for name in ("_out_buf", "_cursor", "_max_new", "_done", "_nacc", "_nn"):
        leaves[name] = getattr(sess, name)
    for k, v in w.items():
        if isinstance(v, DraftWindow):
            for f in dataclasses.fields(v):
                if getattr(v, f.name) is not None:
                    leaves[f"{k}.{f.name}"] = getattr(v, f.name)
        elif isinstance(v, torch.Tensor):
            leaves[k] = v
        elif hasattr(v, "flat"):
            leaves[k] = v.flat
    for k, img in w["host"].items():
        leaves[f"host.{k}"] = img.host
    for k, step in w["steps"].items():
        for name, t in step.inputs.items():
            leaves[f"{k}.{name}"] = t
    return {k: v.data_ptr() for k, v in leaves.items()}


@pytest.mark.parametrize("kind", ["dense", "paged", "ssm"])
def test_worker_steps_flat_and_in_place(pair, kind):
    """Rounds with γ and fused/distributed changing and admissions into
    freed slots: no new step key after the first chunks, and every state
    leaf, lifecycle buffer, window/verdict buffer, host image and static
    step input keeps its address — what replaying the worker programs from
    captured graphs needs."""
    if kind == "ssm":
        eng, opts = _recurrent_engine("ssm"), {}
    else:
        eng = pair[1]
        opts = dict(paged=True, kv_block_size=4) if kind == "paged" else {}
    rng = np.random.default_rng(2)
    sess = DecodeSession(eng, capacity=2, max_new_cap=12, max_prompt_len=12,
                         gamma_max=GMAX, sync_every=2,
                         transport=InProcessTransport(), **opts)
    pol = Alternator()
    sess.admit(rng.integers(0, 128, 7), 12, request_id=0)
    sess.admit(rng.integers(0, 128, 4), 12, request_id=1)
    while sess._wire is None or "ingest" not in sess._wire["steps"]:
        assert sess.run_chunk(pol)                   # until a fused round
    keys, addrs = set(eng.step_keys), _addresses(sess)
    want = {"propose", "verify", "ingest"} | (
        {"advance"} if kind == "ssm" else set())
    assert set(sess._wire["steps"]) == want
    rid, done = 2, 0
    while done < 6:
        sess.run_chunk(pol)
        assert _addresses(sess) == addrs
        for j in sess.finished_slots():
            sess.retire(j)
            done += 1
            if rid < 6:
                sess.admit(rng.integers(0, 128, int(rng.integers(2, 12))),
                           int(rng.integers(6, 13)), request_id=rid)
                rid += 1
                assert _addresses(sess) == addrs
    assert sess.iterations > 10
    assert eng.step_keys - keys <= {("release",)}


def test_launcher_prints_flat_link_keys(capsys):
    """``launch.serve --device cpu --link-rtt-ms 0 --json``: the in-process
    transport's flat summary keys beside the per-pair link fields; the
    pipelined mode is refused."""
    assert serve.main(["--device", "cpu", "--requests", "3", "--max-new",
                       "5", "--gamma-max", "4", "--link-rtt-ms", "0",
                       "--json"]) == 0
    s = json.loads(capsys.readouterr().out)
    assert s["transport"] == "in-process" and s["mode_policy"] == "auto"
    assert s["link_messages"] == 2 * s["iterations"]
    assert s["link_bytes_sent"] > 0 and s["link_recent_rtt_ms"] == 0.0
    row = s["pairs"]["pair0"]
    assert row["messages"] == s["link_messages"] and row["link_ms"] == 0.0
    assert s["step_programs"] == 3      # insert, propose, verify
    with pytest.raises(SystemExit, match="pipeline"):
        serve.main(["--device", "cpu", "--link-rtt-ms", "0",
                    "--mode-policy", "pipeline"])


def test_transport_session_frees_the_engine_without_gc(pair, prompts):
    """A server and a tree session over a transport hold no reference
    cycle: once dropped, the engine and its weights are freed by reference
    counting alone (with the garbage collector off), as a colocated
    session's are — on the card the weights are tens of GB."""
    import gc
    import weakref
    _, base = pair
    p, lens = prompts
    gc.collect()
    gc.disable()
    try:
        for tree in (False, True):
            eng = SpecDecodeEngine(base.draft_cfg, base.target_cfg, seed=3,
                                   device="cpu")
            if tree:
                sess = DecodeSession(eng, capacity=3, max_new_cap=6,
                                     gamma_max=GMAX, max_branches=2,
                                     transport=InProcessTransport())
                _drive_tree(sess, Alternator(2), p, lens)
                holder = sess
            else:
                holder = SpecDecodeServer(eng, Alternator(), ServerConfig(
                    max_batch=2, transport=InProcessTransport()))
                for rid, prompt, n in _requests()[:3]:
                    holder.submit(ServeRequest(rid, prompt, n))
                holder.run()
                assert holder._sessions[0]._wire["steps"]
            refs = [weakref.ref(eng), weakref.ref(eng.target_params["embed"])]
            del eng, holder
            if tree:
                del sess
            assert all(r() is None for r in refs)
    finally:
        gc.enable()
