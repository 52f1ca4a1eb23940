"""The port's SSM (Mamba2) and hybrid (Zamba2) families and their serving
path, held against the JAX reference on the same numpy inputs and bridged
weights: the SSD scan (kernel B5's plain versions against the reference's
oracle, its chunked jnp path and its Pallas kernel in interpret mode), the
Mamba2 blocks, the models, the split speculative-decoding step (greedy and
sampled), the session and the launcher.

Configs: the tiny ssm / hybrid targets of ``tests/test_specdec.py`` (d_model
64, N 16, hd 16, chunk 8; the hybrid has 4 layers with a shared block every
2) and the reduced published zamba2-1.2b / mamba2-130m, all float32.

Tolerances: the scan atol 5e-4, rtol 1e-3 (the reference's own kernel
tolerance); blocks, logits and states atol/rtol 1e-4 (float32, sum order
only). Greedy tokens, accept counts, acceptance bits and the sampled rule's
outcome under injected draws are compared exactly. CUDA kernel B5 itself is
held to these plain versions on the card by ``chip_smoke.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ModelConfig as JCfg
from repro.core.engine import SpecDecodeEngine as JEngine
from repro.core.engine import _scan_cache_advance as j_advance
from repro.core.specdec import _temperature_probs as j_temp_probs
from repro.core.window import StaticWindowPolicy as JStatic
from repro.kernels.ssd.ops import ssd_chunked_kernel as j_ssd_kernel
from repro.kernels.ssd.ref import ssd_recurrent_reference as j_recurrent
from repro.kernels.verify import verify_reference as j_verify_reference
from repro.models import ssm as jssm
from repro.models.model import Model as JModel
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig as TCfg
from repro_torch.core.engine import SpecDecodeEngine
from repro_torch.core.session import DecodeSession
from repro_torch.core.window import StaticWindowPolicy, WindowDecision
from repro_torch.kernels.ssd import (KERNEL_CHUNK, ssd_call,
                                     ssd_chunked_kernel, ssd_chunked_plain,
                                     ssd_recurrent_reference,
                                     ssd_state_passing_plain)
from repro_torch.kernels.ssd.ssd import heads_per_block
from repro_torch.launch import serve
from repro_torch.models import ssm as tssm
from repro_torch.models.kvcache import HybridCacheT, reset_slot
from repro_torch.models.model import Model as TModel

SCAN_TOL = dict(atol=5e-4, rtol=1e-3)
TOL = dict(atol=1e-4, rtol=1e-4)
GMAX = 4
MAX_NEW = 10

TINY = {
    "ssm": dict(name="ts", arch_type="ssm", n_layers=2, d_model=64,
                n_heads=0, n_kv_heads=0, d_ff=0, vocab=128, ssm_state=16,
                ssm_head_dim=16, ssm_chunk=8, dtype="float32", remat=False,
                tie_embeddings=True),
    "hybrid": dict(name="th", arch_type="hybrid", n_layers=4, d_model=64,
                   n_heads=4, n_kv_heads=4, d_ff=128, head_dim=16,
                   vocab=128, ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
                   attn_every=2, dtype="float32", remat=False),
    "dense": dict(name="d", arch_type="dense", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
                  dtype="float32", remat=False),
}

t = torch.from_numpy
j = jnp.asarray


def _cfgs(kind):
    """(reference config, port config) for a tiny kind or a reduced
    published name."""
    if kind in TINY:
        return JCfg(**TINY[kind]), TCfg(**TINY[kind])
    return j_get_config(kind).reduced(), get_config(kind).reduced()


def _np_params(jcfg, seed):
    """Reference init with the zero-init norms, biases and conv bias moved
    off zero (their code paths count), as numpy leaves."""
    p = jax.device_get(JModel(jcfg).init_params(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def walk(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v)
            elif k in ("ln1", "ln2", "final_norm", "norm", "conv_b"):
                tree[k] = (v + 0.1 * rng.normal(size=v.shape)).astype(v.dtype)
    walk(p)
    return p


def _noised(p, scale, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (a + scale * a.std() * rng.normal(
        size=a.shape)).astype(a.dtype), p)


def _scan_inputs(B, S, nh, hd, N, seed, lens=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, nh, hd)).astype(np.float32)
    Bm = (0.5 * rng.normal(size=(B, S, N))).astype(np.float32)
    Cm = (0.5 * rng.normal(size=(B, S, N))).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(B, S, nh)))).astype(np.float32)
    if lens is not None:
        dt[np.arange(S)[None, :] >= np.asarray(lens)[:, None]] = 0.0
    A = (-np.exp(rng.normal(size=(nh,)))).astype(np.float32)
    h0 = rng.normal(size=(B, nh, hd, N)).astype(np.float32)
    return x, Bm, Cm, dt, A, h0


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


# -------------------------------------------------------------------- scan

@pytest.mark.parametrize("case", ["multi-chunk", "ragged S", "zero-dt rows"])
def test_scan_plain_matches_reference(case):
    """The port's plain chunked scan and recurrence against the reference's
    recurrence, its chunked jnp path and its Pallas kernel (interpret
    mode), with a nonzero carried-in state. Zero-dt rows are identity steps:
    their h_out equals the recurrence over the prefix alone."""
    B, S, nh, hd, N, chunk = 2, {"multi-chunk": 32, "ragged S": 20,
                                 "zero-dt rows": 24}[case], 3, 16, 32, 8
    lens = (24, 11) if case == "zero-dt rows" else None
    args = _scan_inputs(B, S, nh, hd, N, seed=S, lens=lens)
    y_ref, h_ref = j_recurrent(*map(j, args))
    y_k, h_k = j_ssd_kernel(*map(j, args), chunk, interpret=True)
    y_p, h_p = ssd_chunked_plain(*map(t, args), chunk)
    y_r, h_r = ssd_recurrent_reference(*map(t, args))
    for got in ((y_p, h_p), (y_r, h_r), (y_k, h_k)):
        _close(got[0], y_ref, SCAN_TOL)
        _close(got[1], h_ref, SCAN_TOL)
    if S % chunk == 0:
        y_c, h_c = jssm.ssd_chunked(*map(j, args), chunk)
        _close(y_p, y_c, SCAN_TOL)
        _close(h_p, h_c, SCAN_TOL)
    if lens is not None:
        x, Bm, Cm, dt, A, h0 = args
        n = lens[1]
        _, h_pre = j_recurrent(j(x[1:, :n]), j(Bm[1:, :n]), j(Cm[1:, :n]),
                               j(dt[1:, :n]), j(A), j(h0[1:]))
        _close(h_p[1:], h_pre, SCAN_TOL)
    # the wrapper's CPU branch is the plain version
    y_w, h_w = ssd_chunked_kernel(*map(t, args), chunk)
    assert torch.equal(y_w, y_p) and torch.equal(h_w, h_p)


def test_scan_wrappers_refuse_other_devices():
    z = torch.zeros((1, 2, 1, 16), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ssd_chunked_kernel(z, z, z, z, z, z, 8)
    x, Bm, Cm, dt, A, h0 = map(t, _scan_inputs(1, 4, 1, 16, 16, seed=0))
    with pytest.raises(ValueError, match="cuda"):
        ssd_call(x, Bm, Cm, dt, A, h0)
    with pytest.raises(ValueError, match="chunk"):
        ssd_chunked_kernel(x, Bm, Cm, dt, A, h0, 0)


# (B, S, nh, hd, N, reference chunk, zero dt past these lengths): one
# kernel chunk at the verify and prefill windows, and several (a ragged last
# chunk, rows past a length) as a long prefill runs them
STATE_PASSING_CASES = {
    "verify": (2, 9, 3, 16, 16, 9, None),
    "prefill": (2, 48, 3, 16, 32, 16, (48, 29)),
    "ragged": (3, 150, 2, 16, 16, 32, (150, 70, 13)),
    "multi-chunk": (2, 3 * KERNEL_CHUNK, 2, 32, 16, 64, None),
}


@pytest.mark.parametrize("case", list(STATE_PASSING_CASES))
def test_state_passing_plain_matches_reference(case):
    """B5's three-phase decomposition (chunk states, the pass over the
    chunks, outputs) in its 64-token chunks against the reference's Pallas
    kernel in interpret mode and its recurrence, f32, atol 1e-4."""
    B, S, nh, hd, N, chunk, lens = STATE_PASSING_CASES[case]
    args = _scan_inputs(B, S, nh, hd, N, seed=S + nh, lens=lens)
    y, h = ssd_state_passing_plain(*map(t, args))
    for want in (j_ssd_kernel(*map(j, args), chunk, interpret=True),
                 j_recurrent(*map(j, args))):
        _close(y, want[0])
        _close(h, want[1])


def test_state_passing_zero_dt_rows_are_identities():
    """Rows with dt = 0 past a length leave h_out bit for bit the state of
    the prefix alone, across a chunk edge and over whole zero-dt chunks."""
    lens = (150, 70, 13, 64)
    x, Bm, Cm, dt, A, h0 = map(t, _scan_inputs(4, 150, 2, 16, 16, seed=7,
                                               lens=lens))
    _, h = ssd_state_passing_plain(x, Bm, Cm, dt, A, h0)
    for r, n in enumerate(lens):
        _, h_pre = ssd_state_passing_plain(
            x[r:r + 1, :n], Bm[r:r + 1, :n], Cm[r:r + 1, :n],
            dt[r:r + 1, :n], A, h0[r:r + 1])
        assert torch.equal(h_pre[0], h[r]), n


@pytest.mark.parametrize("shape,hg", [
    ((4, 1, 64), 1),      # zamba2 verify / prefill: 256 blocks of 1 head
    ((4, 1, 24), 1),      # mamba2-130m verify: 96 blocks
    ((2, 64, 24), 8),     # S 4096 of mamba2-130m: 384 blocks of 8 heads
    ((4, 2, 64), 4),      # zamba2 prefill of 65–128 tokens: 128 blocks
    ((1, 1, 3), 1)])
def test_heads_per_block_fills_the_card(shape, hg):
    assert heads_per_block(*shape) == hg


# ------------------------------------------------------------------ blocks

@pytest.fixture(scope="module")
def block_params():
    jcfg, tcfg = _cfgs("ssm")
    p = jax.device_get(jssm.init_ssm_params(jax.random.PRNGKey(3), jcfg,
                                            jnp.float32))
    rng = np.random.default_rng(3)
    p["norm"] = (0.1 * rng.normal(size=p["norm"].shape)).astype(np.float32)
    p["conv_b"] = (0.1 * rng.normal(size=p["conv_b"].shape)).astype(
        np.float32)
    return jcfg, tcfg, p


def test_ssm_blocks_match_reference(block_params):
    """ssm_block_train with ragged seq_lens and a carried-in state (conv tail
    and SSD state), and ssm_block_decode from the resulting state."""
    jcfg, tcfg, p = block_params
    B, S, D = 3, 20, jcfg.d_model
    rng = np.random.default_rng(5)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    h0 = rng.normal(size=(B, jcfg.ssm_heads, jcfg.ssm_head_dim,
                          jcfg.ssm_state)).astype(np.float32)
    tail = rng.normal(size=(B, jcfg.ssm_conv - 1,
                            tssm.conv_dim(tcfg))).astype(np.float32)
    lens = np.array([20, 13, 4], np.int32)
    given = (h0.copy(), tail.copy())
    tp = params_from_numpy(p, "cpu")
    jy, js = jssm.ssm_block_train(j(x), jax.tree.map(j, p), jcfg,
                                  state=jssm.SSDState(h=j(h0),
                                                      conv_tail=j(tail)),
                                  seq_lens=j(lens))
    ty, ts = tssm.ssm_block_train(t(x), tp, tcfg,
                                  state=tssm.SSDState(h=t(h0),
                                                      conv_tail=t(tail)),
                                  seq_lens=t(lens))
    for row, n in enumerate(lens):
        _close(ty[row, :n], jy[row, :n])
    _close(ts.h, js.h)
    _close(ts.conv_tail, js.conv_tail)
    x1 = rng.normal(size=(B, 1, D)).astype(np.float32)
    jy1, js1 = jssm.ssm_block_decode(j(x1), jax.tree.map(j, p), jcfg, js)
    ty1, ts1 = tssm.ssm_block_decode(t(x1), tp, tcfg, ts)
    _close(ty1, jy1)
    _close(ts1.h, js1.h)
    _close(ts1.conv_tail, js1.conv_tail)
    # the state given to the T > 1 block (shared with numpy) is intact
    np.testing.assert_array_equal(h0, given[0])
    np.testing.assert_array_equal(tail, given[1])


# ------------------------------------------------------------------ models

def _ssm_leaves(cache):
    c = cache.ssm if isinstance(cache, HybridCacheT) else cache
    return {"conv": c.conv, "state": c.state}


def _compare_caches(tc, jc, committed=None):
    """Recurrent leaves close; a hybrid's shared-attention entries equal in
    pos_map and close in k/v where the reference's are valid. With
    ``committed`` (B,) — the positions after a round — only the committed
    prefix is compared: past it the port's verify and masked advance
    writes stand in place (stale, rewritten by the next window before any
    query attends them) where the reference kept its prefill's."""
    jl = jc.ssm if hasattr(jc, "shared_attn") else jc
    for name, leaf in _ssm_leaves(tc).items():
        _close(leaf, getattr(jl, name))
    if isinstance(tc, HybridCacheT):
        sa, ja = tc.shared_attn, jc.shared_attn
        valid = np.asarray(ja.pos_map) >= 0
        if committed is not None:
            valid &= np.asarray(ja.pos_map) < committed[None, :, None]
        else:
            np.testing.assert_array_equal(sa.pos_map.numpy(),
                                          np.asarray(ja.pos_map))
        np.testing.assert_array_equal(sa.pos_map.numpy()[valid],
                                      np.asarray(ja.pos_map)[valid])
        _close(sa.k.numpy()[valid], np.asarray(ja.k)[valid])
        _close(sa.v.numpy()[valid], np.asarray(ja.v)[valid])


@pytest.mark.parametrize("kind", ["ssm", "hybrid", "zamba2-1.2b",
                                  "mamba2-130m"])
def test_model_steps_match_reference(kind):
    """prefill (ragged prompt_lens), decode_step and a verify window:
    logits and returned caches against the reference's; the verify leaves
    the window-start recurrent state it was given untouched."""
    jcfg, tcfg = _cfgs(kind)
    p = _np_params(jcfg, 1)
    jm, tm = JModel(jcfg), TModel(tcfg, "cpu")
    jp, tp = jax.tree.map(j, p), params_from_numpy(p, "cpu")
    rng = np.random.default_rng(2)
    B, S, slots = 3, 19, 40
    toks = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    lens = np.array([19, 12, 6], np.int32)
    jl, jc = jm.prefill(jp, j(toks), slots, prompt_lens=j(lens))
    tl, tc = tm.prefill(tp, t(toks), slots, prompt_lens=t(lens))
    for row, n in enumerate(lens):
        _close(tl[row, :n], jl[row, :n])
    _compare_caches(tc, jc)
    tok = rng.integers(0, jcfg.vocab, B).astype(np.int32)
    jl, jc = jm.decode_step(jp, j(tok), jc, j(lens))
    tl, tc = tm.decode_step(tp, t(tok), tc, t(lens))
    _close(tl, jl)
    _compare_caches(tc, jc)
    win = rng.integers(0, jcfg.vocab, (B, GMAX + 1)).astype(np.int32)
    before = {k: v.clone() for k, v in _ssm_leaves(tc).items()}
    jl, jv = jm.verify_step(jp, j(win), jc, j(lens + 1))
    tl, tv = tm.verify_step(tp, t(win), tc, t(lens + 1))
    _close(tl, jl)
    _compare_caches(tv, jv)
    for k, v in _ssm_leaves(tc).items():
        assert torch.equal(v, before[k]), k


def test_bridge_and_init_keep_the_reference_layout():
    """The bridge carries the ssm leaves (A_log, D, dt_bias f32 beside bf16
    weights) and the hybrid's shared_attn subtree unchanged, and the port's
    own init draws the same tree of shapes and dtypes as the reference."""
    jcfg = dataclasses.replace(JCfg(**TINY["hybrid"]), dtype="bfloat16")
    tcfg = dataclasses.replace(TCfg(**TINY["hybrid"]), dtype="bfloat16")
    p = jax.device_get(JModel(jcfg).init_params(jax.random.PRNGKey(0)))
    tp = params_from_numpy(p, "cpu")
    mine = TModel(tcfg, "cpu").init_params(0)
    flat = jax.tree_util.tree_flatten_with_path(p)[0]
    for path, leaf in flat:
        keys = [k.key for k in path]
        got, own = tp, mine
        for k in keys:
            got, own = got[k], own[k]
        want = {"float32": torch.float32, "bfloat16": torch.bfloat16}[
            leaf.dtype.name]
        assert got.dtype == own.dtype == want, keys
        assert tuple(got.shape) == tuple(own.shape) == leaf.shape, keys
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(leaf, np.float32))
    assert set(p) == set(mine) == set(tp)
    assert mine["layers"]["ssm"]["A_log"].dtype == torch.float32


def test_paged_cache_refuses_recurrent_families():
    for kind in ("ssm", "hybrid"):
        with pytest.raises(ValueError, match="paged KV"):
            TModel(_cfgs(kind)[1], "cpu").init_paged_cache(1, 16, 4, 16)


# ------------------------------------------------------- greedy engine

PAIRS = {"ssm<-dense": ("ssm", "dense"), "ssm<-ssm": ("ssm", "ssm"),
         "hybrid<-dense": ("hybrid", "dense"),
         "hybrid<-ssm": ("hybrid", "ssm"), "dense<-ssm": ("dense", "ssm")}


def _pair_params(t_kind, d_kind):
    t_np = _np_params(JCfg(**TINY[t_kind]), 1)
    # a same-architecture draft is the noised target (acceptance > 0)
    d_np = (_noised(t_np, 0.02, 3) if d_kind == t_kind
            else _np_params(JCfg(**TINY[d_kind]), 2))
    return t_np, d_np


def _engines(t_kind, d_kind, temperature=0.0):
    t_np, d_np = _pair_params(t_kind, d_kind)
    jeng = JEngine(JCfg(**TINY[d_kind]), JCfg(**TINY[t_kind]),
                   draft_params=jax.tree.map(j, d_np),
                   target_params=jax.tree.map(j, t_np),
                   temperature=temperature, key=jax.random.PRNGKey(0))
    teng = SpecDecodeEngine(TCfg(**TINY[d_kind]), TCfg(**TINY[t_kind]),
                            draft_params=params_from_numpy(d_np, "cpu"),
                            target_params=params_from_numpy(t_np, "cpu"),
                            temperature=temperature, device="cpu")
    return jeng, teng


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


@pytest.mark.parametrize("pair", list(PAIRS))
def test_split_generate_matches_reference(pair, prompts):
    """Static γ 3 at width 4: tokens, accept counts, rounds and acceptance
    bit streams equal the reference engine's, the tokens equal the target's
    own greedy decode, and a γ cycling every round (fused rounds included)
    commits the same tokens on the one split step key."""
    jeng, teng = _engines(*PAIRS[pair])
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
    if PAIRS[pair][0] == PAIRS[pair][1]:
        assert ts.accepted > 0
    tc, sc = teng.generate(p, MAX_NEW, _CyclePolicy(), prompt_lens=lens)
    np.testing.assert_array_equal(tc, tt)
    assert len(set(sc.gamma_seq)) > 2
    assert teng.step_keys == {("split", GMAX)}


def test_eos_split_generate_matches_reference(prompts):
    """``eos_id`` ≥ 0 through the split step (ssm ← noised ssm, static γ
    3): for stop tokens taken from each greedy stream (row i's token at
    4 + i), tokens, accept counts, rounds and acceptance bit streams equal
    the reference engine's, and rows stop before their budget."""
    jeng, teng = _engines(*PAIRS["ssm<-ssm"])
    p, lens = prompts
    full, _ = teng.generate(p, MAX_NEW, StaticWindowPolicy(3),
                            prompt_lens=lens, gamma_max=GMAX)
    cut = 0
    for eos in sorted({int(row[4 + i]) for i, row in enumerate(full)}):
        jt, js = jeng.generate(p, MAX_NEW, JStatic(3), prompt_lens=lens,
                               gamma_max=GMAX, eos_id=eos)
        tt, ts = teng.generate(p, MAX_NEW, StaticWindowPolicy(3),
                               prompt_lens=lens, gamma_max=GMAX, eos_id=eos)
        np.testing.assert_array_equal(tt, np.asarray(jt))
        assert (ts.accepted, ts.proposed, ts.iterations) == \
            (js.accepted, js.proposed, js.iterations)
        assert ts.acceptance_seqs == js.acceptance_seqs
        cut += int((tt < 0).any(axis=1).sum())
    assert ts.accepted > 0 and cut >= 3


# ------------------------------------------------------ sampled split step

def _gumbel(u):
    return -np.log(-np.log(np.maximum(u, np.finfo(np.float32).tiny)))


@pytest.mark.parametrize("temp", [0.7, 1.0])
def test_sampled_split_round_matches_reference_rule(prompts, temp):
    """One sampled round of the split step (hybrid target ← ssm draft, γ =
    γ_max) against the reference: the session generator's draws are
    replayed (the anchor's and the draft's Gumbel noise, then u and r) and
    fed to the reference models, the reference sampler (Gumbel-max) and
    the reference rule (``verify_reference``); the committed tokens and
    accept counts are equal, and the re-advanced target and draft states
    match the reference's ``_scan_cache_advance``."""
    jeng, teng = _engines("hybrid", "ssm", temperature=temp)
    p, lens = prompts
    B, V, seed = p.shape[0], 128, 11
    sess = DecodeSession(teng, capacity=B, max_new_cap=MAX_NEW,
                         gamma_max=GMAX, sync_every=1, seed=seed)
    sess.admit_batch(p, MAX_NEW, prompt_lens=lens)
    sess.run_chunk(StaticWindowPolicy(GMAX))
    g = torch.Generator()
    g.manual_seed(seed)
    draw = lambda *shape: torch.rand(shape, generator=g).numpy()
    anchor_u = draw(B, V)
    draft_u = [draw(B, V) for _ in range(GMAX)]
    u, r = draw(B, GMAX), draw(B)

    jd, jt = jeng.draft, jeng.target
    jdp, jtp = jeng.draft_params, jeng.target_params
    slots = sess.slots_len
    _, dcache = jd.prefill(jdp, j(p), slots, prompt_lens=j(lens))
    tl, tcache = jt.prefill(jtp, j(p), slots, prompt_lens=j(lens))
    anchor = np.asarray(tl)[np.arange(B), lens - 1]
    logp = lambda probs: np.log(np.maximum(np.asarray(probs), 1e-20))
    last = np.argmax(_gumbel(anchor_u) + logp(j_temp_probs(j(anchor), temp)),
                     -1).astype(np.int32)
    pos = lens.astype(np.int32)
    tok, dc, toks, qs = last, dcache, [], []
    for i in range(GMAX):
        lg, dc = jd.decode_step(jdp, j(tok), dc, j(pos + i))
        q = np.asarray(j_temp_probs(lg, temp))
        tok = np.argmax(_gumbel(draft_u[i]) + logp(q), -1).astype(np.int32)
        toks.append(tok)
        qs.append(q)
    toks = np.stack(toks, 1)
    window = np.concatenate([last[:, None], toks], 1)
    pl, _ = jt.verify_step(jtp, j(window), tcache, j(pos))
    out = j_verify_reference(j(toks), j(np.stack(qs, 1)),
                             j_temp_probs(pl, temp), j(u), j(r))
    n_acc = np.asarray(out.n_accepted)
    committed = np.where(np.arange(GMAX + 1)[None, :] == n_acc[:, None],
                         np.asarray(out.next_token)[:, None],
                         np.concatenate([toks, np.zeros((B, 1), np.int32)],
                                        1))
    num_new = np.minimum(n_acc + 1, MAX_NEW - 1)
    got = sess._out_buf.numpy()
    np.testing.assert_array_equal(got[:, 0], last)
    for b in range(B):
        np.testing.assert_array_equal(got[b, 1:1 + num_new[b]],
                                      committed[b, :num_new[b]])
    np.testing.assert_array_equal(sess._nacc[0].numpy(), n_acc)
    adv = j(np.concatenate([last[:, None], committed[:, :GMAX]], 1))
    want_t = j_advance(jt.decode_step, jtp, tcache, adv, j(pos),
                       j(num_new))
    want_d = j_advance(jd.decode_step, jdp, dcache, adv, j(pos), j(num_new))
    _compare_caches(sess._state.target_cache, want_t,
                    committed=pos + num_new)
    _compare_caches(sess._state.draft_cache, want_d)


# ------------------------------------------------------ serving, launcher

def test_staggered_cotenants_equal_solo():
    """On an ssm ← ssm pair: admit request 0 alone, co-admit 1 and 2
    mid-flight, retire 0 (scrubbing its row) and re-admit request 3 into
    its slot: every request commits the tokens of its solo run, with no
    new step key across the churn."""
    _, teng = _engines("ssm", "ssm")
    rng = np.random.default_rng(3)
    ps = [rng.integers(0, 128, int(n)).astype(np.int32)
          for n in (9, 13, 6, 11)]
    budgets = [12, 8, 12, 10]
    pol = StaticWindowPolicy(3)
    sess = DecodeSession(teng, capacity=3, max_new_cap=12, max_prompt_len=16,
                         gamma_max=GMAX, sync_every=2)
    outs = {}
    sess.admit(ps[0], budgets[0], request_id=0)
    sess.run_chunk(pol)
    warm = set(teng.step_keys)
    sess.admit(ps[1], budgets[1], request_id=1)
    sess.admit(ps[2], budgets[2], request_id=2)
    while 0 not in outs:
        sess.run_chunk(pol)
        for slot in sess.finished_slots():
            toks, rec = sess.retire(slot, scrub=True)
            outs[rec.request_id] = toks
    sess.admit(ps[3], budgets[3], request_id=3)
    for _ in range(64):
        if not sess.unfinished:
            break
        sess.run_chunk(pol)
        for slot in sess.finished_slots():
            toks, rec = sess.retire(slot)
            outs[rec.request_id] = toks
    assert not sess.unfinished
    assert teng.step_keys == warm
    for rid in range(4):
        solo, _ = teng.generate(ps[rid][None], budgets[rid], pol,
                                gamma_max=GMAX)
        assert len(outs[rid]) == budgets[rid]
        np.testing.assert_array_equal(outs[rid], solo[0, :budgets[rid]])


def test_paged_target_with_recurrent_draft_pages_one_side():
    """dense target ← ssm draft in a paged session: only the target pages
    (the draft's side reserves no blocks) and the served tokens equal the
    dense session's."""
    _, teng = _engines("dense", "ssm")
    rng = np.random.default_rng(6)
    ps = [rng.integers(0, 128, int(n)).astype(np.int32) for n in (9, 5, 12)]
    outs = {}
    for paged in (False, True):
        sess = DecodeSession(teng, capacity=2, max_new_cap=8,
                             max_prompt_len=16, gamma_max=GMAX,
                             sync_every=2, paged=paged)
        got, queue = {}, list(enumerate(ps))
        while queue or sess.unfinished:
            while queue and sess.free:
                rid, prompt = queue.pop(0)
                sess.admit(prompt, 8, request_id=rid)
            sess.run_chunk(StaticWindowPolicy(3))
            for slot in sess.finished_slots():
                toks, rec = sess.retire(slot)
                got[rec.request_id] = toks
        outs[paged] = got
        if paged:
            assert sess._alloc["draft"] is None
            assert sess._alloc["target"].used_blocks == 0
    for rid in range(3):
        np.testing.assert_array_equal(outs[True][rid], outs[False][rid])


def test_reset_slot_scrubs_recurrent_rows():
    cfg = TCfg(**TINY["hybrid"])
    cache = TModel(cfg, "cpu").init_cache(3, 8)
    for leaf in (cache.ssm.conv, cache.ssm.state, cache.shared_attn.k_buf):
        leaf.fill_(1.0)
    cache.shared_attn.pm_buf.fill_(5)
    reset_slot(cache, 1)
    for leaf in (cache.ssm.conv, cache.ssm.state, cache.shared_attn.k):
        assert (leaf[:, 1] == 0).all() and (leaf[:, 0] == 1).all()
    assert (cache.shared_attn.pos_map[:, 1] == -1).all()


@pytest.mark.parametrize("target", ["mamba2-130m", "zamba2-1.2b"])
def test_launcher_serves_recurrent_pairs_on_cpu(target):
    out = serve.run(["--device", "cpu", "--target", target, "--draft",
                     "mamba2-130m", "--requests", "3", "--max-new", "5",
                     "--gamma-max", "4"]).summary
    assert out["requests"] == 3 and out["tokens"] == 15
    assert out["step_programs"] == 2
    # neither side pages: a hybrid's shared attention stays dense
    with pytest.raises(ValueError, match="attention-family"):
        serve.run(["--device", "cpu", "--target", target, "--draft",
                   "mamba2-130m", "--requests", "1", "--max-new", "2",
                   "--paged-kv"])
