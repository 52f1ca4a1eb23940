"""The port's tree speculation, held against the JAX reference on the same
numpy inputs and bridged weights (tiny float32 dense models: d_model 64,
2 layers, vocab 128; γ_max 4, b_max 3).

Discrete results are compared exactly: the grid tables, the tree verdict
(n_accepted, winner, bonus, path, accept bitmap) against the reference's
``verify_tree_greedy`` and its Pallas ``tree_verify_fused`` in interpret
mode, the packed-word rule kernel B4b follows (``accept_rule_words``, at
T 2, 25, 33 and 65, so rows of several words count), pos_map writes,
proposed tree tokens, committed tokens, accept counts and acceptance bit
streams, and AWC's joint {γ, b} decisions. K/V copies are compared to 1e-6
(they are copies; the bound only names the type), and attention outputs to
atol/rtol 1e-5 (float32, sum order only). The CUDA kernels B4a/B4b (alone
and in their one-launch ``tree_verify_fused``) and B1's masked path are held
against these plain versions on the card by ``chip_smoke.py``."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs.base import ModelConfig as JCfg
from repro.core import tree as jtree
from repro.core.engine import SpecDecodeEngine as JEngine
from repro.core.session import DecodeSession as JSession
from repro.core.window import FeatureSnapshot as JFeat
from repro.core.window import StaticWindowPolicy as JStatic
from repro.core.window import make_window_policy as j_make_policy
from repro.kernels.verify.ops import tree_verify_fused as j_tree_verify_fused
from repro.models import kvcache as jkv
from repro.models.attention import attention_decode as j_attn
from repro.models.model import Model as JModel
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import ModelConfig as TCfg
from repro_torch.core import engine as tengine
from repro_torch.core import tree as ttree
from repro_torch.core.engine import SpecDecodeEngine
from repro_torch.core.session import DecodeSession
from repro_torch.core.window import (FeatureSnapshot, StaticWindowPolicy,
                                     make_window_policy)
from repro_torch.kernels.verify import (MAX_ENTRIES, accept_rule,
                                        accept_rule_words, pack_mask_words,
                                        tree_accept, tree_argmax,
                                        tree_verify_fused)
from repro_torch.models import kvcache as tkv
from repro_torch.models.attention import attention_decode as t_attn
from repro_torch.models.model import Model as TModel

CFG = dict(arch_type="dense", n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=2, d_ff=128, vocab=128, head_dim=16, dtype="float32",
           remat=False)
TARGET = dict(name="tiny-target", qk_norm=True)
GMAX, BMAX = 4, 3
MAX_NEW = 14
TOL = dict(atol=1e-5, rtol=1e-5)
COPY_TOL = dict(atol=1e-6, rtol=0)

t = torch.from_numpy
j = jnp.asarray


def _target_np(seed=1):
    """Weights in the reference's parameter layout (shapes from
    ``jax.eval_shape`` of its ``init_params``), drawn with numpy at its
    init scales N(0, 1/fan_in); norm scales moved off zero so their code
    paths count."""
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


@pytest.fixture(scope="module")
def weights():
    """Target and a noised copy as the draft: acceptance strictly between
    0 and 1, so chains break and other branches can win."""
    t_np = _target_np()
    return _noised(t_np, 0.1, 3), t_np


@pytest.fixture(scope="module")
def port_engine(weights):
    d_np, t_np = weights
    cfg = TCfg(**CFG, **TARGET)
    return SpecDecodeEngine(cfg, cfg, draft_params=params_from_numpy(d_np,
                                                                    "cpu"),
                            target_params=params_from_numpy(t_np, "cpu"),
                            device="cpu")


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(4)
    lens = np.array([9, 5, 12], np.int32)
    p = np.zeros((3, 12), np.int32)
    for i, n in enumerate(lens):
        p[i, :n] = rng.integers(0, 128, n)
    return p, lens


# ------------------------------------------------------------ grid tables

@pytest.mark.parametrize("d_max,b_max", [(4, 3), (3, 1), (2, 5)])
def test_tree_spec_matches_reference(d_max, b_max):
    ref, spec = jtree.TreeSpec(d_max, b_max), ttree.TreeSpec(d_max, b_max)
    assert spec.n_entries == ref.n_entries
    for name in ("depth_np", "branch_np", "parent_np", "tree_pos_np",
                 "mask_np"):
        np.testing.assert_array_equal(getattr(spec, name),
                                      getattr(ref, name))
    for name in ("parent_entry", "tree_pos", "win_mask", "depth", "branch"):
        np.testing.assert_array_equal(getattr(spec, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    for g in range(d_max + 1):
        for b in range(1, b_max + 1):
            got = spec.node_valid(torch.tensor(g, dtype=torch.int32),
                                  torch.tensor(b, dtype=torch.int32))
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(ref.node_valid(j(g), j(b))))
    for d, (s_off, p_off, mask) in enumerate(spec.depth_windows):
        lo, hi = ref.row_slice(d)
        np.testing.assert_array_equal(s_off.numpy(), np.arange(lo, hi))
        assert (p_off == 1 + d).all()
        np.testing.assert_array_equal(mask.numpy(), ref.mask_np[lo:hi])


def test_expected_accepted_matches_reference():
    for a in (0.0, 0.2, 0.47, 0.9, 1.0):
        for g in (0, 1, 4, 8):
            for b in (1, 2, 3, 5):
                assert ttree.tree_expected_accepted(a, g, b) == \
                    jtree.tree_expected_accepted(a, g, b)


# ----------------------------------------------------------------- verdict

def _verdict_inputs(spec, V, seed):
    """Random logits with planted accepted edges and planted exact ties
    (two equal maxima, one below and one above a 512-wide vocab tile
    boundary when V allows it)."""
    T, B = spec.n_entries, 4
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, V, (B, T)).astype(np.int32)
    logits = rng.normal(size=(B, T, V)).astype(np.float32)
    for bi in range(B):
        for e in range(1, T):
            r = rng.random()
            if r < 0.55:        # the target predicts the child's token
                logits[bi, spec.parent_np[e], toks[bi, e]] = 50.0
            elif r < 0.75:      # a tie the child wins only on its lower id
                lo = int(rng.integers(0, min(V, 512) // 2))
                hi = int(rng.integers(max(lo + 1, V - 100), V))
                logits[bi, spec.parent_np[e], [lo, hi]] = 60.0
                toks[bi, e] = lo if rng.random() < 0.5 else hi
    logits[0, 0, :] = -np.inf                  # an all −inf row → id 0
    return toks, logits


@pytest.mark.parametrize("V", [128, 700])
def test_verify_tree_greedy_matches_reference(V):
    """The plain verdict equals the reference's ``verify_tree_greedy`` and
    its Pallas ``tree_verify_fused`` (interpret mode) over a (γ, b) sweep;
    the port's wrappers (plain on CPU tensors) give the same triple."""
    spec, ref = ttree.TreeSpec(GMAX, BMAX), jtree.TreeSpec(GMAX, BMAX)
    toks, logits = _verdict_inputs(spec, V, seed=V)
    tt, tl = t(toks), t(logits)
    assert (tree_argmax(tl) == torch.argmax(tl, -1)).all()
    wins = set()
    for g in range(GMAX + 1):
        for b in range(1, BMAX + 1):
            nv = spec.node_valid(g, b)
            got = ttree.verify_tree_greedy(tt, tl, spec.parent_entry,
                                           spec.tree_pos, nv, spec.win_mask,
                                           GMAX)
            jnv = ref.node_valid(j(g), j(b))
            want = jtree.verify_tree_greedy(j(toks), j(logits),
                                            ref.parent_entry, ref.tree_pos,
                                            jnv, ref.win_mask, GMAX)
            for a, w in zip(got, want):
                np.testing.assert_array_equal(a.numpy(), np.asarray(w))
            fused = j_tree_verify_fused(j(toks), j(logits), ref.parent_entry,
                                        ref.tree_pos, jnv, ref.win_mask,
                                        interpret=True)
            port = tree_verify_fused(tt, tl, spec.parent_entry,
                                     spec.tree_pos, nv, spec.win_mask)
            for a, f, w in zip(port, fused,
                               (got.n_accepted, got.winner, got.next_token)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(f))
                np.testing.assert_array_equal(a.numpy(), w.numpy())
            wins.update(spec.branch_np[got.winner.numpy()].tolist())
    assert wins - {0}, wins                 # later branches win too


WORD_TREES = [(1, 1), (8, 3), (8, 4), (16, 4)]     # T 2, 25, 33, 65


@pytest.mark.parametrize("d_max,b_max", WORD_TREES)
def test_win_words_pack_the_mask(d_max, b_max):
    """``TreeSpec.win_words`` is the ancestor bitmap packed little-endian
    (bit a % 32 of word a // 32 of row e), on the host and the device, and
    :func:`pack_mask_words` packs a (T, T) mask the same way."""
    spec = ttree.TreeSpec(d_max, b_max)
    T = spec.n_entries
    W = -(-T // 32)
    packed = np.packbits(spec.mask_np, axis=1, bitorder="little")
    packed = np.pad(packed, ((0, 0), (0, 4 * W - packed.shape[1])))
    want = np.ascontiguousarray(packed).view("<u4").astype(np.int64)
    bits = np.zeros((T, W), np.int64)
    for e, a in zip(*np.nonzero(spec.mask_np)):
        bits[e, a // 32] |= 1 << (a % 32)
    np.testing.assert_array_equal(want, bits)
    for words in (spec.win_words_np, spec.win_words.numpy(),
                  pack_mask_words(spec.win_mask).numpy()):
        assert words.dtype == np.int32 and words.shape == (T, W)
        np.testing.assert_array_equal(words.view(np.uint32), want)


@pytest.mark.parametrize("d_max,b_max", WORD_TREES)
def test_accept_rule_words_matches_reference(d_max, b_max):
    """The packed-word rule equals ``accept_rule`` (accept bitmap too) and
    the reference's Pallas ``tree_verify_fused`` in interpret mode over
    every (γ, b); the port's glue given the packed words agrees."""
    spec, ref = ttree.TreeSpec(d_max, b_max), jtree.TreeSpec(d_max, b_max)
    T = spec.n_entries
    toks, logits = _verdict_inputs(spec, 128, seed=T)
    tgt_np = logits.argmax(-1)
    # deep paths too: row r follows the target on branch b_max − 1 − r %
    # b_max down to depth d_max − r, so the last entries (the last word's
    # bits) are accepted and win
    deep = toks.copy()
    for r in range(deep.shape[0]):
        k = b_max - 1 - r % b_max
        for e in range(1, T):
            if spec.branch_np[e] == k and spec.depth_np[e] < d_max - r:
                deep[r, e] = tgt_np[r, spec.parent_np[e]]
    tl = t(logits)
    tgt = torch.argmax(tl, -1).to(torch.int32)
    winners = set()
    for toks_np in (toks, deep):
        tt = t(toks_np)
        for g in range(d_max + 1):
            for b in range(1, b_max + 1):
                nv = spec.node_valid(g, b)
                got = accept_rule_words(tt, tgt, spec.parent_entry,
                                        spec.tree_pos, nv, spec.win_words)
                want = accept_rule(tt, tgt, spec.parent_entry,
                                   spec.tree_pos, nv, spec.win_mask)
                for a, w in zip(got, want):
                    assert a.dtype == w.dtype
                    np.testing.assert_array_equal(a.numpy(), w.numpy())
                fused = j_tree_verify_fused(
                    j(toks_np), j(logits), ref.parent_entry, ref.tree_pos,
                    ref.node_valid(j(g), j(b)), ref.win_mask,
                    interpret=True)
                port = tree_verify_fused(tt, tl, spec.parent_entry,
                                         spec.tree_pos, nv, spec.win_mask,
                                         spec.win_words)
                for a, f, p in zip(got[1:], fused, port):
                    np.testing.assert_array_equal(a.numpy(), np.asarray(f))
                    np.testing.assert_array_equal(a.numpy(), p.numpy())
                winners.update(got[2].tolist())
    assert T - 1 in winners                 # the last entry, last word


def test_tree_verify_wrapper_checks():
    """The one-launch wrapper: CPU tensors run B4a's and B4b's plain
    versions (the card's packed words and counters are not read); meta
    tensors and more than MAX_ENTRIES entries raise."""
    spec = ttree.TreeSpec(8, 4)
    toks, logits = _verdict_inputs(spec, 128, seed=5)
    tt, tl = t(toks), t(logits)
    nv = spec.node_valid(5, 3)
    counters = torch.zeros(tt.shape[0], dtype=torch.int32)
    want = accept_rule(tt, torch.argmax(tl, -1).to(torch.int32),
                       spec.parent_entry, spec.tree_pos, nv, spec.win_mask)
    for extra in ((), (spec.win_words, counters)):
        got = tree_verify_fused(tt, tl, spec.parent_entry, spec.tree_pos,
                                nv, spec.win_mask, *extra)
        for a, w in zip(got, want[1:]):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), w.numpy())
    with pytest.raises(ValueError, match="cuda or cpu"):
        tree_verify_fused(tt.to("meta"), tl.to("meta"), spec.parent_entry,
                          spec.tree_pos, nv, spec.win_mask, spec.win_words,
                          counters.to("meta"))
    big = ttree.TreeSpec(MAX_ENTRIES // 4, 4)           # T = MAX_ENTRIES + 1
    T = big.n_entries
    assert T == MAX_ENTRIES + 1
    with pytest.raises(ValueError, match=f"at most {MAX_ENTRIES}"):
        tree_verify_fused(torch.zeros((1, T), dtype=torch.int32),
                          torch.zeros((1, T, 4)), big.parent_entry,
                          big.tree_pos, big.node_valid(1, 1), big.win_mask,
                          big.win_words, torch.zeros(1, dtype=torch.int32))


def test_tree_committed_matches_reference():
    spec, ref = ttree.TreeSpec(GMAX, BMAX), jtree.TreeSpec(GMAX, BMAX)
    toks, logits = _verdict_inputs(spec, 128, seed=9)
    nv = spec.node_valid(GMAX, BMAX)
    got = ttree.verify_tree_greedy(t(toks), t(logits), spec.parent_entry,
                                   spec.tree_pos, nv, spec.win_mask, GMAX)
    want = jtree.verify_tree_greedy(j(toks), j(logits), ref.parent_entry,
                                    ref.tree_pos, ref.node_valid(GMAX, BMAX),
                                    ref.win_mask, GMAX)
    for a, w in zip(ttree.tree_committed(t(toks), got, GMAX),
                    jtree.tree_committed(j(toks), want, GMAX)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))


def test_tree_accept_wrapper_checks():
    """CPU tensors run the plain version; other devices raise."""
    spec = ttree.TreeSpec(2, 2)
    toks = torch.zeros((1, spec.n_entries), dtype=torch.int32)
    out = tree_accept(toks, toks, spec.parent_entry, spec.tree_pos,
                      spec.node_valid(2, 2), spec.win_mask)
    assert [int(x) for x in out] == [2, 3, 0]   # all match: depth 1, branch 0
    meta = torch.zeros((1, 3, 8), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tree_argmax(meta)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tree_accept(toks.to("meta"), toks, spec.parent_entry, spec.tree_pos,
                    spec.node_valid(2, 2), spec.win_mask)


# ------------------------------------------------------------------ caches

def test_update_layer_cache_offsets_match():
    """Tree window writes (slot ≠ position) at ragged positions, one row
    running past the cache edge (dropped), equal the reference scatter."""
    spec = ttree.TreeSpec(3, 2)
    T, B, S, Hkv, hd = spec.n_entries, 3, 12, 2, 8
    rng = np.random.default_rng(2)
    cache = tkv.init_attn_cache(1, B, S, Hkv, hd, torch.float32, "cpu")
    jk = jnp.zeros((B, S, Hkv, hd))
    jv, jpm = jnp.zeros_like(jk), jnp.full((B, S), -1, jnp.int32)
    for pos in ([0, 3, 8], [2, 4, 9]):
        kn = rng.normal(size=(B, T, Hkv, hd)).astype(np.float32)
        vn = rng.normal(size=(B, T, Hkv, hd)).astype(np.float32)
        p = np.asarray(pos, np.int32)
        jk, jv, jpm = jkv.update_layer_cache(
            jk, jv, jpm, j(kn), j(vn), j(p), False,
            slot_off=j(spec.slot_off.numpy()), pos_off=j(spec.tree_pos_np))
        tkv.update_layer_cache(cache.k_buf[0], cache.v_buf[0],
                               cache.pm_buf[0], t(kn), t(vn), t(p), False,
                               slot_off=spec.slot_off,
                               pos_off=spec.tree_pos)
    np.testing.assert_allclose(cache.k[0].numpy(), np.asarray(jk),
                               **COPY_TOL)
    np.testing.assert_allclose(cache.v[0].numpy(), np.asarray(jv),
                               **COPY_TOL)
    np.testing.assert_array_equal(cache.pos_map[0].numpy(), np.asarray(jpm))


def test_tree_commit_cache_matches():
    """Winning-path relocation and loser scrub equal the reference: paths
    on every branch, a done row (n_acc 0), a budget-clamped row, a path
    whose last source is a never-written hole, a row near the cache edge."""
    spec = ttree.TreeSpec(GMAX, BMAX)
    T, B, S, L, Hkv, hd = spec.n_entries, 5, 24, 2, 2, 8
    rng = np.random.default_rng(3)
    k = rng.normal(size=(L, B, S, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(L, B, S, Hkv, hd)).astype(np.float32)
    pos = np.array([2, 5, 0, 7, S - 3], np.int32)
    pm = np.tile(np.arange(S, dtype=np.int32), (L, B, 1))
    for bi, p0 in enumerate(pos):        # tree layout: slot p+e at p+tpos
        pm[:, bi, p0:p0 + T] = (p0 + spec.tree_pos_np)[:S - p0]
    pm[:, 3, pos[3] + T - 1] = -1        # the draft's never-written tail
    winner = np.array([1 + 3 * BMAX + 2, 1 + 1 * BMAX + 1, 0, T - 1,
                       1 + 2 * BMAX], np.int32)
    n_acc = np.array([4, 2, 0, 4, 3], np.int32)
    n_acc_eff = np.array([4, 1, 0, 4, 3], np.int32)     # row 1 clamped
    path = ttree.tree_path_from_winner(t(winner), spec.parent_entry,
                                       spec.tree_pos, GMAX)
    jpath = jtree.tree_path_from_winner(j(winner), jtree.TreeSpec(
        GMAX, BMAX).parent_entry, j(spec.tree_pos_np), GMAX)
    np.testing.assert_array_equal(path.numpy(), np.asarray(jpath))
    assert (spec.tree_pos_np[winner] == n_acc).all()
    ref = jkv.tree_commit_cache(jkv.AttnCache(k=j(k), v=j(v), pos_map=j(pm)),
                                j(pos), jpath, j(n_acc_eff), T)
    cache = tkv.init_attn_cache(L, B, S, Hkv, hd, torch.float32, "cpu")
    cache.k_buf[:, :B], cache.v_buf[:, :B] = t(k), t(v)
    cache.pm_buf[:, :B] = t(pm)
    tkv.tree_commit_cache(cache, t(pos), path, t(n_acc_eff), T)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(ref.k), **COPY_TOL)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(ref.v), **COPY_TOL)
    np.testing.assert_array_equal(cache.pos_map.numpy(),
                                  np.asarray(ref.pos_map))


# --------------------------------------------------------------- attention

@pytest.mark.parametrize("rows", ["verify", "depth1"])
def test_masked_attention_matches(weights, rows):
    """One attention layer over a tree window — the target's full verify
    window, or a draft depth window (b_max rows of the bitmap) — equals the
    reference's tree ``attention_decode``: output (1e-5) and written cache
    (pos_map exactly)."""
    _, t_np = weights
    p_np = {k: v[0] for k, v in t_np["layers"]["attn"].items()}
    jcfg, tcfg = JCfg(**CFG, **TARGET), TCfg(**CFG, **TARGET)
    spec = ttree.TreeSpec(GMAX, BMAX)
    if rows == "verify":
        s_off, p_off, mask = spec.slot_off, spec.tree_pos, spec.win_mask
    else:
        s_off, p_off, mask = spec.depth_windows[1]
    B, S, Tq = 2, 40, s_off.shape[0]
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B, Tq, 64)).astype(np.float32)
    pos = np.array([5, 17], np.int32)
    k0 = rng.normal(size=(B, S, 2, 16)).astype(np.float32)
    # committed prefix, then stale entries inside and past the region
    pm0 = np.where(np.arange(S)[None] <= pos[:, None], np.arange(S)[None],
                   np.arange(S)[None] - 3).astype(np.int32)
    @jax.jit
    def ref(x, p, k, pm, pos, s_off, p_off, mask):
        return j_attn(x, p, jcfg, k, k, pm, pos, False, slot_off=s_off,
                      pos_off=p_off, win_mask=mask)
    jout, _, _, jpm = ref(j(x), {k: j(v) for k, v in p_np.items()}, j(k0),
                          j(pm0), j(pos), j(s_off.numpy()), j(p_off.numpy()),
                          j(mask.numpy()))
    cache = tkv.init_attn_cache(1, B, S, 2, 16, torch.float32, "cpu")
    cache.k_buf[0, :B], cache.v_buf[0, :B] = t(k0), t(k0)
    cache.pm_buf[0, :B] = t(pm0)
    out = t_attn(t(x), params_from_numpy(p_np, "cpu"), tcfg, cache.k_buf[0],
                 cache.v_buf[0], cache.pm_buf[0], t(pos), False,
                 slot_off=s_off, pos_off=p_off, win_mask=mask)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_array_equal(cache.pos_map[0].numpy(), np.asarray(jpm))


def test_tree_propose_matches(weights, prompts):
    """The draft's grid proposal after a prefill: identical tree tokens and
    pos_map, K/V within 1e-5."""
    d_np, _ = weights
    jcfg, tcfg = JCfg(**CFG, **TARGET), TCfg(**CFG, **TARGET)
    jm, tm = JModel(jcfg), TModel(tcfg, "cpu")
    jp, tp = jax.tree.map(jnp.asarray, d_np), params_from_numpy(d_np, "cpu")
    p, lens = prompts
    S = 40
    rows = np.arange(3)

    tl, tc = tm.prefill(tp, t(p), S)
    last = tl[rows, lens - 1].argmax(-1).to(torch.int32)
    # the reference proposes from the same prefilled cache
    jc = jkv.AttnCache(k=j(tc.k.numpy()), v=j(tc.v.numpy()),
                       pos_map=j(tc.pos_map.numpy()))
    propose = jax.jit(lambda params, cache, last, lens: jtree.tree_propose(
        jm, params, cache, last, lens, jtree.TreeSpec(GMAX, BMAX)))
    jtoks, jc = propose(jp, jc, j(last.numpy()), j(lens))
    ttoks, tc = ttree.tree_propose(tm, tp, tc, last, t(lens),
                                   ttree.TreeSpec(GMAX, BMAX))
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(tc.pos_map.numpy(), np.asarray(jc.pos_map))
    np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k), **TOL)


def test_top_lowest_id_orders_ties_like_lax_top_k():
    x = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, -np.inf],
                  [0.5, 0.5, 0.5, 0.5, 0.5, 0.5]], np.float32)
    _, want = jax.lax.top_k(j(x), 4)
    np.testing.assert_array_equal(ttree._top_lowest_id(t(x), 4).numpy(),
                                  np.asarray(want))


# ---------------------------------------------------------------- sessions

def target_greedy(eng, prompt, n):
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


def _run(sess, prompts, policies):
    """Admit the prompts one by one into a live session (request i → slot
    i), decode to the end cycling ``policies`` chunk by chunk."""
    p, lens = prompts
    for i, n in enumerate(lens):
        sess.admit(p[i, :n], MAX_NEW, request_id=i)
    i = 0
    while sess.unfinished:
        sess.run_chunk(policies[i % len(policies)])
        i += 1
    toks, stats = sess.snapshot()
    return np.asarray(toks), stats


@pytest.mark.parametrize("use_verify_kernel", [False, True])
def test_tree_session_matches_reference(weights, port_engine, prompts,
                                        use_verify_kernel, monkeypatch):
    """DecodeSession(max_branches=3), static γ 3 × b 3: committed tokens,
    accept counts and per-request bit streams equal the reference session's
    (its verdict from jnp or from the Pallas pair in interpret mode); the
    tokens are the target's greedy decode, and branches other than the
    first win rounds."""
    d_np, t_np = weights
    jcfg = JCfg(**CFG, **TARGET)
    jeng = JEngine(jcfg, jcfg, draft_params=jax.tree.map(jnp.asarray, d_np),
                   target_params=jax.tree.map(jnp.asarray, t_np),
                   temperature=0.0, key=jax.random.PRNGKey(0),
                   use_verify_kernel=use_verify_kernel)
    kw = dict(capacity=3, max_new_cap=MAX_NEW, max_prompt_len=12,
              gamma_max=GMAX, sync_every=4, max_branches=BMAX)
    jt, js = _run(JSession(jeng, mode_policy="distributed", **kw), prompts,
                  [JStatic(3, branches=3)])
    sess = DecodeSession(port_engine, **kw)
    winners = []

    def recording(*args):
        out = tree_verify_fused(*args)
        winners.append((out[1].clone(), sess._done.clone()))
        return out
    monkeypatch.setattr(tengine, "tree_verify_fused", recording)
    tt, ts = _run(sess, prompts, [StaticWindowPolicy(3, branches=3)])
    np.testing.assert_array_equal(tt, jt)
    assert (ts.accepted, ts.proposed, ts.iterations) == \
        (js.accepted, js.proposed, js.iterations)
    assert ts.acceptance_seqs == js.acceptance_seqs
    assert 0 < ts.accepted < ts.proposed
    p, lens = prompts
    for i in range(3):
        np.testing.assert_array_equal(
            tt[i], target_greedy(port_engine, p[i, :lens[i]], MAX_NEW))
    branch = sess.engine._tree_specs[("tree", GMAX, BMAX)].branch
    side_wins = sum(int(((branch[w.long()] > 0) & ~d).sum())
                    for w, d in winners)
    assert side_wins > 0


def test_eos_tree_session_matches_reference(weights, port_engine, prompts):
    """``eos_id`` ≥ 0 in a tree ``DecodeSession(max_branches=3)`` (static
    γ 3 × b 3): the verdict's bonus goes through ``slot_stop_mask``; for
    stop tokens taken from each greedy stream (row i's token at 4 + i),
    tokens, accept counts, rounds and acceptance bit streams equal the
    reference session's, and rows stop before their budget."""
    d_np, t_np = weights
    jcfg = JCfg(**CFG, **TARGET)
    jeng = JEngine(jcfg, jcfg, draft_params=jax.tree.map(jnp.asarray, d_np),
                   target_params=jax.tree.map(jnp.asarray, t_np),
                   temperature=0.0, key=jax.random.PRNGKey(0))
    kw = dict(capacity=3, max_new_cap=MAX_NEW, max_prompt_len=12,
              gamma_max=GMAX, sync_every=4, max_branches=BMAX)
    full, _ = _run(DecodeSession(port_engine, **kw), prompts,
                   [StaticWindowPolicy(3, branches=3)])
    cut = 0
    for eos in sorted({int(row[4 + i]) for i, row in enumerate(full)}):
        jt, js = _run(JSession(jeng, mode_policy="distributed", eos_id=eos,
                               **kw), prompts, [JStatic(3, branches=3)])
        tt, ts = _run(DecodeSession(port_engine, eos_id=eos, **kw), prompts,
                      [StaticWindowPolicy(3, branches=3)])
        np.testing.assert_array_equal(tt, jt)
        assert (ts.accepted, ts.proposed, ts.iterations) == \
            (js.accepted, js.proposed, js.iterations)
        assert ts.acceptance_seqs == js.acceptance_seqs
        cut += int((tt < 0).any(axis=1).sum())
    assert cut >= 3


def test_one_branch_tree_equals_linear(port_engine, prompts):
    """The degenerate tree (max_branches=1) commits the linear session's
    tokens with the same acceptance bits."""
    kw = dict(capacity=3, max_new_cap=MAX_NEW, max_prompt_len=12,
              gamma_max=GMAX, sync_every=4)
    pol = [StaticWindowPolicy(3)]
    lt, ls = _run(DecodeSession(port_engine, **kw), prompts, pol)
    bt, bs = _run(DecodeSession(port_engine, max_branches=1, **kw), prompts,
                  pol)
    np.testing.assert_array_equal(bt, lt)
    assert bs.acceptance_seqs == ls.acceptance_seqs
    assert (bs.accepted, bs.iterations) == (ls.accepted, ls.iterations)


def test_branch_sweep_adds_no_step_key(port_engine, prompts):
    """After the tree step is built, every (γ, b) ≤ (γ_max, b_max) runs on
    it — policies change chunk by chunk — with no new step key, and the
    tokens stay the target's greedy decode."""
    kw = dict(capacity=3, max_new_cap=MAX_NEW, max_prompt_len=12,
              gamma_max=GMAX, sync_every=1, max_branches=BMAX)
    _run(DecodeSession(port_engine, **kw), prompts,
         [StaticWindowPolicy(GMAX, branches=BMAX)])
    before = set(port_engine.step_keys)
    sweep = [StaticWindowPolicy(g, branches=b)
             for g in range(1, GMAX + 1) for b in range(1, BMAX + 1)]
    toks, _ = _run(DecodeSession(port_engine, **kw), prompts, sweep)
    assert port_engine.step_keys == before
    assert ("tree", GMAX, BMAX) in before
    p, lens = prompts
    for i in range(3):
        np.testing.assert_array_equal(
            toks[i], target_greedy(port_engine, p[i, :lens[i]], MAX_NEW))


def test_tree_session_gates(port_engine):
    """The reference's refusals: paged KV and pipeline mode; a paged tree
    window raises at the model too."""
    with pytest.raises(ValueError, match="dense KV"):
        DecodeSession(port_engine, capacity=1, max_new_cap=4, max_branches=2,
                      paged=True)
    with pytest.raises(ValueError, match="pipeline"):
        DecodeSession(port_engine, capacity=1, max_new_cap=4, max_branches=2,
                      mode_policy="pipeline")
    m = port_engine.target
    pool = m.init_paged_cache(1, 16, 4, 4)
    spec = ttree.TreeSpec(2, 2)
    with pytest.raises(NotImplementedError, match="dense"):
        m.verify_step(port_engine.target_params,
                      torch.zeros((1, spec.n_entries), dtype=torch.int32),
                      pool, torch.zeros(1, dtype=torch.int32),
                      slot_off=spec.slot_off, pos_off=spec.tree_pos,
                      win_mask=spec.win_mask)


def test_awc_tree_decisions_match_reference():
    """AWC with max_branches=3 (default predictor + stabilizer + the joint
    {γ, b} pick) makes the reference's decisions on fixed snapshots."""
    rng = np.random.default_rng(7)
    for bw in (1.0, 0.001):
        jp = j_make_policy("awc", max_branches=3, bandwidth_gbps=bw)
        tp = make_window_policy("awc", max_branches=3, bandwidth_gbps=bw)
        widths = set()
        for _ in range(80):
            f = [float(rng.uniform(0, 2)), float(rng.uniform(0, 1)),
                 float(rng.choice([0.0, 5.0, 40.0])),
                 float(rng.uniform(5, 80)), float(rng.integers(1, 9)), 0.0,
                 float(rng.integers(1, 4))]
            a = jp.decide("pair0", JFeat(*f))
            b = tp.decide("pair0", FeatureSnapshot(*f))
            assert (a.gamma, a.mode, a.branches) == \
                (b.gamma, b.mode, b.branches)
            widths.add(b.branches)
        assert len(widths) > 1, widths
