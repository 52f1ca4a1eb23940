"""The port's encoder-decoder (whisper) and vlm (internvl2) families, held
against the JAX reference on the same numpy inputs and bridged weights,
float32, at the configs' ``reduced()`` sizes (whisper: 2 + 2 layers, d 256,
4 heads of 64, 16 frames, vocab 512; internvl2: 2 layers, d 256).

- whisper: the encoder's output over the frontend frames, every decoder
  layer's cross K/V, and prefill / decode / verify logits;
  ``generate(frontend=)`` of a whisper target under its noised copy:
  tokens and acceptance bits equal the reference engine's, and a second
  call on the engine (the same pool) repeats them;
- per-slot admission refuses whisper and vlm pairs with the reference's
  message (whole waves take ``admit_batch(frontend=)``);
- a vlm prefill given a frontend raises ``NotImplementedError`` in both
  packages; text-only, a vlm target's ``generate`` tokens equal the
  reference's.

Tolerances: ``LOGIT_TOL`` atol = rtol = 1e-4 for logits, encoder output
and cross K/V; tokens and counts exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get
from repro.core.engine import SpecDecodeEngine as JEngine
from repro.core.session import DecodeSession as JSession
from repro.core.window import StaticWindowPolicy as JStatic
from repro.models.model import Model as JModel
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config as t_get
from repro_torch.core.engine import SpecDecodeEngine
from repro_torch.core.session import FRONTEND_REFUSAL, DecodeSession
from repro_torch.core.window import StaticWindowPolicy
from repro_torch.models.model import Model as TModel

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
GMAX = 4
MAX_NEW = 8


def cfgs(name):
    return j_get(name).reduced(), t_get(name).reduced()


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, **LOGIT_TOL)
    np.testing.assert_array_equal(a.argmax(-1), b.argmax(-1))


def _frontend(cfg, B, seed):
    return np.random.default_rng(seed).normal(
        size=(B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def whisper():
    jcfg, tcfg = cfgs("whisper-tiny")
    p = jax.device_get(JModel(jcfg).init_params(jax.random.PRNGKey(1)))
    return jcfg, tcfg, p


def test_whisper_encoder_and_cross_kv_match(whisper):
    jcfg, tcfg, p = whisper
    jm, tm = JModel(jcfg), TModel(tcfg, "cpu")
    jp, tp = jax.tree.map(jnp.asarray, p), params_from_numpy(p, "cpu")
    fe = _frontend(jcfg, 2, 2)
    jenc = jm._encode(jp, jnp.asarray(fe))
    tenc = tm._encode(tp, torch.from_numpy(fe))
    np.testing.assert_allclose(tenc.numpy(), np.asarray(jenc), **LOGIT_TOL)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 6)
                                             ).astype(np.int32)
    _, jc = jm.prefill(jp, jnp.asarray(toks), 16, frontend=jnp.asarray(fe))
    _, tc = tm.prefill(tp, torch.from_numpy(toks), 16,
                       frontend=torch.from_numpy(fe))
    assert tc.cross_k.shape == (jcfg.n_layers, 2, jcfg.n_frontend_tokens,
                                jcfg.n_kv_heads, jcfg.head_dim)
    np.testing.assert_allclose(tc.cross_k.numpy(), np.asarray(jc.cross_k),
                               **LOGIT_TOL)
    np.testing.assert_allclose(tc.cross_v.numpy(), np.asarray(jc.cross_v),
                               **LOGIT_TOL)


def test_whisper_steps_match(whisper):
    """prefill → decode_step → verify_step logits equal the reference's;
    the self-attention cache's positions too."""
    jcfg, tcfg, p = whisper
    jm, tm = JModel(jcfg), TModel(tcfg, "cpu")
    jp, tp = jax.tree.map(jnp.asarray, p), params_from_numpy(p, "cpu")
    fe = _frontend(jcfg, 2, 4)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab, (2, 7)).astype(np.int32)
    jl, jc = jm.prefill(jp, jnp.asarray(toks), 24, frontend=jnp.asarray(fe))
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), 24,
                        frontend=torch.from_numpy(fe))
    _close(tl.numpy(), jl)
    pos = np.array([7, 7], np.int32)
    nxt = np.asarray(jl[:, -1].argmax(-1)).astype(np.int32)
    jl, jc = jm.decode_step(jp, jnp.asarray(nxt), jc, jnp.asarray(pos))
    tl, tc = tm.decode_step(tp, torch.from_numpy(nxt), tc,
                            torch.from_numpy(pos))
    _close(tl.numpy(), jl)
    win = rng.integers(0, jcfg.vocab, (2, 5)).astype(np.int32)
    jl, jc = jm.verify_step(jp, jnp.asarray(win), jc, jnp.asarray(pos + 1))
    tl, tc = tm.verify_step(tp, torch.from_numpy(win), tc,
                            torch.from_numpy(pos + 1))
    _close(tl.numpy(), jl)
    np.testing.assert_array_equal(tc.self_attn.pos_map.numpy(),
                                  np.asarray(jc.self_attn.pos_map))


def _noised(p, scale, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (a + scale * a.std() * rng.normal(
        size=a.shape)).astype(a.dtype), p)


def _engines(jcfg, tcfg, p):
    d = _noised(p, 0.02, 6)
    jeng = JEngine(jcfg, jcfg, draft_params=jax.tree.map(jnp.asarray, d),
                   target_params=jax.tree.map(jnp.asarray, p),
                   temperature=0.0, key=jax.random.PRNGKey(0))
    teng = SpecDecodeEngine(tcfg, tcfg, draft_params=params_from_numpy(
        d, "cpu"), target_params=params_from_numpy(p, "cpu"), device="cpu")
    return jeng, teng


def _prompts(vocab, seed=7):
    rng = np.random.default_rng(seed)
    lens = np.array([6, 3, 8], np.int32)
    p = np.zeros((3, 8), np.int32)
    for i, n in enumerate(lens):
        p[i, :n] = rng.integers(0, vocab, n)
    return p, lens


def test_whisper_generate_with_frontend_matches_reference(whisper):
    jcfg, tcfg, p = whisper
    jeng, teng = _engines(jcfg, tcfg, p)
    prompts, lens = _prompts(jcfg.vocab)
    fe = _frontend(jcfg, 3, 8)
    jt, js = jeng.generate(prompts, MAX_NEW, JStatic(3), prompt_lens=lens,
                           gamma_max=GMAX, frontend=jnp.asarray(fe))
    tt, ts = teng.generate(prompts, MAX_NEW, StaticWindowPolicy(3),
                           prompt_lens=lens, gamma_max=GMAX, frontend=fe)
    np.testing.assert_array_equal(tt, np.asarray(jt))
    assert ts.acceptance_seqs == js.acceptance_seqs
    assert 0 < ts.accepted < ts.proposed
    again, _ = teng.generate(prompts, MAX_NEW, StaticWindowPolicy(3),
                             prompt_lens=lens, gamma_max=GMAX, frontend=fe)
    np.testing.assert_array_equal(again, tt)
    assert sum(len(v) for v in teng.pools.values()) == 1


@pytest.mark.parametrize("name", ["whisper-tiny", "internvl2-76b"])
def test_per_slot_admission_refuses_frontend_families(name):
    jcfg, tcfg = cfgs(name)
    kw = dict(capacity=2, max_new_cap=4, max_prompt_len=8, gamma_max=GMAX)
    jeng = JEngine(jcfg, jcfg, temperature=0.0, key=jax.random.PRNGKey(0))
    with pytest.raises(AssertionError, match="frontend-free"):
        JSession(jeng, **kw).admit(np.arange(1, 4, dtype=np.int32), 4)
    teng = SpecDecodeEngine(tcfg, tcfg, device="cpu")
    with pytest.raises(ValueError, match="frontend-free") as err:
        DecodeSession(teng, **kw).admit(np.arange(1, 4, dtype=np.int32), 4)
    assert str(err.value) == FRONTEND_REFUSAL
    assert not teng.pools


@pytest.fixture(scope="module")
def vlm():
    jcfg, tcfg = cfgs("internvl2-76b")
    p = jax.device_get(JModel(jcfg).init_params(jax.random.PRNGKey(9)))
    return jcfg, tcfg, p


def test_vlm_prefill_with_frontend_raises(vlm):
    jcfg, tcfg, p = vlm
    toks = np.zeros((1, 4), np.int32)
    fe = _frontend(jcfg, 1, 10)
    with pytest.raises(NotImplementedError):
        JModel(jcfg).prefill(jax.tree.map(jnp.asarray, p), jnp.asarray(toks),
                             8, frontend=jnp.asarray(fe))
    with pytest.raises(NotImplementedError):
        TModel(tcfg, "cpu").prefill(params_from_numpy(p, "cpu"),
                                    torch.from_numpy(toks), 8,
                                    frontend=torch.from_numpy(fe))


def test_vlm_text_only_generate_matches_reference(vlm):
    jcfg, tcfg, p = vlm
    jeng, teng = _engines(jcfg, tcfg, p)
    prompts, lens = _prompts(jcfg.vocab, 11)
    jt, js = jeng.generate(prompts, MAX_NEW, JStatic(3), prompt_lens=lens,
                           gamma_max=GMAX)
    tt, ts = teng.generate(prompts, MAX_NEW, StaticWindowPolicy(3),
                           prompt_lens=lens, gamma_max=GMAX)
    np.testing.assert_array_equal(tt, np.asarray(jt))
    assert ts.acceptance_seqs == js.acceptance_seqs
    assert 0 < ts.accepted < ts.proposed
