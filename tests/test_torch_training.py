"""The port's training path held against the JAX reference on the same
numpy inputs and bridged weights: AdamW, the cosine schedule and the global
norm; the cross-entropy loss; ``forward_train`` of all six families (logits,
aux, and every leaf's gradient against ``jax.grad`` of the reference's
loss, remat on and off); ``attention_train``'s query chunks; the Mamba2
block with padding and ``seq_lens``; kernel B5's backward in its plain
forms against ``jax.vjp`` of the reference's chunked scan; three AdamW
train steps with and without gradient accumulation; the synthetic data
pipeline; checkpoints across the two packages; ``launch.train`` and the
torch ``train_draft`` example on the CPU.

Configs: tiny families at d_model 64, 2 layers (the hybrid 3: a segment
of 2 Mamba2 layers, the shared block, a trailing layer), vocab 128,
float32. Tolerances: logits, aux and losses
atol/rtol 1e-4 (float32, sum order only); a gradient leaf within
1e-4·(max|g| + |g|) of the reference's (the same, scaled to the leaf);
the scan's gradients the scan's own 5e-4 / 1e-3; parameters after three
steps 1e-3 of the update's norm (AdamW moves an element ±lr whatever its
gradient's size, so an element whose gradient sits at rounding level may
move the other way). Batches, checkpoints and ``SyntheticLM`` tokens compare
exactly. CUDA ``ssd_scan_bwd`` is held to these plain forms on the card by
``chip_smoke.py`` (phase ``train``)."""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JCfg
from repro.models import attention as jattn
from repro.models import ssm as jssm
from repro.models.model import Model as JModel
from repro.training import (AdamWConfig as JAdamW, DataConfig as JData,
                            SyntheticLM as JSynthetic, adamw_init as j_init,
                            adamw_update as j_update,
                            checkpoint as j_ckpt,
                            cosine_schedule as j_cosine,
                            cross_entropy as j_ce, global_norm as j_norm,
                            make_loss_fn as j_loss_fn,
                            make_train_step as j_train_step)
from repro.training.train_step import TrainState as JState
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import ModelConfig as TCfg
from repro_torch.kernels.ssd import (ssd_chunked_bwd_plain,
                                     ssd_chunked_kernel,
                                     ssd_chunked_plain_bwd,
                                     ssd_reverse_recurrence_bwd)
from repro_torch.launch import train as t_launch
from repro_torch.models import attention as tattn
from repro_torch.models import ssm as tssm
from repro_torch.models.model import Model as TModel
from repro_torch.training import (AdamWConfig, DataConfig, SyntheticLM,
                                  adamw_init, adamw_update, checkpoint,
                                  cosine_schedule, cross_entropy,
                                  global_norm, init_train_state,
                                  make_loss_fn, make_train_step)
from repro_torch.training.optimizer import tree_leaves, tree_map
from repro_torch.training.train_step import trainable

TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_SHARE = 1e-4
SCAN_TOL = dict(atol=5e-4, rtol=1e-3)
UPDATE_RTOL = 1e-3
ROOT = Path(__file__).resolve().parents[1]

_BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             d_ff=128, vocab=128, dtype="float32", remat=False)
FAMILIES = {
    "dense": dict(_BASE, name="td", arch_type="dense", qkv_bias=True,
                  qk_norm=True),
    "moe": dict(_BASE, name="tm", arch_type="moe", n_experts=4,
                experts_per_tok=2, moe_dense_residual=True),
    "vlm": dict(_BASE, name="tv", arch_type="vlm", n_frontend_tokens=4),
    "encdec": dict(_BASE, name="te", arch_type="encdec", encoder_layers=2,
                   n_frontend_tokens=8, cross_attention=True),
    "ssm": dict(_BASE, name="ts", arch_type="ssm", n_heads=0, n_kv_heads=0,
                head_dim=0, d_ff=0, ssm_state=16, ssm_head_dim=16,
                ssm_chunk=8, tie_embeddings=True),
    "hybrid": dict(_BASE, name="th", arch_type="hybrid", n_layers=3,
                   n_kv_heads=4, ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
                   attn_every=2),
}
B, S = 2, 16


def _np_params(jcfg, seed=0):
    """Reference init with the zero-init norms and biases moved off zero
    (their gradients and code paths count), as numpy leaves."""
    p = jax.device_get(JModel(jcfg).init_params(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def walk(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v)
            elif k in ("ln1", "ln2", "ln_x", "final_norm", "enc_norm",
                       "norm", "conv_b", "bq", "bk", "bv", "q_norm",
                       "k_norm"):
                tree[k] = (v + 0.1 * rng.normal(size=v.shape)).astype(v.dtype)
    walk(p)
    return p


def _batch(cfg, seed=0, batch=B, seq=S):
    """tokens, labels (a few −100) and the family's frontend, as numpy."""
    rng = np.random.default_rng(seed)
    tok = rng.integers(0, cfg.vocab, (batch, seq + 1)).astype(np.int32)
    out = {"tokens": tok[:, :-1], "labels": tok[:, 1:].copy()}
    out["labels"][0, :3] = -100
    if cfg.arch_type in ("vlm", "encdec"):
        out["frontend"] = rng.normal(
            size=(batch, cfg.n_frontend_tokens, cfg.d_model)
        ).astype(np.float32)
    return out


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _flat(tree, prefix=""):
    """{dotted path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _grad_close(got, want, share=GRAD_SHARE, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(want).all(), f"{name}: reference gradient not finite"
    lim = share * (np.abs(want).max() + np.abs(want))
    err = np.abs(got - want)
    assert (err <= lim).all(), (name, float(err.max()),
                                float(np.abs(want).max()))


# ------------------------------------------------------------- optimizer

def _opt_trees(seed):
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(4, 3)).astype(np.float32),
              "b": {"c": rng.normal(size=(5,)).astype(np.float32)}}
    grads = [{"w": (s * rng.normal(size=(4, 3))).astype(np.float32),
              "b": {"c": (s * rng.normal(size=(5,))).astype(np.float32)}}
             for s in (3.0, 0.5, 10.0)]
    return params, grads


OPT_CASES = {
    "clip": (dict(lr=1e-2, grad_clip=1.0), {}),
    "no_clip": (dict(lr=1e-2, grad_clip=0.0, weight_decay=0.1), {}),
    "schedule": (dict(grad_clip=1.0), dict(schedule=(1e-2, 2, 5))),
    "bf16_state": (dict(lr=1e-2), dict(state="bf16")),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_adamw_update_matches_reference(case):
    """Three AdamW steps on the same arrays: parameters and both moments
    (bf16 moments compared after the same rounding)."""
    kw, extra = OPT_CASES[case]
    jkw, tkw = dict(kw), dict(kw)
    if "schedule" in extra:
        base, warm, total = extra["schedule"]
        jkw["schedule"] = j_cosine(base, warm, total)
        tkw["schedule"] = cosine_schedule(base, warm, total)
    if extra.get("state") == "bf16":
        jkw["state_dtype"], tkw["state_dtype"] = jnp.bfloat16, torch.bfloat16
    jcfg, tcfg = JAdamW(**jkw), AdamWConfig(**tkw)
    params, grads = _opt_trees(7)
    jp = jax.tree.map(jnp.asarray, params)
    tp = tree_map(lambda a: torch.from_numpy(a.copy()), params)
    js, ts = j_init(jp, jcfg), adamw_init(tp, tcfg)
    for g in grads:
        jp, js = j_update(jax.tree.map(jnp.asarray, g), js, jp, jcfg)
        tp, ts = adamw_update(tree_map(torch.from_numpy, g), ts, tp, tcfg)
    assert int(ts.step) == int(js.step) == 3
    for jt_, tt_ in ((jp, tp), (js.mu, ts.mu), (js.nu, ts.nu)):
        for a, b in zip(jax.tree.leaves(jt_), tree_leaves(tt_)):
            np.testing.assert_allclose(b.float().numpy(),
                                       np.asarray(a, np.float32),
                                       rtol=1e-5, atol=1e-7)
            assert str(b.dtype)[6:] == str(a.dtype)


def test_global_norm_and_cosine_schedule_match_reference():
    params, grads = _opt_trees(3)
    for g in grads:
        np.testing.assert_allclose(
            float(global_norm(tree_map(torch.from_numpy, g))),
            float(j_norm(jax.tree.map(jnp.asarray, g))), rtol=1e-6)
    jf, tf = j_cosine(3e-3, 20, 200), cosine_schedule(3e-3, 20, 200)
    for step in (0, 1, 7, 20, 21, 100, 199, 200, 250):
        np.testing.assert_allclose(
            float(tf(torch.tensor(step, dtype=torch.int32))),
            float(jf(jnp.asarray(step, jnp.int32))), rtol=1e-6, atol=1e-12)


def test_cross_entropy_matches_reference():
    """−100 labels and a mask both drop positions; the mean is over the
    rest."""
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(3, 7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (3, 7)).astype(np.int32)
    labels[0, :4] = -100
    mask = (rng.random((3, 7)) > 0.3).astype(np.int32)
    for m in (None, mask):
        want = j_ce(jnp.asarray(logits), jnp.asarray(labels),
                    None if m is None else jnp.asarray(m))
        got = cross_entropy(torch.from_numpy(logits),
                            torch.from_numpy(labels),
                            None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), **TOL)
    all_masked = np.full((3, 7), -100, np.int32)
    assert float(cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(all_masked))) == 0.0


# --------------------------------------------------------- forward_train

@pytest.fixture(scope="module")
def reference_runs():
    """Per family: (reference config, numpy weights, batch, reference
    logits, aux, loss and gradient leaves), each family's jitted reference
    compiled once."""
    out = {}

    def get(fam):
        if fam not in out:
            jcfg = JCfg(**FAMILIES[fam])
            p = _np_params(jcfg)
            batch = _batch(jcfg)
            model = JModel(jcfg)
            loss_fn = j_loss_fn(model)

            def run(params, batch):      # one compile: forward and grad
                (loss, _), grads = jax.value_and_grad(
                    loss_fn, has_aux=True)(params, batch)
                return model.forward_train(params, batch), loss, grads

            (logits, aux), loss, grads = jax.jit(run)(
                jax.tree.map(jnp.asarray, p), _j(batch))
            out[fam] = (jcfg, p, batch, np.asarray(logits), float(aux),
                        float(loss), jax.device_get(grads))
        return out[fam]
    return get


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_forward_train_matches_reference(family, reference_runs):
    jcfg, p, batch, logits, aux, _, _ = reference_runs(family)
    model = TModel(TCfg(**FAMILIES[family]), "cpu")
    with torch.no_grad():
        got, got_aux = model.forward_train(params_from_numpy(p, "cpu"),
                                           _t(batch))
    assert got.dtype == torch.float32 and got.shape == (B, S, jcfg.vocab)
    np.testing.assert_allclose(got.numpy(), logits, **TOL)
    np.testing.assert_allclose(float(got_aux), aux, **TOL)
    if family == "moe":
        assert aux > 0


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_gradients_match_reference(family, remat, reference_runs):
    """Every leaf's gradient of the loss (ce + 0.01·aux) against
    ``jax.grad`` of the reference's ``make_loss_fn``; remat re-runs each
    layer's forward in the backward pass and changes no number."""
    jcfg, p, batch, _, _, loss, grads = reference_runs(family)
    model = TModel(dataclasses.replace(TCfg(**FAMILIES[family]),
                                       remat=remat), "cpu")
    tp = trainable(params_from_numpy(p, "cpu"))
    got_loss, _ = make_loss_fn(model)(tp, _t(batch))
    np.testing.assert_allclose(float(got_loss.detach()), loss, **TOL)
    leaves = tree_leaves(tp)
    g = torch.autograd.grad(got_loss, leaves, allow_unused=True,
                            materialize_grads=True)
    want = _flat(grads)
    got = dict(zip(sorted(want), (None,) * len(want)))
    flat_t = _flat(tp)
    assert sorted(flat_t) == sorted(want)
    by_id = {id(t): gi for t, gi in zip(leaves, g)}
    for name in want:
        got[name] = by_id[id(flat_t[name])].numpy()
        _grad_close(got[name], want[name], name=f"{family}:{name}")
    assert any(np.abs(v).max() > 0 for k, v in got.items()
               if ".ssm." in f".{k}" or k.startswith("layers.attn"))


def test_attention_train_query_chunks_match_reference():
    """T = 3·q_chunk: the chunked path (queries in chunks against the whole
    masked K), with a sliding window and with a bidirectional prefix, is
    the reference's and the unchunked port's."""
    cfg = dict(FAMILIES["dense"], sliding_window=5)
    jcfg, tcfg = JCfg(**cfg), TCfg(**cfg)
    p = _np_params(jcfg)
    lp = jax.tree.map(lambda a: a[0], p["layers"]["attn"])
    x = np.random.default_rng(9).normal(size=(2, 24, 64)).astype(np.float32)
    tp = params_from_numpy(lp, "cpu")
    for kw in (dict(), dict(window=0), dict(window=0, prefix_len=10)):
        want = jattn.attention_train(jnp.asarray(x), jax.tree.map(
            jnp.asarray, lp), jcfg, q_chunk=8, **kw)
        got = tattn.attention_train(torch.from_numpy(x), tp, tcfg,
                                    q_chunk=8, **kw)
        whole = tattn.attention_train(torch.from_numpy(x), tp, tcfg,
                                      q_chunk=64, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(whole.numpy(), got.numpy(), **TOL)


def test_ssm_block_train_with_padding_and_seq_lens_matches_reference():
    """The Mamba2 block over a right-padded batch (S 13, no multiple of the
    chunk 8; lengths 13 and 6): output, state and the gradients of x and of
    every weight against ``jax.grad`` of the reference's block (its jnp
    chunked path)."""
    jcfg = JCfg(**FAMILIES["ssm"])
    tcfg = TCfg(**FAMILIES["ssm"])
    p = jax.tree.map(lambda a: a[0], _np_params(jcfg)["layers"]["ssm"])
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 13, 64)).astype(np.float32)
    lens = np.array([13, 6], np.int32)
    w = rng.normal(size=(2, 13, 64)).astype(np.float32)

    def jloss(p, x):
        y, st = jssm.ssm_block_train(x, p, jcfg, seq_lens=jnp.asarray(lens))
        return jnp.sum(y * w) + jnp.sum(st.h) + jnp.sum(st.conv_tail), (y, st)

    (jl, (jy, jst)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jax.tree.map(jnp.asarray, p),
                                              jnp.asarray(x))
    tp = trainable(params_from_numpy(p, "cpu"))
    tx = torch.from_numpy(x).requires_grad_(True)
    y, st = tssm.ssm_block_train(tx, tp, tcfg,
                                 seq_lens=torch.from_numpy(lens))
    tl = (y * torch.from_numpy(w)).sum() + st.h.sum() + st.conv_tail.sum()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(st.h.detach().numpy(), np.asarray(jst.h),
                               **TOL)
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    names = sorted(tp)
    g = torch.autograd.grad(tl, [tx] + [tp[k] for k in names])
    _grad_close(g[0].numpy(), np.asarray(jgx), name="x")
    for k, gk in zip(names, g[1:]):
        _grad_close(gk.numpy(), np.asarray(jgp[k]), name=k)


# ----------------------------------------------------- B5's backward, plain

def _scan_inputs(B_, S_, nh, hd, N, seed, dt_scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B_, S_, nh, hd)).astype(np.float32)
    Bm = (0.5 * rng.normal(size=(B_, S_, N))).astype(np.float32)
    Cm = (0.5 * rng.normal(size=(B_, S_, N))).astype(np.float32)
    dt = (dt_scale * np.log1p(np.exp(rng.normal(size=(B_, S_, nh))))
          ).astype(np.float32)
    A = (-np.exp(rng.normal(size=(nh,)))).astype(np.float32)
    h0 = rng.normal(size=(B_, nh, hd, N)).astype(np.float32)
    dy = rng.normal(size=(B_, S_, nh, hd)).astype(np.float32)
    dh = rng.normal(size=(B_, nh, hd, N)).astype(np.float32)
    return (x, Bm, Cm, dt, A, h0), dy, dh


@pytest.mark.parametrize("shape", [(2, 32, 3, 16, 16, 8),
                                   (1, 48, 2, 32, 16, 16),
                                   (2, 16, 4, 16, 32, 16)])
def test_ssd_backward_plain_forms_match_reference_vjp(shape):
    """The plain backward (autograd of the chunked plain scan, any chunk)
    and the token-by-token reverse recurrence (its checkpoints at 8 and 5
    steps) against ``jax.vjp`` of the reference's ``ssd_chunked`` on the
    same (dy, dh_out), nonzero h_in."""
    B_, S_, nh, hd, N, chunk = shape
    ins, dy, dh = _scan_inputs(B_, S_, nh, hd, N, seed=sum(shape),
                               dt_scale=0.3)
    _, vjp = jax.vjp(lambda *a: jssm.ssd_chunked(*a, chunk),
                     *map(jnp.asarray, ins))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    t_ins = [torch.from_numpy(a) for a in ins]
    forms = [ssd_chunked_plain_bwd(*t_ins, torch.from_numpy(dy),
                                   torch.from_numpy(dh), c)
             for c in (chunk, 64)]
    forms += [ssd_reverse_recurrence_bwd(*t_ins, torch.from_numpy(dy),
                                         torch.from_numpy(dh), interval=k)
              for k in (8, 5)]
    for got in forms:
        for g, w_ in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w_),
                                       **SCAN_TOL)


def test_plain_scan_gradient_stays_finite_where_reference_overflows():
    """Large A·dt within a chunk overflows exp(seg) in the masked upper
    triangle: the reference's where(mask, exp(seg), 0) then has 0·inf =
    NaN in its gradient (a deliberate difference). The port masks before
    the exp: the same forward, a finite gradient equal to the recurrence's
    (and so to ``ssd_scan_bwd``'s)."""
    ins, dy, dh = _scan_inputs(1, 32, 2, 16, 16, seed=3, dt_scale=8.0)
    _, vjp = jax.vjp(lambda *a: jssm.ssd_chunked(*a, 32),
                     *map(jnp.asarray, ins))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    assert np.isnan(np.asarray(want[3])).any()
    t_ins = [torch.from_numpy(a) for a in ins]
    got = ssd_chunked_plain_bwd(*t_ins, torch.from_numpy(dy),
                                torch.from_numpy(dh), 32)
    ref = ssd_reverse_recurrence_bwd(*t_ins, torch.from_numpy(dy),
                                     torch.from_numpy(dh))
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), r.numpy(), **SCAN_TOL)
    y, h = ssd_chunked_kernel(*t_ins, 32)
    jy, jh = jssm.ssd_chunked(*map(jnp.asarray, ins), 32)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SCAN_TOL)


@pytest.mark.parametrize("S_", [1, 63, 64, 65, 130])
def test_ssd_chunked_bwd_plain_matches_reference_vjp(S_):
    """``ssd_scan_bwd``'s algorithm as einsums (B5's 64-token chunks in
    reverse, da as a sum over a rectangle) against ``jax.vjp`` of the
    reference's ``ssd_chunked`` at chunk 64, nonzero h_in and dh_out. The
    reference takes whole chunks: its inputs are padded with zero rows
    (dt 0: identity steps, dy 0), and its gradients cut at S."""
    ins, dy, dh = _scan_inputs(2, S_, 2, 16, 16, seed=S_, dt_scale=0.3)
    pad = (-S_) % 64

    def padded(a):
        return np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
    j_ins = [padded(a) for a in ins[:4]] + list(ins[4:])
    _, vjp = jax.vjp(lambda *a: jssm.ssd_chunked(*a, 64),
                     *map(jnp.asarray, j_ins))
    want = vjp((jnp.asarray(padded(dy)), jnp.asarray(dh)))
    got = ssd_chunked_bwd_plain(*map(torch.from_numpy, ins),
                                torch.from_numpy(dy), torch.from_numpy(dh))
    for name, g, w_, a in zip(("dx", "dBm", "dCm", "ddt", "dA", "dh_in"),
                              got, want, ins):
        w_ = np.asarray(w_)
        if w_.shape != a.shape:
            w_ = w_[:, :S_]
        assert g.shape == a.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), w_, **SCAN_TOL, err_msg=name)


def test_ssd_chunked_bwd_plain_empty_sequence():
    """S = 0: dh_in = dh_out, dA zero, the per-token gradients empty."""
    ins, dy, dh = _scan_inputs(2, 0, 2, 16, 16, seed=0)
    got = ssd_chunked_bwd_plain(*map(torch.from_numpy, ins),
                                torch.from_numpy(dy), torch.from_numpy(dh))
    for g, a in zip(got[:4], ins):
        assert tuple(g.shape) == a.shape and g.numel() == 0
    assert torch.equal(got[4], torch.zeros(2))
    assert torch.equal(got[5], torch.from_numpy(dh))


def test_ssd_chunked_bwd_plain_stays_finite_where_reference_overflows():
    """The overflow case of the plain scan's test (Σ A·dt inside a chunk
    far above 88): every gradient of the chunked reverse form is finite and
    equals the token-by-token recurrence's."""
    ins, dy, dh = _scan_inputs(1, 32, 2, 16, 16, seed=3, dt_scale=8.0)
    t_ins = [torch.from_numpy(a) for a in ins]
    got = ssd_chunked_bwd_plain(*t_ins, torch.from_numpy(dy),
                                torch.from_numpy(dh))
    ref = ssd_reverse_recurrence_bwd(*t_ins, torch.from_numpy(dy),
                                     torch.from_numpy(dh))
    for g, r in zip(got, ref):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), r.numpy(), **SCAN_TOL)


# ------------------------------------------------------------ train step

@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_matches_reference(micro):
    """Three AdamW steps (clip, cosine schedule) of the dense family, with
    gradient accumulation over ``micro`` micro-batches: losses, ce and aux
    per step, and the parameters after (the update p − p0 within
    UPDATE_RTOL of its norm). The moe family's aux term is held by the
    forward and gradient tests."""
    jcfg, tcfg = JCfg(**FAMILIES["dense"]), TCfg(**FAMILIES["dense"])
    p = _np_params(jcfg, seed=4)
    jopt = JAdamW(lr=1e-3, schedule=j_cosine(1e-3, 2, 3))
    topt = AdamWConfig(lr=1e-3, schedule=cosine_schedule(1e-3, 2, 3))
    jp = jax.tree.map(jnp.asarray, p)
    jstate = JState(params=jp, opt=j_init(jp, jopt),
                    step=jnp.zeros((), jnp.int32))
    jstep = jax.jit(j_train_step(JModel(jcfg), jopt, micro_steps=micro))
    model = TModel(tcfg, "cpu")
    tstate = init_train_state(model, 0, topt,
                              params=params_from_numpy(p, "cpu"))
    tstep = make_train_step(model, topt, micro_steps=micro)
    for i in range(3):
        batch = _batch(jcfg, seed=10 + i, batch=4)
        jstate, jm = jstep(jstate, _j(batch), jax.random.PRNGKey(i))
        tstate, tm = tstep(tstate, _t(batch))
        for k in ("loss", "ce", "aux"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL)
        assert tm["step"] == int(jm["step"]) == i + 1
    num = den = 0.0
    for a, b, c in zip(tree_leaves(tstate.params),
                       jax.tree.leaves(jstate.params), jax.tree.leaves(p)):
        a, b = a.detach().double().numpy(), np.asarray(b, np.float64)
        num += float(((a - b) ** 2).sum())
        den += float(((b - c) ** 2).sum())
    assert np.sqrt(num / den) <= UPDATE_RTOL, np.sqrt(num / den)


# ------------------------------------------------------------------ data

@pytest.mark.parametrize("kw", [dict(vocab=128, seq_len=40, batch=3),
                                dict(vocab=50280, seq_len=64, batch=2,
                                     seed=5),
                                dict(vocab=300, seq_len=24, batch=2,
                                     frontend_tokens=6, frontend_dim=8,
                                     copy_prob=0.4)])
def test_synthetic_lm_batches_byte_equal(kw):
    """Three batches of the port's pipeline equal the reference's byte for
    byte (same dtypes), the per-state CDF cache included."""
    ti, ji = SyntheticLM(DataConfig(**kw)).batches(), \
        JSynthetic(JData(**kw)).batches()
    for _ in range(3):
        a, b = next(ti), next(ji)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes()


# ----------------------------------------------------------- checkpoints

def test_checkpoints_cross_packages(tmp_path):
    """Each package restores the other's ``.npz`` (the reference's
    ``|``-joined keys, shape-checked), float32 both ways; a bfloat16 tree
    the port writes has the reference's bytes, and the port restores the
    reference's bfloat16 file (the reference's own ``restore`` cannot cast
    numpy's raw 2-byte elements to bfloat16, its file or the port's)."""
    jcfg = JCfg(**FAMILIES["hybrid"])
    p = _np_params(jcfg)
    jp = jax.tree.map(jnp.asarray, p)
    tp = params_from_numpy(p, "cpu")
    j_ckpt.save(jp, str(tmp_path / "ref.npz"))
    checkpoint.save(tp, str(tmp_path / "port.npz"))
    zeros_t = tree_map(torch.zeros_like, tp)
    got = checkpoint.restore(zeros_t, str(tmp_path / "ref.npz"))
    back = j_ckpt.restore(jax.tree.map(jnp.zeros_like, jp),
                          str(tmp_path / "port.npz"))
    for a, b in zip(tree_leaves(got), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    zr, zp = np.load(tmp_path / "ref.npz"), np.load(tmp_path / "port.npz")
    assert sorted(zr.files) == sorted(zp.files)
    bf = {"a": jnp.asarray(p["embed"], jnp.bfloat16),
          "b": {"c": jnp.asarray(p["final_norm"])}}
    j_ckpt.save(bf, str(tmp_path / "ref16.npz"))
    tbf = {"a": torch.from_numpy(np.array(p["embed"])).bfloat16(),
           "b": {"c": torch.from_numpy(np.array(p["final_norm"]))}}
    checkpoint.save(tbf, str(tmp_path / "port16.npz"))
    zr, zp = np.load(tmp_path / "ref16.npz"), np.load(tmp_path / "port16.npz")
    for k in zr.files:
        assert zr[k].dtype == zp[k].dtype and \
            zr[k].tobytes() == zp[k].tobytes()
    got = checkpoint.restore(tree_map(torch.zeros_like, tbf),
                             str(tmp_path / "ref16.npz"))
    assert got["a"].dtype == torch.bfloat16
    assert torch.equal(got["a"], tbf["a"])
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore({"a": torch.zeros(3), "b": {"c": torch.zeros(
            tbf["b"]["c"].shape)}}, str(tmp_path / "port16.npz"))


def test_launch_train_cpu_saves_a_checkpoint(tmp_path, capsys):
    """``python -m repro_torch.launch.train --device cpu`` on a reduced
    config for 2 steps prints the reference's step lines and writes a
    checkpoint the model's parameters restore from (gradient accumulation
    over 2 micro-batches on)."""
    path = tmp_path / "ck.npz"
    argv = ["--arch", "mamba2-130m", "--steps", "2", "--batch", "2",
            "--seq", "16", "--device", "cpu", "--log-every", "1",
            "--micro-steps", "2", "--ckpt", str(path)]
    assert t_launch.main(argv) == 0
    out = capsys.readouterr().out
    assert "step     1  loss" in out and "step     2  loss" in out
    assert "saved" in out and path.exists()
    args = t_launch.parse_args(argv)
    cfg = t_launch.config_of(args)
    assert cfg.n_layers == 2 and cfg.dtype == "float32"
    model = TModel(cfg, "cpu")
    got = checkpoint.restore(model.init_params(5), str(path))
    assert all(torch.isfinite(t).all() for t in tree_leaves(got))


def test_launch_train_after_steps_runs_one_more_step():
    """``launch.train.run(after_steps=)`` hands the caller one more step
    after the timed ones (the smoke's profiler window): it trains on the
    next batch and leaves the summary's losses and times alone."""
    seen = []

    def after(one_step):
        seen.append(len(seen))
        one_step()
    argv = ["--arch", "mamba2-130m", "--steps", "2", "--batch", "2",
            "--seq", "16", "--device", "cpu"]
    s = t_launch.run(t_launch.parse_args(argv), after_steps=after)
    assert seen == [0] and len(s["losses"]) == 2


@pytest.mark.parametrize("shape,hg", [
    ((4, 1, 64), 2),      # zamba2 verify / prefill: 128 blocks of 2 heads
    ((4, 1, 24), 1),      # mamba2-130m verify: 96 blocks
    ((8, 16, 24), 8),     # mamba2-130m training: 384 blocks of 8 heads
    ((4, 16, 64), 8),     # zamba2-1.2b training: 512 blocks
    ((1, 0, 3), 1)])
def test_bwd_heads_per_block_fills_the_card(shape, hg):
    """``ssd_scan_bwd``'s heads per block: one wave of at least 128 blocks
    where a group of heads allows it, one chunk included."""
    from repro_torch.kernels.ssd.ssd import bwd_heads_per_block
    assert bwd_heads_per_block(*shape) == hg


def test_train_draft_example_train_lm_on_cpu():
    """The torch ``train_draft`` example's ``train_lm`` for 2 steps on the
    CPU: detached parameters and two finite losses; its draft has 64-wide
    heads."""
    spec = importlib.util.spec_from_file_location(
        "train_draft_torch", ROOT / "examples" / "train_draft_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    target, draft = mod.configs(128, 2)
    assert draft.head_dim == 64 and target.head_dim == 64
    data = DataConfig(vocab=target.vocab, seq_len=16, batch=2, seed=0)
    params, first, last = mod.train_lm(draft, 2, data, device="cpu")
    assert np.isfinite([first, last]).all()
    assert not any(t.requires_grad for t in tree_leaves(params))


NEW_MODULES = ("repro_torch.training", "repro_torch.training.optimizer",
               "repro_torch.training.train_step",
               "repro_torch.training.data",
               "repro_torch.training.checkpoint",
               "repro_torch.launch.train", "repro_torch.core.awc.train",
               "repro_torch.core.awc.dataset")


@pytest.mark.parametrize("module", NEW_MODULES)
def test_isolation_walk_covers_the_training_modules(module):
    """``tests/test_torch_isolation.py`` walks every ``*.py`` of the
    package (no ``jax``, no ``repro`` in a fresh interpreter, none
    imported in the source): the training modules are among them."""
    pkg = ROOT / "src" / "repro_torch"
    names = set()
    for path in pkg.rglob("*.py"):
        parts = list(path.relative_to(pkg.parent).with_suffix("").parts)
        names.add(".".join(parts[:-1] if parts[-1] == "__init__"
                           else parts))
    assert module in names


def test_train_draft_example_imports_neither_jax_nor_the_reference():
    import ast
    path = ROOT / "examples" / "train_draft_torch.py"
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [(node.module or "").split(".")[0]]
        else:
            continue
        assert not set(roots) & {"jax", "jaxlib", "repro"}, node.lineno


def test_ssd_wrappers_check_their_inputs():
    """The forward and backward wrappers raise on a tensor of the wrong
    type, shape or layout (the check they share), and on CPU tensors."""
    from repro_torch.kernels.ssd.ssd import _check_inputs, ssd_bwd_call
    (x, Bm, Cm, dt, A, h0), dy, dh = _scan_inputs(1, 8, 2, 16, 16, seed=0)
    t = [torch.from_numpy(a) for a in (x, Bm, Cm, dt, A, h0)]
    g = dict(dy=torch.from_numpy(dy), dh_out=torch.from_numpy(dh))
    _check_inputs(*t, **g)
    with pytest.raises(ValueError, match="dt must be"):
        _check_inputs(t[0], t[1], t[2], t[3].double(), *t[4:])
    with pytest.raises(ValueError, match="dh_out must be"):
        _check_inputs(*t, dy=g["dy"], dh_out=g["dh_out"][:, :1])
    with pytest.raises(ValueError, match="Bm must be contiguous"):
        _check_inputs(t[0], t[1].transpose(1, 2).contiguous().transpose(
            1, 2), *t[2:])
    with pytest.raises(ValueError, match="launches on cuda"):
        ssd_bwd_call(*t, **g)


def test_ssd_bwd_states_refuses_cpu_tensors():
    """The backward's state recompute, which passes its tensors' addresses
    to a launch, refuses CPU tensors as the wrappers do."""
    from repro_torch.kernels.ssd import ssd_bwd_states
    (x, Bm, Cm, dt, A, h0), _, _ = _scan_inputs(1, 130, 2, 16, 16, seed=0)
    t = [torch.from_numpy(a) for a in (x, Bm, Cm, dt, A, h0)]
    with pytest.raises(ValueError, match="launches on cuda"):
        ssd_bwd_states(*t)
