"""The compile-once contract of the port's decode sessions, on the CPU.

On the card a session captures each of its steps once as a CUDA graph and
replays it (``repro_torch.core.capture``); a graph keeps the addresses it
was captured on, so every step must read and write only tensors that stay
put. Here the same steps run eagerly and the tests hold that contract:

- across rounds and admissions (one into a non-zero slot, one into a
  retired slot) ``data_ptr()`` stays the same for every state leaf (pos,
  last_token, every dense / paged cache tensor, the SSM conv and state),
  every lifecycle buffer and every static input of the round and insert
  steps — fused dense, paged, tree, split ssm ← ssm and hybrid ← ssm,
  greedy and sampled, while γ and b change every round;
- :class:`CapturedStep`'s launch bookkeeping, with a stand-in graph:
  warm-up counts its launches, capture adds nothing, every replay adds the
  launches the capture recorded;
- a CPU session never captures, and asking it to raises.

Tokens of these sessions against the JAX reference are held by the other
``tests/test_torch_*.py`` files (same steps, same CPU path); captured
against eager tokens on the card by ``chip_smoke.py``'s ``capture`` phase.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs.base import ModelConfig
from repro_torch.core.capture import CapturedStep, GraphCounts
from repro_torch.core.engine import SpecDecodeEngine
from repro_torch.core.session import DecodeSession
from repro_torch.core.window import WindowDecision
from repro_torch.models.kvcache import HybridCacheT

GMAX = 4
DENSE = dict(arch_type="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, d_ff=128, vocab=128, head_dim=16, dtype="float32",
             remat=False)
SSM = dict(arch_type="ssm", n_layers=2, d_model=64, n_heads=0, n_kv_heads=0,
           d_ff=0, vocab=128, ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
           dtype="float32", remat=False, tie_embeddings=True)
HYBRID = dict(arch_type="hybrid", n_layers=4, d_model=64, n_heads=4,
              n_kv_heads=4, d_ff=128, head_dim=16, vocab=128, ssm_state=16,
              ssm_head_dim=16, ssm_chunk=8, attn_every=2, dtype="float32",
              remat=False)
# (draft, target, session options)
PAIRS = {
    "fused": (dict(DENSE, qkv_bias=True), dict(DENSE, qk_norm=True), {}),
    "paged": (dict(DENSE, qkv_bias=True), dict(DENSE, qk_norm=True),
              dict(paged=True, kv_block_size=4)),
    "tree": (DENSE, DENSE, dict(max_branches=3)),
    "split_ssm": (SSM, SSM, {}),
    "split_hybrid": (SSM, HYBRID, {}),
}
CASES = [(k, 0.0) for k in PAIRS] + [(k, 0.7) for k in PAIRS if k != "tree"]


class _CyclePolicy:
    """γ and b change every round; every fifth round is fused."""

    def __init__(self):
        self.i = 0

    def decide(self, pair_key, feats):
        self.i += 1
        if self.i % 5 == 0:
            return WindowDecision(1, "fused")
        return WindowDecision(1 + self.i % GMAX, "distributed",
                              branches=1 + self.i % 3)

    def gamma_bound(self):
        return GMAX


def _tensors(obj, prefix):
    """Every tensor leaf of a cache (dataclass) by dotted name."""
    if isinstance(obj, torch.Tensor):
        return {prefix: obj}
    if not dataclasses.is_dataclass(obj):
        return {}
    out = {}
    for f in dataclasses.fields(obj):
        out.update(_tensors(getattr(obj, f.name), f"{prefix}.{f.name}"))
    return out


def _addresses(sess) -> dict:
    st = sess._state
    leaves = {"pos": st.pos, "last_token": st.last_token,
              **_tensors(st.draft_cache, "draft"),
              **_tensors(st.target_cache, "target")}
    for name in ("_out_buf", "_cursor", "_max_new", "_done", "_nacc", "_nn",
                 "_tree_counters", "_eos"):
        if getattr(sess, name) is not None:
            leaves[name] = getattr(sess, name)
    for step_name, step in (("round", sess._round), ("insert", sess._insert)):
        for k, v in step.inputs.items():
            leaves[f"{step_name}.{k}"] = v
    return {k: v.data_ptr() for k, v in leaves.items()}


def _retire_finished(sess, produced: dict) -> None:
    for j in sess.finished_slots():
        tokens, rec = sess.retire(j)
        produced[rec.request_id] = (len(tokens), rec.max_new)


@pytest.mark.parametrize("kind,temp", CASES)
def test_steps_write_in_place(kind, temp):
    """Rounds (γ, b changing every round) and admissions into slots 0, 1
    and a retired slot leave every state leaf, lifecycle buffer and static
    step input at its address; the rounds did commit tokens."""
    d_kw, t_kw, opts = PAIRS[kind]
    eng = SpecDecodeEngine(ModelConfig(name="d", **d_kw),
                           ModelConfig(name="t", **t_kw), seed=0,
                           temperature=temp, device="cpu")
    sess = DecodeSession(eng, capacity=3, max_new_cap=8, max_prompt_len=12,
                         gamma_max=GMAX, sync_every=2, seed=5, **opts)
    assert sess.capture is False
    rng = np.random.default_rng(0)
    prompt = lambda: rng.integers(0, 128, int(rng.integers(3, 12)))
    policy = _CyclePolicy()
    assert sess.admit(prompt(), 8, request_id=0) == 0
    sess.run_chunk(policy)
    addrs = _addresses(sess)
    assert sess.admit(prompt(), 5, request_id=1) == 1
    assert _addresses(sess) == addrs
    produced = {}
    for _ in range(12):
        sess.run_chunk(policy)
        assert _addresses(sess) == addrs
        _retire_finished(sess, produced)
        if produced and 2 not in produced and sess.free:
            sess.admit(prompt(), 6, request_id=2)       # a retired slot
            produced[2] = None
            assert _addresses(sess) == addrs
        if not sess.occupied:
            break
    # every request ran to its budget through the in-place rounds
    assert produced == {0: (8, 8), 1: (5, 5), 2: (6, 6)}
    assert int(sess._row_in) == sess.sync_every - 1   # the chunk's last row
    # a CPU session ran every step eagerly: nothing was captured
    assert eng.graphs == GraphCounts()
    assert sess._round.graph is None and sess._insert.graph is None


def test_cpu_session_refuses_capture():
    eng = SpecDecodeEngine(ModelConfig(name="d", **DENSE),
                           ModelConfig(name="t", **DENSE), device="cpu")
    with pytest.raises(ValueError, match="capture runs on the card"):
        DecodeSession(eng, capacity=1, max_new_cap=4, capture=True)
    assert DecodeSession(eng, capacity=1, max_new_cap=4,
                         capture=False).capture is False


class _StandInGraph:
    """Records what a CUDA graph would be asked to do."""

    def __init__(self):
        self.replays = 0
        self.generators = []

    def replay(self):
        self.replays += 1

    def register_generator_state(self, generator):
        self.generators.append(generator)


class _StandInStep(CapturedStep):
    """A CapturedStep whose graph API is the stand-in: the warm-up runs on
    the current (CPU) stream and the 'capture' runs the body eagerly, as
    tracing it would, while replays run nothing."""

    def _new_graph(self):
        return _StandInGraph()

    def _capturing(self, graph):
        return contextlib.nullcontext()

    def _on_side_stream(self):
        return contextlib.nullcontext()


def test_captured_step_launch_bookkeeping():
    """Warm-up: a real run, its launches counted. Capture: the body's
    launches are taken back (nothing ran) and recorded; the replay that
    follows and every later one add them again. Inputs are copied in before
    each call; the generator is registered with the graph."""
    counts = GraphCounts()
    ran = []

    def body():
        ran.append(float(inputs["x"]))
        kernels.count_launch("decode_attn")
        kernels.count_launch("decode_attn")
        kernels.count_launch("ssd_scan")

    inputs = {"x": torch.zeros(())}
    gen = torch.Generator()
    step = _StandInStep(body, inputs, counts, capture=True, generator=gen)
    per_call = {"decode_attn": 2, "ssd_scan": 1}
    start = dict(kernels.LAUNCHES)
    delta = lambda: {k: kernels.LAUNCHES[k] - start[k]
                     for k in kernels.LAUNCHES
                     if kernels.LAUNCHES[k] != start[k]}

    assert not step.captures_next
    step(x=torch.tensor(1.0))                      # warm-up
    assert ran == [1.0] and delta() == per_call
    assert (counts.warm_ups, counts.captured, counts.replays) == (1, 0, 0)
    assert step.captures_next

    step(x=torch.tensor(2.0))                      # capture, then replay
    assert ran == [1.0, 2.0]                       # the stand-in traced it
    assert step.launches == per_call
    assert delta() == {k: 2 * n for k, n in per_call.items()}
    assert (counts.captured, counts.replays) == (1, 1)
    assert step.graph.replays == 1 and step.graph.generators == [gen]
    assert not step.captures_next

    for i in range(3):                             # replays only
        step(x=torch.tensor(3.0 + i))
    assert ran == [1.0, 2.0] and float(inputs["x"]) == 5.0
    assert delta() == {k: 5 * n for k, n in per_call.items()}
    assert (counts.warm_ups, counts.captured, counts.replays) == (1, 1, 4)
    assert step.graph.replays == 4
    for k, n in start.items():
        kernels.LAUNCHES[k] = n


def test_eager_step_runs_every_call():
    counts = GraphCounts()
    calls = []
    step = CapturedStep(lambda: calls.append(1), {}, counts, capture=False)
    for _ in range(4):
        assert not step.captures_next
        step()
    assert len(calls) == 4 and counts == GraphCounts()
    assert step.graph is None


def test_split_advance_writes_session_state_in_place():
    """The split step's re-advance lands in the session's own conv/state
    tensors (hybrid ← ssm): after a round they hold new values at the old
    addresses."""
    eng = SpecDecodeEngine(ModelConfig(name="d", **SSM),
                           ModelConfig(name="t", **HYBRID), seed=0,
                           device="cpu")
    sess = DecodeSession(eng, capacity=2, max_new_cap=8, max_prompt_len=8,
                         gamma_max=GMAX, sync_every=1)
    sess.admit(np.arange(1, 7), 8)
    tc = sess._state.target_cache
    assert isinstance(tc, HybridCacheT)
    before = {n: (t.data_ptr(), t.clone()) for n, t in
              (("t.state", tc.ssm.state), ("d.state",
                                           sess._state.draft_cache.state))}
    sess.run_chunk(_CyclePolicy())
    for n, t in (("t.state", tc.ssm.state),
                 ("d.state", sess._state.draft_cache.state)):
        ptr, old = before[n]
        assert t.data_ptr() == ptr
        assert not torch.equal(t[:, 0], old[:, 0]), n
        torch.testing.assert_close(t[:, 1], old[:, 1], rtol=0, atol=0)
