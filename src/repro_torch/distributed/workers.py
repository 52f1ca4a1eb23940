"""DraftWorker / TargetWorker — the engine's decode step split at the wire
(the port of the reference ``repro/distributed/workers.py``).

The colocated step (``core/engine.py``) runs one speculation round (draft
propose → target verify → commit) as one program. Distributed execution
splits it at exactly the points where bytes cross the network:

- :class:`DraftWorker` (edge) owns the draft model: ``propose`` (the
  γ_max-wide proposal loop), ``propose_tree`` (the (d_max, b_max) grid),
  ``ingest_tree`` (the winning path relocated onto the draft's linear
  slots), ``ingest`` (one committed token of a fused round), ``advance``
  (a recurrent draft re-advanced over the committed prefix), and the
  pipelined mode's ``checkpoint`` and ``rollback`` (a recurrent draft's
  optimistic advance and its undoing; ``advance`` with a state copy on
  either side, so no step key of their own, as the reference compiles no
  program for them).
- :class:`TargetWorker` (cloud) owns the target model: ``verify_commit``
  and ``verify_commit_tree``, the target half of the colocated linear and
  tree steps (:func:`~repro_torch.core.specdec.verify_proposal` and
  :meth:`SpecDecodeEngine._stop_and_advance`;
  :meth:`SpecDecodeEngine._tree_verdict`), then the commit into the
  session's output buffer and lifecycle flags, and the verdict.

Each method returns a program: a function that works IN PLACE over
tensors the caller owns (the session's state and buffers, or a test's),
as the engine's colocated steps do — so a session captures each program
once as a CUDA graph and replays it (``core/capture.py``). Every program
registers its step key in the engine's ``step_keys`` (``("dw_propose",
γ_max)``, ``("tw_verify", γ_max)``, …), the reference's ``_jit_cache``
entries, so ``engine.step_programs()`` counts them and stays flat over γ,
b and admission churn.

The draft side keeps its window in a :class:`DraftWindow` (the proposals,
their distributions at T > 0, and the window's start: anchor token and
position); the target writes its verdict into a :class:`VerdictBuffer`,
one flat int32 tensor, so the verdict leaves the device in one copy.
Through an in-process transport a round commits the colocated step's
tokens (the same functions in the same order, the generator's draws
included).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..core.engine import (_commit, _copy_recurrent_, _scan_cache_advance,
                           _tree_where)
from ..models.kvcache import HybridCacheT, SSMCache
from ..core.specdec import draft_propose, verify_proposal
from ..core.tree import tree_propose
from ..models.kvcache import tree_commit_cache
from .wire import VerdictMsg

_I32 = torch.int32


@dataclass
class DraftWindow:
    """The draft side's buffers of one window shape (fixed addresses).

    ``tokens``    (B, γ_max) proposals of a linear window, (B, T) grid of
                  a tree window (entry 0 the anchor),
    ``q_probs``   (B, γ_max, V) float32 draft distributions (T > 0), the
                  wire's device pass-through,
    ``anchor``    (B,) int32 token the window was proposed from,
    ``pos``       (B,) int32 its position,
    ``received``  (2B + B·d_max,) int32: the fields of the received verdict
                  the draft applies — n_accepted, num_new, then the
                  (B, d_max) winning path of a tree round (one host copy).
    """
    tokens: torch.Tensor
    anchor: torch.Tensor
    pos: torch.Tensor
    received: torch.Tensor
    q_probs: Optional[torch.Tensor] = None

    @classmethod
    def empty(cls, batch: int, width: int, device, d_max: int = 0,
              vocab: int = 0, sampled: bool = False) -> "DraftWindow":
        i32 = dict(dtype=_I32, device=device)
        return cls(tokens=torch.zeros((batch, width), **i32),
                   anchor=torch.zeros((batch,), **i32),
                   pos=torch.zeros((batch,), **i32),
                   received=torch.zeros((2 * batch + batch * d_max,), **i32),
                   q_probs=(torch.zeros((batch, width, vocab),
                                        dtype=torch.float32, device=device)
                            if sampled else None))

    @property
    def n_accepted(self) -> torch.Tensor:
        return self.received[:self.anchor.shape[0]]

    @property
    def num_new(self) -> torch.Tensor:
        B = self.anchor.shape[0]
        return self.received[B:2 * B]

    @property
    def path(self) -> torch.Tensor:
        B = self.anchor.shape[0]
        return self.received[2 * B:].view(B, -1)

    @staticmethod
    def pack_received(msg: VerdictMsg, out: np.ndarray) -> None:
        """Write a received verdict's draft-side fields into ``out`` (the
        host image of ``received``)."""
        B = msg.num_new.shape[0]
        out[:B] = msg.n_accepted
        out[B:2 * B] = msg.num_new
        if msg.path is not None:
            out[2 * B:] = np.asarray(msg.path, np.int32).reshape(-1)


def recurrent_clone(cache):
    """A checkpoint of a draft cache's recurrent leaves (ssm conv and
    state; a hybrid's shared attention cache is not copied: positions
    roll it back). :func:`~repro_torch.core.engine._copy_recurrent_` moves
    state between the two."""
    if isinstance(cache, HybridCacheT):
        return HybridCacheT(ssm=recurrent_clone(cache.ssm),
                            shared_attn=cache.shared_attn)
    if isinstance(cache, SSMCache):
        return SSMCache(conv=cache.conv.clone(), state=cache.state.clone())
    raise TypeError(f"no recurrent state in a {type(cache).__name__}")


class VerdictBuffer:
    """The target's verdict of one round in one flat int32 device tensor:
    rows 0–4 the (B,) fields of :class:`VerdictMsg` in its order
    (n_accepted, num_new, next_token, last_token, done), rows 5–6 the
    verified window's anchor token and start position (device-side: a
    fused round's draft ingest reads them), then a tree round's (B, d_max)
    winning path."""

    ROWS = 7

    def __init__(self, batch: int, d_max: int, device):
        self.batch, self.d_max = batch, d_max
        self.flat = torch.zeros((self.ROWS * batch + batch * d_max,),
                                dtype=_I32, device=device)
        self.rows = self.flat[:self.ROWS * batch].view(self.ROWS, batch)
        self.path = self.flat[self.ROWS * batch:].view(batch, d_max)

    @property
    def num_new(self) -> torch.Tensor:
        return self.rows[1]

    @property
    def anchor(self) -> torch.Tensor:
        return self.rows[5]

    @property
    def pos(self) -> torch.Tensor:
        return self.rows[6]

    def record_start(self, state) -> None:
        """Rows 5–6 from the window start (before the commit)."""
        self.rows[5].copy_(state.last_token)
        self.rows[6].copy_(state.pos)

    def record(self, stop, next_token, state, done, path=None) -> None:
        """Rows 0–4 after the commit (``state.last_token`` and ``done``
        already updated), and the path of a tree round."""
        for i, v in enumerate((stop.n_accepted, stop.num_new, next_token,
                               state.last_token, done)):
            self.rows[i].copy_(v)
        if path is not None:
            self.path.copy_(path)

    def message(self, host: np.ndarray, gamma: int, n_active: int,
                round_id: int) -> VerdictMsg:
        """The :class:`VerdictMsg` of a host copy of :attr:`flat`."""
        B = self.batch
        rows = host[:self.ROWS * B].reshape(self.ROWS, B)
        return VerdictMsg(
            n_accepted=rows[0].copy(), num_new=rows[1].copy(),
            next_token=rows[2].copy(), last_token=rows[3].copy(),
            done=rows[4].astype(bool), gamma=gamma, n_active=n_active,
            round_id=round_id,
            path=(host[self.ROWS * B:].reshape(B, self.d_max).copy()
                  if self.d_max else None))


class DraftWorker:
    """Edge-side worker: proposes speculation windows, tracks the committed
    prefix through verdicts."""

    def __init__(self, engine):
        self.engine = engine
        self.model = engine.draft
        self.params = engine.draft_params
        self.attention = engine._draft_attention
        self.temperature = engine.temperature

    def propose(self, gamma_max: int):
        """``fn(cache, last_token, pos, out: DraftWindow, generator=None)``:
        record the window start in ``out``, propose ``gamma_max`` tokens
        from it (:func:`~repro_torch.core.specdec.draft_propose`; at T > 0
        the Gumbel draws come from ``generator``) into ``out.tokens`` and
        their distributions into ``out.q_probs``. Always the full width:
        the round's γ masks acceptance on the target side and prices the
        payload. An attention draft's cache takes the window's KV in place
        (pos_map masks the stale tail); a recurrent draft's state is read,
        not written (:meth:`advance` moves it)."""
        self.engine.step_keys.add(("dw_propose", gamma_max))
        decode = self.model.decode_step

        def fn(cache, last_token, pos, out: DraftWindow,
               generator=None) -> None:
            out.anchor.copy_(last_token)
            out.pos.copy_(pos)
            prop = draft_propose(decode, self.params, cache, last_token, pos,
                                 gamma_max, self.temperature, generator)
            out.tokens.copy_(prop.tokens)
            if prop.q_probs is not None:
                out.q_probs.copy_(prop.q_probs)

        return fn

    def propose_tree(self, d_max: int, b_max: int):
        """``fn(cache, last_token, pos, out: DraftWindow)``: the greedy
        grid proposal (:func:`~repro_torch.core.tree.tree_propose`) into
        ``out.tokens`` (B, T), always the full (d_max, b_max) grid; the
        window start goes to ``out``. Attention drafts only."""
        self.engine._check_tree()
        self.engine.step_keys.add(("dw_propose_tree", d_max, b_max))
        spec = self.engine._tree_spec(d_max, b_max)

        def fn(cache, last_token, pos, out: DraftWindow) -> None:
            out.anchor.copy_(last_token)
            out.pos.copy_(pos)
            tree_tokens, _ = tree_propose(self.model, self.params, cache,
                                          last_token, pos, spec)
            out.tokens.copy_(tree_tokens)

        return fn

    def ingest_tree(self, d_max: int, b_max: int):
        """``fn(cache, win: DraftWindow)``: apply a received tree verdict
        (``win.path``, ``win.n_accepted``): relocate the winning path of
        the proposed grid onto the linear slots and scrub the losing
        branches (:func:`~repro_torch.models.kvcache.tree_commit_cache`,
        the target's commit mirrored), from the window start ``win.pos``."""
        self.engine._check_tree()
        self.engine.step_keys.add(("dw_ingest_tree", d_max, b_max))
        n_entries = self.engine._tree_spec(d_max, b_max).n_entries

        def fn(cache, win: DraftWindow) -> None:
            tree_commit_cache(cache, win.pos, win.path, win.n_accepted,
                              n_entries)

        return fn

    def ingest(self):
        """``fn(cache, token, pos, num_new)``: a fused round commits one
        target token without a draft window; the draft still ingests the
        round's anchor ``token`` at ``pos`` so its cache tracks the
        committed prefix. Rows with ``num_new == 0`` (done/free) keep their
        recurrent state (an attention cache takes the write in place, past
        a frozen row's prefix)."""
        self.engine.step_keys.add(("dw_ingest",))
        decode = self.model.decode_step

        def fn(cache, token, pos, num_new) -> None:
            _, new = decode(self.params, token, cache, pos)
            _copy_recurrent_(cache, _tree_where(num_new > 0, new, cache))

        return fn

    def advance(self, gamma_max: int):
        """``fn(cache, win: DraftWindow)``: apply a received linear verdict
        to a recurrent draft: re-advance the window-start state over
        ``[win.anchor, win.tokens]`` masked by ``win.num_new``
        (:func:`~repro_torch.core.engine._scan_cache_advance`, the
        colocated split step's advance)."""
        self.engine.step_keys.add(("dw_advance", gamma_max))
        decode = self.model.decode_step

        def fn(cache, win: DraftWindow) -> None:
            adv = torch.cat([win.anchor[:, None], win.tokens], dim=1)
            _scan_cache_advance(decode, self.params, cache, adv, win.pos,
                                win.num_new)

        return fn


    def checkpoint(self, gamma_max: int):
        """``fn(cache, ckpt, win: DraftWindow, rec: DraftWindow, num_new)``:
        the pipelined mode's optimistic advance of a recurrent draft over
        the window ``win`` just proposed: the window-start recurrent state
        into ``ckpt`` (:func:`recurrent_clone`), the window (anchor,
        proposals, start) and the predicted ``num_new`` into ``rec``, then
        :meth:`advance` over ``rec``. ``win`` may then take the speculative
        window while ``rec`` keeps this one for :meth:`rollback`."""
        adv = self.advance(gamma_max)

        def fn(cache, ckpt, win: DraftWindow, rec: DraftWindow,
               num_new) -> None:
            _copy_recurrent_(ckpt, cache)
            rec.anchor.copy_(win.anchor)
            rec.tokens.copy_(win.tokens)
            rec.pos.copy_(win.pos)
            rec.num_new.copy_(num_new)
            adv(cache, rec)

        return fn

    def rollback(self, gamma_max: int):
        """``fn(cache, ckpt, rec: DraftWindow)``: undo :meth:`checkpoint` on
        a miss: restore the window-start state from ``ckpt`` and re-advance
        over ``rec`` by the received verdict in ``rec.received``."""
        adv = self.advance(gamma_max)

        def fn(cache, ckpt, rec: DraftWindow) -> None:
            _copy_recurrent_(cache, ckpt)
            adv(cache, rec)

        return fn


class TargetWorker:
    """Cloud-side worker: verifies windows, owns the committed-token buffers
    and the per-slot lifecycle (budget/EOS enforcement lives where the
    tokens are produced)."""

    def __init__(self, engine):
        self.engine = engine
        self.model = engine.target
        self.params = engine.target_params
        self.attention = engine._target_attention
        self.temperature = engine.temperature

    def verify_commit(self, gamma_max: int):
        """``fn(state, tokens, q_probs, active_gamma, row_idx, out_buf,
        cursor, nacc_buf, nn_buf, max_new, done, eos_id, verdict,
        generator=None)``: verify the received proposals ``tokens`` (B,
        γ_max) behind the session's ``state.last_token`` (the target half
        of the colocated step: :func:`~repro_torch.core.specdec.
        verify_proposal`, greedy or the sampled rule with ``q_probs`` and
        ``generator``, then :meth:`SpecDecodeEngine._stop_and_advance`,
        where a split pair's target re-advances its window-start state),
        commit
        into the output buffer, cursors and lifecycle flags, and write the
        :class:`VerdictBuffer`. ``active_gamma`` 0 is the fused round:
        nothing accepted, the target's own next token committed, the
        proposals never read."""
        self.engine.step_keys.add(("tw_verify", gamma_max))
        eng = self.engine
        # the pair's colocated step kind: a recurrent side on either end
        # makes it the split step, whose target half re-advances the target
        split = not (eng._target_attention and eng._draft_attention)

        def fn(state, tokens, q_probs, active_gamma, row_idx, out_buf,
               cursor, nacc_buf, nn_buf, max_new, done, eos_id,
               verdict: VerdictBuffer, generator=None) -> None:
            verdict.record_start(state)
            res = verify_proposal(self.model.verify_step, self.params, state,
                                  tokens, q_probs, active_gamma,
                                  self.temperature, generator)
            stop, _ = eng._stop_and_advance(state, res, cursor, max_new,
                                            done, eos_id, split)
            _commit(state, res.state.last_token, stop, res.new_tokens,
                    out_buf, cursor, nacc_buf, nn_buf, row_idx, done)
            verdict.record(stop, res.state.last_token, state, done)

        return fn

    def verify_commit_tree(self, d_max: int, b_max: int):
        """``fn(state, tree_tokens, active_gamma, branches, row_idx,
        out_buf, cursor, nacc_buf, nn_buf, max_new, done, eos_id, verdict,
        *, counters)``: the tree round's verdict on the received (B, T)
        grid (:meth:`SpecDecodeEngine._tree_verdict`: one ancestor-masked
        verify pass, kernels B4a/B4b in one launch counted in the caller's
        zeroed ``counters``, the target cache's path relocation), the
        commit, and the :class:`VerdictBuffer` with the winning path the
        draft relocates its grid by. Greedy, attention families."""
        self.engine._check_tree()
        self.engine.step_keys.add(("tw_verify_tree", d_max, b_max))
        eng = self.engine
        spec = eng._tree_spec(d_max, b_max)

        def fn(state, tree_tokens, active_gamma, branches, row_idx, out_buf,
               cursor, nacc_buf, nn_buf, max_new, done, eos_id,
               verdict: VerdictBuffer, *, counters) -> None:
            verdict.record_start(state)
            res, new_tokens, stop = eng._tree_verdict(
                spec, state, tree_tokens, active_gamma, branches, cursor,
                max_new, done, eos_id, counters)
            _commit(state, res.next_token, stop, new_tokens, out_buf,
                    cursor, nacc_buf, nn_buf, row_idx, done)
            verdict.record(stop, res.next_token, state, done, res.path)

        return fn
