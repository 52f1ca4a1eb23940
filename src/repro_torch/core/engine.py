"""Speculative-decoding engine on the port's models: an edge draft and a
cloud target, colocated on one device, with a window policy in the loop.

The decode hot loop mirrors the reference ``repro/core/engine.py``:

- ONE step per draft/target pair at the fixed window width ``gamma_max``.
  The per-round γ chosen by the window policy enters as a device tensor
  that masks acceptance, so any γ ∈ [0, γ_max] runs the same step; at
  temperature 0 causality makes its committed tokens identical to a
  dedicated per-γ step.
- The step is slot-aware: every batch row carries a token budget and a
  ``done`` flag, and :func:`~repro_torch.core.specdec.slot_stop_mask`
  zeroes ``num_new`` for finished/free rows, so their cursor and position
  freeze while neighbours keep decoding — admission and retirement are
  data, never a new step.
- Caches, the output buffer, the cursors and the stats rows are updated IN
  PLACE (the reference donates them to its jitted step).
- The step never reads a device value on the host; the session syncs once
  per ``sync_every`` rounds.
- At temperature > 0 the draft samples, the sampled accept/resample rule
  runs through the kernel pair B3, and the anchor token of every admission
  is sampled; every draw comes from the session's ``torch.Generator`` on
  the device (the reference's PRNG key), so a seed fixes the tokens.
- Attention pairs run the fused step: the window's rejected KV stays
  behind the committed position, masked by ``pos_map``. A recurrent side
  (ssm or hybrid) cannot be rolled back that way, so such pairs run the
  split step (the reference's ``_split_step``): the draft proposes and the
  target verifies FROM the window-start state, which the port's recurrent
  steps return anew and never write (``models/ssm.py``), then
  :func:`_scan_cache_advance` re-advances that state over the committed
  tokens, one masked single-token step per window position, and copies the
  result into it. No checkpoint copy is taken: the window-start state is
  read, never written, until that final copy.

The reference jits each step once per shape key with donated buffers and
counts its programs (``compiled_programs()``). The port's steps are the
torch form of that contract: strictly IN PLACE over buffers the session
owns — the caches (the split step copies its re-advanced recurrent state
into the session's conv/state tensors at the end of the round), ``pos``
and ``last_token`` (written with ``copy_``), the output buffer, cursors,
budgets, done flags and stats rows — and every per-round or per-admission
value (γ, b, the stats row, slot, prompt, prompt length, budget, the paged
block rows) arrives in a device tensor of fixed address. So one step
serves every round: on the card the session captures it once as a CUDA
graph and replays it (:mod:`.capture`), on the CPU it runs eagerly.
:meth:`SpecDecodeEngine.step_programs` counts the distinct step keys built
(``("fused", γ_max)``, ``("split", γ_max)``, ``("tree", d_max, b_max)``,
``("insert", …)``, ``("insert-paged", …)``, ``("release",)``, and the
split workers' ``("dw_propose", γ_max)``, ``("tw_verify", γ_max)``,
``("dw_advance", γ_max)``, ``("dw_ingest",)``, ``("dw_propose_tree", …)``,
``("tw_verify_tree", …)``, ``("dw_ingest_tree", …)`` of a session over a
transport, :meth:`split_workers`), the quantity that must not grow with
γ/b changes or admission churn;
``graphs`` counts the graphs the engine's sessions captured and replayed.
Graphs belong to the buffers they were captured on, and those belong to
the engine: a session leases an engine-owned slot pool of its geometry
(:mod:`.pool`, :meth:`SpecDecodeEngine.lease_pool`), whose buffers and
captured steps every later session of that geometry reuses, so a second
``generate``, server run or tree wave of known geometry captures nothing
and warms nothing up. The functions that make the steps close over a
weak proxy of the engine: the engine keeps its pools, their steps keep
the bodies, and a strong reference back would make an engine whose
weights only the garbage collector frees. The wave prefill
(``admit_batch``) and the paged release stay eager.
"""

from __future__ import annotations

import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..kernels import resolve_device
from ..kernels.verify import tree_verify_fused
from ..models.kvcache import (HybridCacheT, PagedAttnCache, SSMCache,
                              insert_slot, paged_insert_row,
                              paged_release_slot, tree_commit_cache)
from ..models.model import build_model
from .capture import GraphCounts
from .pool import SlotPool
from .specdec import (SpecDecodeState, _temperature_probs, sample_from_probs,
                      slot_stop_mask, spec_decode_step)
from .tree import (TreeSpec, TreeVerifyResult, tree_committed,
                   tree_path_from_winner, tree_propose)
from .window import StaticWindowPolicy, WindowPolicy


def _tree_where(active: torch.Tensor, new, old):
    """Per-row select of a cache's recurrent leaves: ``new`` where
    ``active`` (B,) is set, ``old`` elsewhere, as new tensors. Attention
    caches (a hybrid's shared block included) are written in place by the
    step, so ``new`` and ``old`` are one cache there: a masked step's writes
    land past the committed position (pos_map masks them, the next window
    rewrites them) and it passes through."""
    if isinstance(new, HybridCacheT):
        return HybridCacheT(ssm=_tree_where(active, new.ssm, old.ssm),
                            shared_attn=new.shared_attn)
    if isinstance(new, SSMCache):
        sel = lambda n, o: torch.where(
            active.view(1, -1, *([1] * (n.dim() - 2))), n, o)
        return SSMCache(conv=sel(new.conv, old.conv),
                        state=sel(new.state, old.state))
    return new


def _copy_recurrent_(dst, src) -> None:
    """Write ``src``'s recurrent leaves into ``dst``'s tensors (attention
    caches are shared by the two and written in place already)."""
    if isinstance(dst, HybridCacheT):
        _copy_recurrent_(dst.ssm, src.ssm)
    elif isinstance(dst, SSMCache):
        dst.conv.copy_(src.conv)
        dst.state.copy_(src.state)


def _scan_cache_advance(decode_fn, params, cache, adv_tokens: torch.Tensor,
                        pos: torch.Tensor, num_new: torch.Tensor):
    """Advance a recurrent cache over the committed window, in place: step
    t feeds ``adv_tokens[:, t]`` at position ``pos + t`` and keeps the new
    state only for rows with t < ``num_new`` (a device mask: no host sync).
    A Python loop over the T = γ_max + 1 positions (the reference's
    ``lax.scan``); the loop reads ``cache`` as the window-start state and
    the result is copied into its tensors at the end. Returns ``cache``."""
    cur = cache
    for t in range(adv_tokens.shape[1]):
        _, new = decode_fn(params, adv_tokens[:, t], cur, pos + t)
        cur = _tree_where(t < num_new, new, cur)
    _copy_recurrent_(cache, cur)
    return cache


def _accumulate(new_tokens: torch.Tensor, num_new: torch.Tensor,
                n_accepted: torch.Tensor, out_buf: torch.Tensor,
                cursor: torch.Tensor, nacc_buf: torch.Tensor,
                nn_buf: torch.Tensor, row_idx: torch.Tensor) -> None:
    """Scatter this round's committed tokens into the device-resident output
    buffer at per-sequence cursors, advance the cursors, and record
    n_accepted / num_new in row ``row_idx`` of the stats buffers — all in
    place. ``out_buf`` is (B, cap + 1): writes past ``cap`` (tokens beyond
    ``max_new``, discarded on extraction) drop into the last column."""
    B, W = new_tokens.shape
    cap = out_buf.shape[1] - 1
    dev = new_tokens.device
    ar = torch.arange(W, device=dev)[None, :]
    widx = cursor[:, None].long() + ar
    keep = (ar < num_new[:, None]) & (widx < cap)
    widx = torch.where(keep, widx, cap)                 # cap = drop sink
    rows = torch.arange(B, device=dev)[:, None].expand(B, W)
    out_buf[rows, widx] = new_tokens.to(out_buf.dtype)
    cursor.add_(num_new)
    nacc_buf.index_copy_(0, row_idx.reshape(1), n_accepted[None, :])
    nn_buf.index_copy_(0, row_idx.reshape(1), num_new[None, :])


def _commit(state: SpecDecodeState, next_token: torch.Tensor, stop,
            new_tokens: torch.Tensor, out_buf, cursor, nacc_buf, nn_buf,
            row_idx, done) -> None:
    """The end of every round, in place: rows still live take the round's
    next token and advance ``pos`` by their lifecycle-clamped count; the
    committed tokens and stats go to the output and stats buffers; the done
    flags update last (the token select reads the old ones)."""
    state.last_token.copy_(torch.where(done, state.last_token, next_token))
    state.pos.add_(stop.num_new)
    _accumulate(new_tokens, stop.num_new, stop.n_accepted, out_buf, cursor,
                nacc_buf, nn_buf, row_idx)
    done.copy_(stop.done)


@dataclass
class GenerationStats:
    iterations: int = 0
    proposed: int = 0
    accepted: int = 0
    tokens: int = 0
    wall_s: float = 0.0
    prefill_s: float = 0.0           # prompt-processing wall time (≈ TTFT)
    virtual_ms: float = 0.0          # simulated edge-cloud time (incl. RTT)
    acceptance_seqs: list = field(default_factory=list)  # per-seq 0/1 bits
    gamma_seq: list = field(default_factory=list)
    produced: Any = None             # (B,) per-sequence tokens produced
                                     # (anchor included; ≤ max_new)
    pipeline_hits: int = 0           # speculative windows kept (pipelined
    pipeline_misses: int = 0         # mode) / discarded and rolled back

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / max(1, self.proposed)

    @property
    def tokens_per_iteration(self) -> float:
        return self.tokens / max(1, self.iterations)

    @property
    def prefill_ms(self) -> float:
        return self.prefill_s * 1e3


DEFAULT_GAMMA_MAX = 8


class SpecDecodeEngine:
    """Edge draft + cloud target, window policy in the loop.

    ``device`` is the card unless the caller passes ``device="cpu"``;
    without a CUDA device and without ``device="cpu"`` construction raises.
    ``temperature`` > 0 samples (kernels B3 verify every round); 0 is
    greedy. The tree step is greedy-only.
    Weights not passed in are drawn on the device from ``seed`` (draft from
    ``seed``, target from ``seed + 1``). ``gamma_max`` pins the window
    width (None: the policy's own bound per ``generate``); ``sync_every``
    sets how many rounds run between host syncs."""

    def __init__(self, draft_cfg: ModelConfig, target_cfg: ModelConfig,
                 draft_params=None, target_params=None, seed: int = 0,
                 temperature: float = 0.0, rtt_ms: float = 0.0,
                 gamma_max: Optional[int] = None, sync_every: int = 8,
                 device=None):
        if temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {temperature}")
        assert draft_cfg.vocab == target_cfg.vocab, \
            "draft/target must share a tokenizer/vocab"
        self.device = resolve_device(device)
        self.draft_cfg, self.target_cfg = draft_cfg, target_cfg
        self.draft = build_model(draft_cfg, self.device)
        self.target = build_model(target_cfg, self.device)
        self.draft_params = (draft_params if draft_params is not None
                             else self.draft.init_params(seed))
        self.target_params = (target_params if target_params is not None
                              else self.target.init_params(seed + 1))
        self.temperature = float(temperature)
        self.rtt_ms = rtt_ms
        self.gamma_max = None if gamma_max is None else int(gamma_max)
        self.sync_every = int(sync_every)
        self._target_attention = target_cfg.has_attention_cache
        self._draft_attention = draft_cfg.has_attention_cache
        self.step_keys: set = set()
        self._tree_specs: dict = {}      # ("tree", d_max, b_max) → tables
        # graphs captured / replays / warm-ups of this engine's sessions:
        # a continuous server on the card captures 2 (round step, insert)
        self.graphs = GraphCounts()
        self.pools: dict[tuple, list[SlotPool]] = {}   # geometry → pools
        # what the step closures hold (see the module docstring)
        self._proxy = weakref.proxy(self)

    def lease_pool(self, key: tuple, **shape) -> SlotPool:
        """A pool of geometry ``key`` that no live session holds, marked
        leased; a new one (built from ``shape``, :class:`SlotPool`'s
        arguments) when every pool of the key is leased."""
        pools = self.pools.setdefault(key, [])
        free = [pool for pool in pools if not pool.leased]
        if free:
            pool = free[0]
        else:
            pool = SlotPool(key, self.device, **shape)
            pools.append(pool)
        pool.leased = True
        return pool

    def split_workers(self):
        """The engine split at the wire: ``(DraftWorker, TargetWorker)``
        (``distributed/workers.py``). They share this engine's models,
        params and ``step_keys``, so :meth:`step_programs` counts their
        programs too. Made per call and not kept: a worker refers to the
        engine, and an engine that kept its workers would be a reference
        cycle, its weights freed only by the garbage collector."""
        from ..distributed.workers import DraftWorker, TargetWorker
        return DraftWorker(self._proxy), TargetWorker(self._proxy)

    def step_programs(self) -> int:
        """Distinct step keys built so far (the reference's compiled-program
        count): a continuous server shows 2 — one step, one insert."""
        return len(self.step_keys)

    def _policy_gamma_bound(self, policy) -> int:
        bound = getattr(policy, "gamma_bound", None)
        g = bound() if callable(bound) else DEFAULT_GAMMA_MAX
        return max(1, int(g))

    # ----------------------------------------------------------------- steps

    def _step_fn(self, gamma_max: int):
        """The linear step for this pair: fused for two attention models,
        split when either side is recurrent."""
        if self._target_attention and self._draft_attention:
            return self._fused_step(gamma_max)
        return self._split_step(gamma_max)

    def _fused_step(self, gamma_max: int):
        """The decode step at width ``gamma_max`` for an attention pair.
        Finished/free rows commit nothing and their position freezes; the
        window KV they still write lands beyond their committed prefix
        (masked by pos_map) and is overwritten by the next insert into that
        slot. ``generator`` (the session's) feeds the sampled rounds; greedy
        rounds draw nothing."""
        self.step_keys.add(("fused", gamma_max))
        return self._linear_step(gamma_max, split=False)

    def _split_step(self, gamma_max: int):
        """The decode step at width ``gamma_max`` for a pair with a
        recurrent side (reference ``_split_step``): the round proposes and
        verifies from the window-start state (left intact by the recurrent
        steps), then re-advances the target — and a recurrent draft — over
        ``[last_token, committed[:num_new − 1]]`` with
        :func:`_scan_cache_advance`, masked by the lifecycle-clamped
        ``num_new``: a finished/free row's state never advances. Greedy
        and sampled (B3) alike."""
        self.step_keys.add(("split", gamma_max))
        return self._linear_step(gamma_max, split=True)

    def _linear_step(self, gamma_max: int, split: bool):
        draft_decode = self.draft.decode_step
        target_verify = self.target.verify_step
        eng = self._proxy

        def step(state: SpecDecodeState, active_gamma, row_idx, out_buf,
                 cursor, nacc_buf, nn_buf, max_new, done, eos_id,
                 generator=None) -> None:
            res = spec_decode_step(draft_decode, target_verify,
                                   eng.draft_params, eng.target_params,
                                   state, gamma_max, active_gamma,
                                   eng.temperature, generator)
            stop, adv = eng._stop_and_advance(state, res, cursor, max_new,
                                              done, eos_id, split)
            if split and not eng._draft_attention:
                _scan_cache_advance(draft_decode, eng.draft_params,
                                    state.draft_cache, adv, state.pos,
                                    stop.num_new)
            _commit(state, res.state.last_token, stop, res.new_tokens, out_buf,
                    cursor, nacc_buf, nn_buf, row_idx, done)

        return step

    def _stop_and_advance(self, state: SpecDecodeState, res, cursor, max_new,
                          done, eos_id, split: bool):
        """The tail of a linear round's target half, shared by the colocated
        step and the split workers' verify (``distributed/workers.py``):
        clamp the verified window to each slot's lifecycle
        (:func:`slot_stop_mask`) and, when ``split``, re-advance the
        target's window-start state over ``[last_token,
        committed[:num_new − 1]]`` with :func:`_scan_cache_advance`.
        Returns (stop, the advance tokens); the caller commits, so
        ``state.pos`` and ``last_token`` are still the window start."""
        stop = slot_stop_mask(res.num_new, res.n_accepted, res.new_tokens,
                              cursor, max_new, done, eos_id)
        adv = None
        if split:
            # committed[t] enters the state when the next window runs it,
            # so the advance feeds last_token then the first num_new − 1
            # committed tokens; masked steps (t ≥ num_new) read any valid
            # id in place of the −1 pad
            adv = torch.cat([state.last_token[:, None],
                             res.new_tokens[:, :-1].clamp_min(0)], dim=1)
            _scan_cache_advance(self.target.decode_step, self.target_params,
                                state.target_cache, adv, state.pos,
                                stop.num_new)
        return stop, adv

    def _tree_spec(self, d_max: int, b_max: int) -> TreeSpec:
        """The (d_max, b_max) grid's tables on this engine's device."""
        key = ("tree", d_max, b_max)
        if key not in self._tree_specs:
            self._tree_specs[key] = TreeSpec(d_max, b_max, self.device)
        return self._tree_specs[key]

    def _check_tree(self) -> None:
        if self.temperature > 0.0:
            raise NotImplementedError(
                "tree speculation is greedy-only (temperature 0)")
        if not all(c.has_attention_cache
                   for c in (self.draft_cfg, self.target_cfg)):
            raise NotImplementedError(
                "tree speculation needs attention-family draft and target")

    def _tree_step(self, d_max: int, b_max: int):
        """The tree-speculation step at the (d_max, b_max) grid bound
        (reference ``_tree_step``). The round's depth γ ≤ d_max and branch
        count b ≤ b_max arrive as device scalars that only mask acceptance
        (``node_valid``), so {γ, b} vary per round on one step. The draft
        proposes the grid (1 anchor decode + d_max − 1 depth windows), the
        target verifies it in one ancestor-masked pass, kernels B4a/B4b
        give the verdict in one launch (their plain versions for CPU
        tensors), and the winning path is relocated onto the linear slots
        of both caches.
        Greedy only, attention families only."""
        self._check_tree()
        self.step_keys.add(("tree", d_max, b_max))
        spec = self._tree_spec(d_max, b_max)
        eng = self._proxy

        def step(state: SpecDecodeState, active_gamma, branches, row_idx,
                 out_buf, cursor, nacc_buf, nn_buf, max_new, done, eos_id,
                 *, counters) -> None:
            # counters: the caller's zeroed int32 (B,) workspace of the
            # one-launch verdict (tree_verify_fused)
            tree_tokens, dcache = tree_propose(
                eng.draft, eng.draft_params, state.draft_cache,
                state.last_token, state.pos, spec)
            res, new_tokens, stop = eng._tree_verdict(
                spec, state, tree_tokens, active_gamma, branches, cursor,
                max_new, done, eos_id, counters)
            # the draft's grid moves like the target's (tree slots are not
            # positions)
            tree_commit_cache(dcache, state.pos, res.path, stop.n_accepted,
                              spec.n_entries)
            _commit(state, res.next_token, stop, new_tokens, out_buf, cursor,
                    nacc_buf, nn_buf, row_idx, done)

        return step

    def _tree_verdict(self, spec: TreeSpec, state: SpecDecodeState,
                      tree_tokens, active_gamma, branches, cursor, max_new,
                      done, eos_id, counters):
        """The target half of a tree round, shared by the colocated tree step
        and the split workers' tree verify: one ancestor-masked verify pass
        over the (B, T) grid (entry 0 the anchor), the verdict by kernels
        B4a/B4b in one launch, the committed tokens, the lifecycle clamp,
        and the winning path relocated onto the target cache's linear slots
        (lifecycle-clamped counts scrub what the budget or EOS cut).
        Returns (result, committed tokens, stop); the caller commits."""
        p_logits, tcache = self.target.verify_step(
            self.target_params, tree_tokens, state.target_cache,
            state.pos, slot_off=spec.slot_off, pos_off=spec.tree_pos,
            win_mask=spec.win_mask)
        node_valid = spec.node_valid(active_gamma, branches)
        n_acc, winner, bonus = tree_verify_fused(
            tree_tokens, p_logits, spec.parent_entry, spec.tree_pos,
            node_valid, spec.win_mask, spec.win_words, counters)
        res = TreeVerifyResult(
            n_accepted=n_acc, next_token=bonus, winner=winner,
            path=tree_path_from_winner(winner, spec.parent_entry,
                                       spec.tree_pos, spec.d_max),
            accept=None)
        new_tokens, num_new = tree_committed(tree_tokens, res, spec.d_max)
        stop = slot_stop_mask(num_new, n_acc, new_tokens, cursor, max_new,
                              done, eos_id)
        tree_commit_cache(tcache, state.pos, res.path, stop.n_accepted,
                          spec.n_entries)
        return res, new_tokens, stop

    def _insert_rows(self, state: SpecDecodeState, one: SpecDecodeState,
                     out_buf, cursor, max_new_buf, done, slot: torch.Tensor,
                     req_max_new: torch.Tensor) -> None:
        """Batch row ``slot`` ((1,) int64 device index) of the state and the
        lifecycle buffers takes the admitted request: anchor token, position,
        an output row holding only the anchor, cursor 1, the budget
        ``req_max_new`` ((1,) int32), not done."""
        state.last_token.index_copy_(0, slot, one.last_token[:1])
        state.pos.index_copy_(0, slot, one.pos[:1])
        row = torch.cat([one.last_token[:1, None].to(out_buf.dtype),
                         out_buf.new_full((1, out_buf.shape[1] - 1), -1)],
                        dim=1)
        out_buf.index_copy_(0, slot, row)
        cursor.index_fill_(0, slot, 1)
        max_new_buf.index_copy_(0, slot, req_max_new.to(max_new_buf.dtype))
        done.index_fill_(0, slot, False)

    def _insert_step(self, capacity: int, slots: int, pad_len: int):
        """Prefill-insert for a live session: prefill one ``pad_len``-padded
        prompt (true length ``plen``, (1,) int32) and write its cache row,
        anchor token, position and lifecycle entries into batch row
        ``slot`` ((1,) device index), in place. One step key per session
        geometry, any slot / prompt length / budget: all three are device
        values."""
        self.step_keys.add(("insert", capacity, slots, pad_len))
        eng = self._proxy

        def insert(state, out_buf, cursor, max_new_buf, done, prompt, plen,
                   slot, req_max_new, generator=None) -> None:
            one = eng._prefill(prompt, slots, prompt_lens=plen,
                               generator=generator)
            slot = slot.long()
            insert_slot(state.draft_cache, one.draft_cache, slot)
            insert_slot(state.target_cache, one.target_cache, slot)
            eng._insert_rows(state, one, out_buf, cursor, max_new_buf,
                             done, slot, req_max_new)

        return insert

    def _insert_step_paged(self, capacity: int, slots: int, pad_len: int,
                           d_nlog: int, t_nlog: int):
        """Paged admission: prefill one prompt into a DENSE batch-1 row
        (``slots`` = the pool's logical length), scatter it into the
        reserved pool blocks (``draft_blocks``/``target_blocks``, device
        rows padded with −1) and point the slot's block table at them."""
        self.step_keys.add(("insert-paged", capacity, slots, pad_len,
                            d_nlog, t_nlog))
        eng = self._proxy

        def insert(state, out_buf, cursor, max_new_buf, done, prompt, plen,
                   slot, req_max_new, draft_blocks, target_blocks,
                   generator=None) -> None:
            one = eng._prefill(prompt, slots, prompt_lens=plen,
                               generator=generator)
            slot = slot.long()
            for cache, row, blocks in (
                    (state.draft_cache, one.draft_cache, draft_blocks),
                    (state.target_cache, one.target_cache, target_blocks)):
                if isinstance(cache, PagedAttnCache):
                    paged_insert_row(cache, row, blocks, slot)
                else:
                    insert_slot(cache, row, slot)
            eng._insert_rows(state, one, out_buf, cursor, max_new_buf,
                             done, slot, req_max_new)

        return insert

    def _release_step(self):
        """Retirement for paged sessions: unmap the slot's block-table rows
        so the frozen slot's ongoing (masked) window writes drop instead of
        stomping blocks the allocator is about to hand out. Ordered on the
        device stream ahead of any later insert that reuses the blocks."""
        self.step_keys.add(("release",))

        def release(state: SpecDecodeState, slot: int) -> None:
            for cache in (state.draft_cache, state.target_cache):
                if isinstance(cache, PagedAttnCache):
                    paged_release_slot(cache, slot)

        return release

    # --------------------------------------------------------------- prefill

    def _prefill(self, prompts: torch.Tensor, slots: int,
                 prompt_lens: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 frontend: Optional[torch.Tensor] = None
                 ) -> SpecDecodeState:
        """Right-padded batched prefill. With ``prompt_lens`` the anchor
        logit is taken at each sequence's true last prompt token, padded
        cache slots are overwritten before any query can attend them, and
        recurrent state stops exactly at the true length. The
        anchor token is the target's argmax at temperature 0 and a sample
        (noise from ``generator``) above it. ``frontend`` (B, F, D) goes to
        both models' prefill (an encdec side encodes it; a vlm refuses
        it)."""
        B, S = prompts.shape
        _, dcache = self.draft.prefill(self.draft_params, prompts, slots,
                                       prompt_lens=prompt_lens,
                                       frontend=frontend)
        tlg, tcache = self.target.prefill(self.target_params, prompts, slots,
                                          prompt_lens=prompt_lens,
                                          frontend=frontend)
        if prompt_lens is None:
            anchor = tlg[:, -1, :]
            pos = torch.full((B,), S, dtype=torch.int32, device=self.device)
        else:
            rows = torch.arange(B, device=self.device)
            anchor = tlg[rows, (prompt_lens - 1).long()]
            # a copy: the state's pos is written in place by every round
            pos = prompt_lens.to(torch.int32, copy=True)
        if self.temperature <= 0.0:
            first = torch.argmax(anchor, dim=-1).to(torch.int32)
        else:
            first = sample_from_probs(
                _temperature_probs(anchor, self.temperature), generator)
        return SpecDecodeState(draft_cache=dcache, target_cache=tcache,
                               last_token=first, pos=pos)

    # -------------------------------------------------------------- generate

    def generate(self, prompts: np.ndarray, max_new_tokens: int,
                 window_policy: Optional[WindowPolicy] = None,
                 prompt_lens: Optional[np.ndarray] = None,
                 gamma_max: Optional[int] = None,
                 sync_every: Optional[int] = None, eos_id: int = -1,
                 transport=None, mode_policy: str = "auto", seed: int = 0,
                 frontend=None) -> tuple[np.ndarray, GenerationStats]:
        """Batched one-wave generation over a :class:`DecodeSession`.
        Returns (tokens (B, max_new), stats). ``seed`` seeds the session's
        generator (the sampled path's draws; the reference's ``key``).
        ``transport`` (a :class:`repro_torch.distributed.Transport`) runs
        the rounds as draft→verify→verdict exchanges between the split
        workers; ``mode_policy`` is the session's. ``frontend`` (B, F, D),
        a tensor or array: an encdec pair's frame embeddings. The session
        is closed at the end, so its pool serves the next call of this
        geometry."""
        from .session import DecodeSession    # session imports engine types
        policy = window_policy or StaticWindowPolicy(4)
        if gamma_max:
            gmax = int(gamma_max)
        elif self.gamma_max:
            gmax = self.gamma_max
        else:
            gmax = self._policy_gamma_bound(policy)
        sync = max(1, int(sync_every if sync_every else self.sync_every))
        B = prompts.shape[0]
        t0 = time.perf_counter()
        with DecodeSession(self, capacity=B, max_new_cap=max_new_tokens,
                           gamma_max=gmax, sync_every=sync, eos_id=eos_id,
                           mode_policy=mode_policy, seed=seed,
                           transport=transport) as sess:
            sess.admit_batch(prompts, max_new_tokens,
                             prompt_lens=prompt_lens, frontend=frontend)
            max_iters = max_new_tokens + sync
            while sess.unfinished and sess.iterations < max_iters:
                sess.run_chunk(policy, max_iters=max_iters)
            tokens, stats = sess.snapshot()
        stats.wall_s = time.perf_counter() - t0
        return tokens, stats

    # ------------------------------------------------------------ trace capture

    def capture_traces(self, prompts: np.ndarray, max_new_tokens: int,
                       gamma: int = 8, seed: int = 0) -> list[list[int]]:
        """Ground-truth acceptance sequences for DSD-Sim (paper §3.2): the
        per-request 0/1 acceptance bits of a static-γ run."""
        _, stats = self.generate(prompts, max_new_tokens,
                                 StaticWindowPolicy(gamma), seed=seed)
        return stats.acceptance_seqs
