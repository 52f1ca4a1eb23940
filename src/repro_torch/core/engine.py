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

The reference counts compiled XLA programs; the port counts the distinct
step keys it has built (``("fused", γ_max)``, ``("tree", d_max, b_max)``,
``("insert", …)``, ``("insert-paged", …)``, ``("release",)``) — the
quantity that must not grow with γ/b changes or admission churn. Capturing
the step in a CUDA graph is a later item of the ROADMAP.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..kernels import resolve_device
from ..kernels.verify import tree_verify_fused
from ..models.kvcache import (PagedAttnCache, insert_slot, paged_insert_row,
                              paged_release_slot, tree_commit_cache)
from ..models.model import build_model
from .specdec import (SpecDecodeState, _temperature_probs, sample_from_probs,
                      slot_stop_mask, spec_decode_step)
from .tree import (TreeSpec, TreeVerifyResult, tree_committed,
                   tree_path_from_winner, tree_propose)
from .window import StaticWindowPolicy, WindowPolicy

# families whose caches the tree step relocates (pos_map surgery on dense
# attention rows), as the reference's engine decides
ATTENTION_FAMILIES = ("dense", "moe", "vlm", "encdec")


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
        self.step_keys: set = set()
        self._tree_specs: dict = {}      # (d_max, b_max) → device tables

    def step_programs(self) -> int:
        """Distinct step keys built so far (the reference's compiled-program
        count): a continuous server shows 2 — one step, one insert."""
        return len(self.step_keys)

    def _policy_gamma_bound(self, policy) -> int:
        bound = getattr(policy, "gamma_bound", None)
        g = bound() if callable(bound) else DEFAULT_GAMMA_MAX
        return max(1, int(g))

    # ----------------------------------------------------------------- steps

    def _fused_step(self, gamma_max: int):
        """The decode step at width ``gamma_max``. Finished/free rows commit
        nothing and their position freezes; the window KV they still write
        lands beyond their committed prefix (masked by pos_map) and is
        overwritten by the next insert into that slot. ``generator`` (the
        session's) feeds the sampled rounds; greedy rounds draw nothing."""
        self.step_keys.add(("fused", gamma_max))
        draft_decode = self.draft.decode_step
        target_verify = self.target.verify_step

        def step(state: SpecDecodeState, active_gamma, row_idx, out_buf,
                 cursor, nacc_buf, nn_buf, max_new, done, eos_id,
                 generator=None) -> SpecDecodeState:
            res = spec_decode_step(draft_decode, target_verify,
                                   self.draft_params, self.target_params,
                                   state, gamma_max, active_gamma,
                                   self.temperature, generator)
            stop = slot_stop_mask(res.num_new, res.n_accepted,
                                  res.new_tokens, cursor, max_new, done,
                                  eos_id)
            new_state = SpecDecodeState(
                draft_cache=res.state.draft_cache,
                target_cache=res.state.target_cache,
                last_token=torch.where(done, state.last_token,
                                       res.state.last_token),
                pos=state.pos + stop.num_new)
            _accumulate(res.new_tokens, stop.num_new, stop.n_accepted,
                        out_buf, cursor, nacc_buf, nn_buf, row_idx)
            done.copy_(stop.done)
            return new_state

        return step

    def _tree_step(self, d_max: int, b_max: int):
        """The tree-speculation step at the (d_max, b_max) grid bound
        (reference ``_tree_step``). The round's depth γ ≤ d_max and branch
        count b ≤ b_max arrive as device scalars that only mask acceptance
        (``node_valid``), so {γ, b} vary per round on one step. The draft
        proposes the grid (1 anchor decode + d_max − 1 depth windows), the
        target verifies it in one ancestor-masked pass, kernels B4a/B4b
        give the verdict (their plain versions for CPU tensors), and the
        winning path is relocated onto the linear slots of both caches.
        Greedy only, attention families only."""
        if self.temperature > 0.0:
            raise NotImplementedError(
                "tree speculation is greedy-only (temperature 0)")
        if not all(c.arch_type in ATTENTION_FAMILIES
                   for c in (self.draft_cfg, self.target_cfg)):
            raise NotImplementedError(
                "tree speculation needs attention-family draft and target")
        key = ("tree", d_max, b_max)
        self.step_keys.add(key)
        if key not in self._tree_specs:
            self._tree_specs[key] = TreeSpec(d_max, b_max, self.device)
        spec = self._tree_specs[key]
        T = spec.n_entries

        def step(state: SpecDecodeState, active_gamma, branches, row_idx,
                 out_buf, cursor, nacc_buf, nn_buf, max_new, done, eos_id
                 ) -> SpecDecodeState:
            tree_tokens, dcache = tree_propose(
                self.draft, self.draft_params, state.draft_cache,
                state.last_token, state.pos, spec)
            p_logits, tcache = self.target.verify_step(
                self.target_params, tree_tokens, state.target_cache,
                state.pos, slot_off=spec.slot_off, pos_off=spec.tree_pos,
                win_mask=spec.win_mask)
            node_valid = spec.node_valid(active_gamma, branches)
            n_acc, winner, bonus = tree_verify_fused(
                tree_tokens, p_logits, spec.parent_entry, spec.tree_pos,
                node_valid, spec.win_mask)
            res = TreeVerifyResult(
                n_accepted=n_acc, next_token=bonus, winner=winner,
                path=tree_path_from_winner(winner, spec.parent_entry,
                                           spec.tree_pos, d_max),
                accept=None)
            new_tokens, num_new = tree_committed(tree_tokens, res, d_max)
            stop = slot_stop_mask(num_new, n_acc, new_tokens, cursor,
                                  max_new, done, eos_id)
            # relocate the winning path in BOTH caches (tree slots are not
            # positions); lifecycle-clamped counts scrub what the budget
            # or EOS cut
            for cache in (tcache, dcache):
                tree_commit_cache(cache, state.pos, res.path,
                                  stop.n_accepted, T)
            new_state = SpecDecodeState(
                draft_cache=dcache, target_cache=tcache,
                last_token=torch.where(done, state.last_token, bonus),
                pos=state.pos + stop.num_new)
            _accumulate(new_tokens, stop.num_new, stop.n_accepted, out_buf,
                        cursor, nacc_buf, nn_buf, row_idx)
            done.copy_(stop.done)
            return new_state

        return step

    def _insert_rows(self, state: SpecDecodeState, one: SpecDecodeState,
                     out_buf, cursor, max_new_buf, done, slot: int,
                     req_max_new: int) -> None:
        state.last_token[slot] = one.last_token[0]
        state.pos[slot] = one.pos[0]
        out_buf[slot] = -1
        out_buf[slot, 0] = one.last_token[0]
        cursor[slot] = 1
        max_new_buf[slot] = req_max_new
        done[slot] = False

    def _insert_step(self, capacity: int, slots: int, pad_len: int):
        """Prefill-insert for a live session: prefill one ``pad_len``-padded
        prompt (true length ``plen``) and write its cache row, anchor token,
        position and lifecycle entries into batch row ``slot``, in place.
        One step key per session geometry, any slot / prompt length."""
        self.step_keys.add(("insert", capacity, slots, pad_len))

        def insert(state, out_buf, cursor, max_new_buf, done, prompt, plen,
                   slot: int, req_max_new: int, generator=None) -> None:
            one = self._prefill(prompt, slots, prompt_lens=plen,
                                generator=generator)
            insert_slot(state.draft_cache, one.draft_cache, slot)
            insert_slot(state.target_cache, one.target_cache, slot)
            self._insert_rows(state, one, out_buf, cursor, max_new_buf,
                              done, slot, req_max_new)

        return insert

    def _insert_step_paged(self, capacity: int, slots: int, pad_len: int,
                           d_nlog: int, t_nlog: int):
        """Paged admission: prefill one prompt into a DENSE batch-1 row
        (``slots`` = the pool's logical length), scatter it into the
        reserved pool blocks and point the slot's block table at them."""
        self.step_keys.add(("insert-paged", capacity, slots, pad_len,
                            d_nlog, t_nlog))

        def insert(state, out_buf, cursor, max_new_buf, done, prompt, plen,
                   slot: int, req_max_new: int, draft_blocks,
                   target_blocks, generator=None) -> None:
            one = self._prefill(prompt, slots, prompt_lens=plen,
                                generator=generator)
            for cache, row, blocks in (
                    (state.draft_cache, one.draft_cache, draft_blocks),
                    (state.target_cache, one.target_cache, target_blocks)):
                if isinstance(cache, PagedAttnCache):
                    paged_insert_row(cache, row, blocks, slot)
                else:
                    insert_slot(cache, row, slot)
            self._insert_rows(state, one, out_buf, cursor, max_new_buf,
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
                 generator: Optional[torch.Generator] = None
                 ) -> SpecDecodeState:
        """Right-padded batched prefill. With ``prompt_lens`` the anchor
        logit is taken at each sequence's true last prompt token; padded
        cache slots are overwritten before any query can attend them. The
        anchor token is the target's argmax at temperature 0 and a sample
        (noise from ``generator``) above it."""
        B, S = prompts.shape
        _, dcache = self.draft.prefill(self.draft_params, prompts, slots)
        tlg, tcache = self.target.prefill(self.target_params, prompts, slots)
        if prompt_lens is None:
            anchor = tlg[:, -1, :]
            pos = torch.full((B,), S, dtype=torch.int32, device=self.device)
        else:
            rows = torch.arange(B, device=self.device)
            anchor = tlg[rows, (prompt_lens - 1).long()]
            pos = prompt_lens.to(torch.int32)
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
                 transport=None, mode_policy: str = "auto", seed: int = 0
                 ) -> tuple[np.ndarray, GenerationStats]:
        """Batched one-wave generation over a :class:`DecodeSession`.
        Returns (tokens (B, max_new), stats). ``seed`` seeds the session's
        generator (the sampled path's draws; the reference's ``key``).
        ``transport`` (the distributed split) comes with ROADMAP item A9."""
        from .session import DecodeSession    # session imports engine types
        if transport is not None:
            raise NotImplementedError(
                "transports (the distributed draft/target split) come with "
                "ROADMAP item A9")
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
        sess = DecodeSession(self, capacity=B, max_new_cap=max_new_tokens,
                             gamma_max=gmax, sync_every=sync, eos_id=eos_id,
                             mode_policy=mode_policy, seed=seed)
        sess.admit_batch(prompts, max_new_tokens, prompt_lens=prompt_lens)
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
