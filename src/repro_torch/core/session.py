"""Persistent slot-based decode session — continuous batching on the port's
models (the colocated path of the reference ``repro/core/session.py``).

:class:`DecodeSession` owns a fixed-capacity pool of batch rows ("slots")
whose KV caches, output buffer and cursors live on the device across
requests. Requests are admitted into free slots by a prefill-insert and
retired from finished slots at ``sync_every`` boundaries; the engine's
masked-γ step keeps running while the active-slot pattern changes —
admission and retirement are data, never a new step.

Lifecycle of one slot::

    admit (prefill-insert row j)  →  decode chunks (slot active)
        →  done (budget / EOS; num_new masked to 0, row freezes)
        →  retire (tokens extracted, host record closed, slot free)
        →  admit next request (row j fully overwritten)

The rounds of a chunk never read a device value on the host; on a CUDA
device they run under ``torch.cuda.set_sync_debug_mode("error")``, so a
host sync slipped into the step raises instead of silently serializing the
loop. The host syncs once per chunk (:meth:`_sync_and_attribute`).

The session owns one ``torch.Generator`` on its device, seeded from
``seed`` (the reference session's PRNG key). At temperature > 0 every
round and every admission draws from it on the device — the draft's
Gumbel noise, the verify's uniforms, the sampled anchor token — so a seed
fixes the committed tokens and no draw syncs the host.

With ``max_branches > 0`` the rounds are tree-speculation rounds (the
engine's ``_tree_step``; dense KV, greedy, colocated). The transport and
pipelined rounds of the reference come with ROADMAP item A9.
"""

from __future__ import annotations

import contextlib
import functools
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..models.kvcache import BlockAllocator, logical_blocks, reset_slot
# fused-mode tokens stream edge-ward one control round trip per this many
# committed tokens (the reference's sim/network.DEFAULT_FUSED_CHUNK)
from .awc.model import DEFAULT_FUSED_CHUNK as FUSED_FLUSH_TOKENS
from .engine import ATTENTION_FAMILIES, DEFAULT_GAMMA_MAX, GenerationStats
from .specdec import SpecDecodeState
from .window import FeatureSnapshot


@dataclass
class SlotRecord:
    """Host-side bookkeeping for the request occupying one slot."""
    request_id: int
    max_new: int
    admit_it: int                    # session iteration at admission
    bits: list = field(default_factory=list)   # acceptance 0/1 stream
    produced: int = 1                # tokens in out_buf row (anchor incl.)
    proposed: int = 0
    accepted: int = 0
    done: bool = False


@contextlib.contextmanager
def no_host_sync(device: torch.device):
    """Raise on any host synchronization inside the block (CUDA only)."""
    if device.type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


class DecodeSession:
    """Fixed-capacity slot pool over a :class:`SpecDecodeEngine`.

    ``capacity``       batch rows,
    ``max_new_cap``    output-buffer width (per-request budgets clamp to it),
    ``max_prompt_len`` pad bound for per-slot admission (``admit``); a
                       session only ever driven by ``admit_batch`` may leave
                       it None and inherits the wave's prompt width,
    ``gamma_max``      window width (session > engine > default),
    ``sync_every``     rounds between host syncs — the admission/retirement
                       granularity,
    ``eos_id``         stop token (−1 disables; per-slot budgets always cap),
    ``mode_policy``    ``"auto"`` honors ``WindowDecision.mode``,
                       ``"distributed"``/``"fused"`` force one mode,
    ``paged``          KV in a paged block pool: admission reserves only the
                       blocks a request's ``prompt + budget + 2γ`` footprint
                       needs and retirement frees them; greedy tokens equal
                       the dense layout's (``kv_quantize=False``),
    ``kv_block_size``  positions per pool block,
    ``kv_pool_blocks`` physical blocks per pool (int, or
                       ``{"draft": n, "target": m}``); None sizes the pool
                       at full dense parity,
    ``kv_quantize``    int8 per-entry K/V with f32 scales,
    ``seed``           seed of the session's device generator (the sampled
                       path's draws; greedy sessions draw nothing),
    ``max_branches``   > 0: tree speculation on the (γ_max, max_branches)
                       grid step, with the window policy's per-round branch
                       width b ≤ the bound (``WindowDecision.branches``); 0
                       keeps the linear chain. ``max_branches=1`` is the
                       degenerate tree: the linear path's tokens. Greedy,
                       attention families, dense KV.
    """

    def __init__(self, engine, capacity: int, max_new_cap: int,
                 max_prompt_len: Optional[int] = None,
                 gamma_max: Optional[int] = None,
                 sync_every: Optional[int] = None,
                 eos_id: int = -1, log_gamma: bool = True,
                 mode_policy: str = "auto", pair_key: str = "engine",
                 paged: bool = False, kv_block_size: int = 16,
                 kv_pool_blocks=None, kv_quantize: bool = False,
                 transport=None, max_branches: int = 0, seed: int = 0):
        # ---- tree speculation (core/tree.py), the reference's gates ------
        self.max_branches = int(max_branches or 0)
        if self.max_branches:
            if mode_policy == "pipeline":
                raise ValueError(
                    "tree speculation does not compose with pipeline mode "
                    "(one in-flight window shape per exchange)")
            if engine.temperature > 0.0:
                raise ValueError("tree speculation is greedy-only "
                                 "(temperature 0)")
            if not all(c.arch_type in ATTENTION_FAMILIES
                       for c in (engine.draft_cfg, engine.target_cfg)):
                raise ValueError("tree speculation needs attention-family "
                                 "draft and target")
            if paged:
                raise ValueError(
                    "tree speculation needs dense KV slots (the winning-"
                    "path relocation is pos_map surgery on dense rows)")
        self._branches_eff = 1
        self._branches_prev = 1.0
        if transport is not None or mode_policy == "pipeline":
            raise NotImplementedError(
                "transports and pipelined rounds (the distributed draft/"
                "target split) come with ROADMAP item A9")
        self.engine = engine
        self.device = engine.device
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        self.capacity = int(capacity)
        self.max_new_cap = int(max_new_cap)
        self.max_prompt_len = (None if max_prompt_len is None
                               else int(max_prompt_len))
        if gamma_max:
            self.gamma_max = int(gamma_max)
        elif engine.gamma_max:
            self.gamma_max = engine.gamma_max
        else:
            self.gamma_max = DEFAULT_GAMMA_MAX
        self.sync_every = max(1, int(sync_every or engine.sync_every))
        self.eos_id = -1 if eos_id is None else int(eos_id)
        if mode_policy not in ("auto", "distributed", "fused"):
            raise ValueError(f"unknown mode_policy {mode_policy!r}")
        self.mode_policy = mode_policy
        # the key this session presents to the window policy (adaptive
        # policies keep one stabilizer per draft–target pair)
        self.pair_key = str(pair_key)

        # ---- paged KV slot pool (models/kvcache.PagedAttnCache) ---------
        self.paged = bool(paged)
        self.kv_block_size = int(kv_block_size)
        self.kv_pool_blocks = kv_pool_blocks
        self.kv_quantize = bool(kv_quantize)
        self._alloc: dict[str, Optional[BlockAllocator]] = {
            "draft": None, "target": None}
        self._slot_blocks: list[Optional[dict]] = [None] * self.capacity

        self.slots_len = (None if self.max_prompt_len is None
                          else self._cache_len(self.max_prompt_len))
        self._state: Optional[SpecDecodeState] = None
        self._slots: list[Optional[SlotRecord]] = [None] * self.capacity
        self._out_buf = None
        self._cursor = None
        self._max_new = None
        self._done = None
        self._nacc = None
        self._nn = None

        # engine-wide accounting / window-policy features (bounded lists)
        self.iterations = 0
        self.proposed = 0
        self.accepted = 0
        self.prefill_s = 0.0
        self.decode_wall_s = 0.0
        self.virtual_ms = 0.0
        self.log_gamma = bool(log_gamma)
        self.gamma_seq: list[int] = []
        self.gamma_sum = 0
        self.gamma_rounds = 0
        self.fused_iterations = 0
        self._alpha_recent: list[float] = []
        self._tpot_recent: list[float] = []
        self._gamma_prev = 4.0

    # ------------------------------------------------------------- geometry

    def _cache_len(self, prompt_len: int) -> int:
        if self.max_branches:
            # tree rounds write the whole grid past the high-water mark:
            # anchor + γ_max·b_max entries at slots pos .. pos+T−1
            return (prompt_len + self.max_new_cap + self.gamma_max
                    + 1 + self.gamma_max * self.max_branches + 18)
        # 2× the window bound, as the reference sizes every mode (its
        # pipelined rounds write up to γ_max past the half-duplex mark)
        return prompt_len + self.max_new_cap + 2 * self.gamma_max + 18

    def _n_logical(self) -> int:
        """Block-table width: logical blocks covering one slot's length."""
        return logical_blocks(self.slots_len, self.kv_block_size)

    def blocks_needed(self, prompt_len: int, max_new: int) -> int:
        """Blocks one request must reserve on each paged side: its prompt
        + clamped budget + speculative-window overhang (2γ + 2). Writes
        past the reservation are stale speculation and drop harmlessly."""
        need = min(self.slots_len,
                   int(prompt_len) + min(int(max_new), self.max_new_cap)
                   + 2 * self.gamma_max + 2)
        return logical_blocks(need, self.kv_block_size)

    def _pool_blocks(self, side: str) -> int:
        n = self.kv_pool_blocks
        if isinstance(n, dict):
            n = n.get(side)
        return int(n) if n else self.capacity * self._n_logical()

    def free_kv_blocks(self) -> Optional[int]:
        """Min free blocks across paged sides (None for dense sessions)."""
        if not self.paged:
            return None
        self._ensure_state()
        return min(a.free_blocks for a in self._alloc.values()
                   if a is not None)

    def can_admit(self, prompt_len: int, max_new: int) -> bool:
        """True when a free slot AND (paged) every side's reservation
        fits — the block-aware admission predicate serving uses."""
        if not self.free:
            return False
        if not self.paged:
            return True
        self._ensure_state()
        need = self.blocks_needed(prompt_len, max_new)
        return all(a is None or a.free_blocks >= need
                   for a in self._alloc.values())

    def _init_buffers(self) -> None:
        B, dev = self.capacity, self.device
        i32 = dict(dtype=torch.int32, device=dev)
        # one column past max_new_cap: the drop sink of _accumulate
        self._out_buf = torch.full((B, self.max_new_cap + 1), -1, **i32)
        self._cursor = torch.zeros((B,), **i32)
        self._max_new = torch.zeros((B,), **i32)
        self._done = torch.ones((B,), dtype=torch.bool, device=dev)
        self._nacc = torch.zeros((self.sync_every, B), **i32)
        self._nn = torch.zeros((self.sync_every, B), **i32)
        # per-round scalars as preallocated device tensors: indexing them
        # with a host int launches nothing and copies nothing
        self._gamma_tab = torch.arange(self.gamma_max + 1, **i32)
        self._branch_tab = torch.arange(self.max_branches + 1, **i32)
        self._row_tab = torch.arange(self.sync_every, dtype=torch.long,
                                     device=dev)
        self._eos = torch.full((), self.eos_id, **i32)

    def _ensure_state(self) -> None:
        """Lazily build an all-free device state for per-slot admission."""
        if self._state is not None:
            return
        eng = self.engine
        assert self.max_prompt_len is not None, \
            "per-slot admission needs max_prompt_len at session creation"

        def make_cache(model, side):
            if self.paged:
                n_blocks = self._pool_blocks(side)
                self._alloc[side] = BlockAllocator(n_blocks)
                return model.init_paged_cache(
                    self.capacity, self.slots_len, n_blocks,
                    self.kv_block_size, quantize=self.kv_quantize)
            return model.init_cache(self.capacity, self.slots_len)

        zeros = torch.zeros((self.capacity,), dtype=torch.int32,
                            device=self.device)
        self._state = SpecDecodeState(
            draft_cache=make_cache(eng.draft, "draft"),
            target_cache=make_cache(eng.target, "target"),
            last_token=zeros.clone(), pos=zeros.clone())
        self._init_buffers()

    # ------------------------------------------------------------ occupancy

    @property
    def occupied(self) -> list[int]:
        return [j for j, r in enumerate(self._slots) if r is not None]

    @property
    def free(self) -> list[int]:
        return [j for j, r in enumerate(self._slots) if r is None]

    @property
    def unfinished(self) -> bool:
        return any(r is not None and not r.done for r in self._slots)

    def finished_slots(self) -> list[int]:
        return [j for j, r in enumerate(self._slots)
                if r is not None and r.done]

    @property
    def mean_gamma(self) -> float:
        """Mean effective γ over distributed rounds."""
        return (self.gamma_sum / self.gamma_rounds if self.gamma_rounds
                else 0.0)

    # ------------------------------------------------------------- admission

    def admit_batch(self, prompts: np.ndarray, max_new,
                    prompt_lens: Optional[np.ndarray] = None,
                    request_ids: Optional[Sequence[int]] = None) -> list[int]:
        """Admit one full wave into a FRESH session via batched prefill
        (the ``generate()`` path). ``max_new`` may be a scalar or a
        per-slot vector."""
        assert self._state is None and not self.occupied, \
            "admit_batch only fills a fresh session; use admit() for " \
            "in-flight admission"
        assert not self.paged, \
            "paged sessions admit per-slot (block reservations are " \
            "per-request); use admit()"
        prompts = np.asarray(prompts, np.int32)
        B, S = prompts.shape
        assert B == self.capacity, (B, self.capacity)
        if self.max_prompt_len is not None:
            assert S <= self.max_prompt_len, (S, self.max_prompt_len)
            if S < self.max_prompt_len:
                if prompt_lens is None:
                    prompt_lens = np.full((B,), S, np.int32)
                prompts = np.pad(prompts,
                                 ((0, 0), (0, self.max_prompt_len - S)))
        else:
            self.slots_len = self._cache_len(S)

        t0 = time.perf_counter()
        dev = self.device
        pl = (None if prompt_lens is None
              else torch.as_tensor(np.asarray(prompt_lens, np.int32),
                                   device=dev))
        state = self.engine._prefill(torch.as_tensor(prompts, device=dev),
                                     self.slots_len, prompt_lens=pl,
                                     generator=self._gen)
        self._init_buffers()
        mn = np.minimum(np.broadcast_to(np.asarray(max_new), (B,)),
                        self.max_new_cap).astype(np.int32)
        self._max_new = torch.as_tensor(mn, device=dev)
        self._done = torch.zeros((B,), dtype=torch.bool, device=dev)
        self._cursor = torch.ones((B,), dtype=torch.int32, device=dev)
        self._out_buf[:, 0] = state.last_token
        self._state = state
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.prefill_s = time.perf_counter() - t0
        ids = list(request_ids) if request_ids is not None else list(range(B))
        self._slots = [SlotRecord(request_id=ids[j], max_new=int(mn[j]),
                                  admit_it=self.iterations)
                       for j in range(B)]
        return list(range(B))

    def admit(self, prompt: np.ndarray, max_new: int,
              request_id: int = 0) -> int:
        """Admit one request into the first free slot of a LIVE session:
        the prompt (right-padded to ``max_prompt_len``) is prefilled at
        batch size 1 and its cache row, anchor token and lifecycle entries
        go into that slot. The request's first token exists when this
        returns (per-request TTFT ends here)."""
        free = self.free
        if not free:
            raise RuntimeError("no free slot; retire a finished request first")
        j = free[0]
        self._ensure_state()
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        P = self.max_prompt_len
        assert 1 <= prompt.size <= P, (prompt.size, P)
        padded = np.zeros((1, P), np.int32)
        padded[0, :prompt.size] = prompt
        budget = min(int(max_new), self.max_new_cap)
        dev = self.device
        args = (self._state, self._out_buf, self._cursor, self._max_new,
                self._done, torch.as_tensor(padded, device=dev),
                torch.tensor([prompt.size], dtype=torch.int32, device=dev),
                j, budget)
        if self.paged:
            blocks = self._reserve_blocks(prompt.size, budget)
            insert = self.engine._insert_step_paged(
                self.capacity, self.slots_len, P,
                blocks["draft"].shape[0], blocks["target"].shape[0])
            insert(*args, torch.as_tensor(blocks["draft"], device=dev),
                   torch.as_tensor(blocks["target"], device=dev),
                   generator=self._gen)
            self._slot_blocks[j] = {
                s: [int(i) for i in ids if i >= 0]
                for s, ids in blocks.items() if ids.size}
        else:
            insert = self.engine._insert_step(self.capacity, self.slots_len,
                                              P)
            insert(*args, generator=self._gen)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self._slots[j] = SlotRecord(request_id=request_id, max_new=budget,
                                    admit_it=self.iterations)
        return j

    def _reserve_blocks(self, prompt_len: int, budget: int
                        ) -> dict[str, np.ndarray]:
        """Reserve each paged side's blocks for one admission, all-or-
        nothing. Returns per-side block-id rows padded to the full table
        width with −1 (unreserved tail)."""
        need = self.blocks_needed(prompt_len, budget)
        n_log = self._n_logical()
        for side, a in self._alloc.items():
            if a is not None and a.free_blocks < need:
                raise RuntimeError(
                    f"insufficient free KV blocks on {side}: need {need}, "
                    f"{a.free_blocks} free of {a.n_blocks} — retire "
                    f"finished requests or grow kv_pool_blocks")
        out = {}
        for side, a in self._alloc.items():
            row = np.full((n_log,), -1, np.int32)
            row[:need] = a.alloc(need)
            out[side] = row
        return out

    # -------------------------------------------------------------- decode

    def _decide(self, policy, q_depth: float) -> tuple[int, bool]:
        """One window-policy decision → (effective γ, fused?). A fused round
        runs with effective γ = 0: the masked window accepts nothing and the
        target's own next token is committed."""
        dec = policy.decide(self.pair_key, self._features(q_depth))
        if self.mode_policy == "fused":
            fused = True
        elif self.mode_policy == "distributed":
            fused = False
        else:
            fused = dec.mode == "fused"
        gamma_eff = 0 if fused else min(self.gamma_max, max(1, int(dec.gamma)))
        # tree sessions honor the decision's branch width, clamped to the
        # bound; a fused round (γ = 0) and linear sessions run b = 1
        if self.max_branches and not fused:
            self._branches_eff = min(self.max_branches,
                                     max(1, int(getattr(dec, "branches", 1))))
        else:
            self._branches_eff = 1
        self._branches_prev = float(self._branches_eff)
        if self.log_gamma:
            self.gamma_seq.append(1 if fused else gamma_eff)
        if fused:
            self.fused_iterations += 1
        else:
            self.gamma_sum += gamma_eff
            self.gamma_rounds += 1
        self._gamma_prev = 1.0 if fused else float(gamma_eff)
        return gamma_eff, fused

    def run_chunk(self, policy, max_iters: Optional[int] = None,
                  q_depth: float = 0.0) -> int:
        """Dispatch up to ``sync_every`` speculation rounds with no host
        sync between them, then sync the host once: cursors/done flags come
        off the device, acceptance bits are attributed to the request in
        each slot and the window-policy features update. Returns the number
        of rounds run."""
        n = self.sync_every
        if max_iters is not None:
            n = min(n, max_iters - self.iterations)
        if n <= 0 or not self.occupied:
            return 0
        eng = self.engine
        tree = bool(self.max_branches)
        if tree:
            step = eng._tree_step(self.gamma_max, self.max_branches)
        else:
            step = functools.partial(eng._fused_step(self.gamma_max),
                                     generator=self._gen)
        chunk_t0 = time.perf_counter()
        chunk_gammas: list[int] = []
        with no_host_sync(self.device):
            for r in range(n):
                gamma, _fused = self._decide(policy, q_depth)
                chunk_gammas.append(gamma)
                # a tree round's b rides between γ and the row index
                shape = ((self._gamma_tab[gamma],
                          self._branch_tab[self._branches_eff]) if tree
                         else (self._gamma_tab[gamma],))
                self._state = step(self._state, *shape, self._row_tab[r],
                                   self._out_buf, self._cursor, self._nacc,
                                   self._nn, self._max_new, self._done,
                                   self._eos)
                self.iterations += 1
        self._sync_and_attribute(n, chunk_gammas, chunk_t0,
                                 colocated_rtt_ms=eng.rtt_ms)
        return n

    def _sync_and_attribute(self, n: int, chunk_gammas: list[int],
                            chunk_t0: float,
                            colocated_rtt_ms: float = 0.0) -> None:
        """Chunk epilogue: one host transfer of cursors/flags/stat rows,
        per-request acceptance attribution, window-policy feature update.
        ``chunk_gammas`` holds the EFFECTIVE per-round γ (0 for fused
        rounds, whose commits enter token counts but not acceptance stats).
        The colocated path is billed one virtual RTT per distributed round
        plus the per-token amortized stream flush for fused commits."""
        cur = self._cursor.cpu().numpy()
        done = self._done.cpu().numpy()
        nacc = self._nacc[:n].cpu().numpy()
        nn = self._nn[:n].cpu().numpy()
        # wall time after the blocking transfers: the rounds were enqueued
        # asynchronously and finish here
        chunk_wall = time.perf_counter() - chunk_t0

        for r in range(n):
            act = nn[r] > 0
            n_act = int(act.sum())
            if n_act and chunk_gammas[r] > 0:
                self._alpha_recent.append(
                    float(nacc[r][act].sum()) / (chunk_gammas[r] * n_act))
                self.proposed += chunk_gammas[r] * n_act
        self.accepted += int(nacc.sum())

        chunk_tokens = 0
        for j, rec in enumerate(self._slots):
            if rec is None:
                continue
            for r in range(n):
                ne = int(nn[r, j])
                if ne > 0 and chunk_gammas[r] > 0:
                    # a reject bit exists only when a correction token was
                    # committed (num_new beyond the accepted prefix without
                    # the window being fully accepted)
                    na = int(nacc[r, j])
                    rec.bits.extend([1] * na)
                    if ne > na and na < chunk_gammas[r]:
                        rec.bits.append(0)
                    rec.proposed += chunk_gammas[r]
                    rec.accepted += na
            chunk_tokens += int(cur[j]) - rec.produced
            rec.produced = int(cur[j])
            rec.done = bool(done[j])

        active_iters = int((nn > 0).sum())
        mean_tok = chunk_tokens / max(1, active_iters)
        compute_ms = max(0.0, chunk_wall * 1e3)
        self._tpot_recent.append((compute_ms / n) / max(1.0, mean_tok))
        del self._alpha_recent[:-16], self._tpot_recent[:-16]
        virtual_extra_ms = 0.0
        if colocated_rtt_ms > 0.0:
            n_dist = sum(1 for g in chunk_gammas if g > 0)
            fused_tokens = int(sum(nn[r].sum() for r in range(n)
                                   if chunk_gammas[r] == 0))
            virtual_extra_ms = colocated_rtt_ms * (
                n_dist + fused_tokens / FUSED_FLUSH_TOKENS)
        self.virtual_ms += virtual_extra_ms + chunk_wall * 1e3
        self.decode_wall_s += chunk_wall

    def _features(self, q_depth: float) -> FeatureSnapshot:
        a = self._alpha_recent[-16:]
        t = self._tpot_recent[-16:]
        return FeatureSnapshot(
            q_depth=q_depth,
            alpha_recent=(sum(a) / len(a)) if a else 0.7,
            rtt_recent_ms=self.engine.rtt_ms,
            tpot_recent_ms=(sum(t) / len(t)) if t else 50.0,
            gamma_prev=self._gamma_prev,
            pipe_hit_recent=0.0, branches_prev=self._branches_prev)

    # ------------------------------------------------------------ retirement

    def retire(self, slot: int, scrub: bool = False
               ) -> tuple[np.ndarray, SlotRecord]:
        """Extract a slot's committed tokens (one row transfer, length from
        the per-slot cursor) and free the slot. The device row stays inert
        (``done`` masks it) until the next admission overwrites it;
        ``scrub=True`` also resets the row's dense caches."""
        rec = self._slots[slot]
        assert rec is not None, f"slot {slot} is empty"
        n = min(rec.produced, self.max_new_cap)
        tokens = self._out_buf[slot, :n].cpu().numpy().astype(np.int64)
        self._slots[slot] = None
        if self.paged and self._slot_blocks[slot] is not None:
            # unmap BEFORE freeing: the frozen slot still writes its masked
            # speculative window every round, and the device stream orders
            # this release ahead of any later insert that reuses the blocks
            self.engine._release_step()(self._state, slot)
            for side, ids in self._slot_blocks[slot].items():
                self._alloc[side].free(ids)
            self._slot_blocks[slot] = None
        if scrub:
            reset_slot(self._state.draft_cache, slot)
            reset_slot(self._state.target_cache, slot)
        return tokens, rec

    # -------------------------------------------------------------- extract

    def snapshot(self) -> tuple[np.ndarray, GenerationStats]:
        """Wave-style extraction: the full output buffer plus engine-schema
        stats over currently-occupied slots (the ``generate()`` epilogue)."""
        tokens = (self._out_buf[:, :self.max_new_cap].cpu().numpy()
                  .astype(np.int64) if self._out_buf is not None
                  else np.empty((self.capacity, 0), np.int64))
        produced = np.array([r.produced if r else 0 for r in self._slots],
                            np.int64)
        n_occ = len(self.occupied)
        stats = GenerationStats(
            iterations=self.iterations, proposed=self.proposed,
            accepted=self.accepted,
            tokens=int(produced.sum()) - n_occ,
            prefill_s=self.prefill_s, virtual_ms=self.virtual_ms,
            acceptance_seqs=[r.bits for r in self._slots if r is not None],
            gamma_seq=list(self.gamma_seq), produced=produced)
        return tokens, stats
