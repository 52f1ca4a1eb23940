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

On the card the session captures each of its steps once as a CUDA graph
(:mod:`.capture`): the round step at its first ``run_chunk`` and the insert
at its first ``admit`` run eagerly as the warm-up, their second call
captures and replays, every later round or admission only fills the step's
static inputs (γ, b and the stats row by a device-to-device copy; the
padded prompt, length, slot, budget and paged block rows by one host copy)
and replays. The capture call synchronizes the device, so it alone runs
outside the no-sync guard. ``capture=False`` keeps every step eager on the
card (the comparison); a CPU session runs them eagerly by the device rule
and refuses ``capture=True``. The wave prefill (``admit_batch``) and the
paged release stay eager: the first runs once per session, the second is
one block-table row fill.

The session owns one ``torch.Generator`` on its device, seeded from
``seed`` (the reference session's PRNG key). At temperature > 0 every
round and every admission draws from it on the device — the draft's
Gumbel noise, the verify's uniforms, the sampled anchor token — so a seed
fixes the committed tokens and no draw syncs the host.

The rounds run the engine's linear step for the pair (``_step_fn``: fused
for two attention models, split when a side is ssm or hybrid). With
``max_branches > 0`` they are tree-speculation rounds (the engine's
``_tree_step``; dense KV, greedy, attention families).

With a ``transport`` the rounds are HALF-DUPLEX draft→verify→verdict
exchanges between the engine's split workers (``distributed/workers.py``;
the reference's ``_run_chunk_transport``): the draft proposes, its window
crosses the transport as a :class:`~repro_torch.distributed.wire.WindowMsg`,
the target verifies THE WINDOW IT RECEIVED and commits, its
:class:`~repro_torch.distributed.wire.VerdictMsg` crosses back, and the
draft applies THE VERDICT IT RECEIVED (a recurrent draft re-advances by its
``num_new``, a tree draft relocates its grid by its ``path`` and
``n_accepted``). Over a socket the decoded bytes are what runs, so a codec
fault shows as a wrong token. A fused round (γ 0) runs the same verify
program with no window and the draft ingests the committed token; its
tokens stream edge-ward one control round trip per ``FUSED_FLUSH_TOKENS``.
Each worker program is a captured step of the session like the colocated
ones; a round's host crossings are exactly: the proposals (tree: the grid)
to the host, the received window to the device, the verdict (n_accepted,
num_new, next_token, last_token, done; path for trees) to the host in one
copy, and, for a recurrent or tree draft, the received verdict's fields
back to the device, all through pinned buffers; the device segments
between them run under ``no_host_sync``. The pipelined mode
(``mode_policy="pipeline"``) is the next slice of ROADMAP item A9.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..distributed.transport import Transport
from ..distributed.wire import TransportProtocolError, WindowMsg
from ..models.kvcache import BlockAllocator, logical_blocks, reset_slot
# fused-mode tokens stream edge-ward one control round trip per this many
# committed tokens — the same amortization the link model charges
from ..sim.network import DEFAULT_FUSED_CHUNK as FUSED_FLUSH_TOKENS
from .capture import CapturedStep
from .engine import DEFAULT_GAMMA_MAX, GenerationStats
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


class HostImage:
    """A host copy of one device buffer for a transport round's host
    crossings, pinned on the card so both directions queue on the stream
    without a sync: :meth:`fetch` queues the device-to-host copy,
    :meth:`wait` waits for it and returns the numpy view, :meth:`put`
    fills the image and queues the host-to-device copy. A round waits on
    each fetch before the host touches the image again, so a queued copy
    never reads a half-written image."""

    def __init__(self, dev: torch.Tensor):
        self.dev = dev
        cuda = dev.device.type == "cuda"
        self.host = torch.zeros(dev.shape, dtype=dev.dtype, pin_memory=cuda)
        self.np = self.host.numpy()
        self._event = torch.cuda.Event() if cuda else None

    def fetch(self) -> None:
        self.host.copy_(self.dev, non_blocking=True)
        if self._event is not None:
            self._event.record()

    def wait(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self.np

    def put(self, values) -> None:
        self.np[...] = values
        self.dev.copy_(self.host, non_blocking=True)


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
                       ``"distributed"``/``"fused"`` force one mode
                       (``"pipeline"``: the next slice of ROADMAP A9),
    ``transport``      a :class:`repro_torch.distributed.Transport`: the
                       rounds run as draft→verify→verdict exchanges between
                       the engine's split workers over it (colocated steps
                       otherwise); sampled rounds need a pass-through
                       transport (in-process or emulated link: the draft
                       distributions stay on the device),
    ``paged``          KV in a paged block pool: admission reserves only the
                       blocks a request's ``prompt + budget + 2γ`` footprint
                       needs and retirement frees them; greedy tokens equal
                       the dense layout's (``kv_quantize=False``). Only the
                       attention-family sides page (recurrent state has no
                       positions); a paged session needs one such side,
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
                       attention families, dense KV,
    ``capture``        replay each step from a CUDA graph captured once
                       (None: on the card, not on the CPU); ``False`` on
                       the card runs every step eagerly; ``True`` on the
                       CPU raises.
    """

    def __init__(self, engine, capacity: int, max_new_cap: int,
                 max_prompt_len: Optional[int] = None,
                 gamma_max: Optional[int] = None,
                 sync_every: Optional[int] = None,
                 eos_id: int = -1, log_gamma: bool = True,
                 mode_policy: str = "auto", pair_key: str = "engine",
                 paged: bool = False, kv_block_size: int = 16,
                 kv_pool_blocks=None, kv_quantize: bool = False,
                 transport=None, max_branches: int = 0, seed: int = 0,
                 capture: Optional[bool] = None):
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
            if not all(c.has_attention_cache
                       for c in (engine.draft_cfg, engine.target_cfg)):
                raise ValueError("tree speculation needs attention-family "
                                 "draft and target")
            if paged:
                raise ValueError(
                    "tree speculation needs dense KV slots (the winning-"
                    "path relocation is pos_map surgery on dense rows)")
        self._branches_eff = 1
        self._branches_prev = 1.0
        if mode_policy == "pipeline":
            raise NotImplementedError(
                "the pipelined mode (window k+1 drafted while window k is "
                "verified) is the next slice of ROADMAP item A9; the "
                "half-duplex transport rounds run with mode_policy auto, "
                "distributed or fused")
        if transport is not None and not isinstance(transport, Transport):
            raise TypeError(f"transport must be a repro_torch.distributed."
                            f"Transport, got {type(transport).__name__}")
        self.transport = transport
        self.engine = engine
        self.device = engine.device
        on_card = self.device.type == "cuda"
        if capture and not on_card:
            raise ValueError("graph capture runs on the card; a CPU session "
                             "runs its steps eagerly (capture=None/False)")
        self.capture = on_card if capture is None else bool(capture)
        self._side = torch.cuda.Stream(self.device) if self.capture else None
        self._round: Optional[CapturedStep] = None
        self._insert: Optional[CapturedStep] = None
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
        self._paged_sides = {"draft": engine.draft_cfg.pageable,
                             "target": engine.target_cfg.pageable}
        if self.paged and not any(self._paged_sides.values()):
            raise ValueError(
                "paged sessions need at least one attention-family side "
                "(recurrent state has no positions to page)")
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
        self._tree_counters = None

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
        self.link_ms = 0.0               # unhidden transport delay so far
        self.pipeline_hits = 0           # the pipelined mode's counters (0
        self.pipeline_misses = 0         # until that mode is ported)
        self.control_roundtrips = 0      # fused-mode stream flushes
        self._fused_pending = 0          # fused tokens since the last flush
        self._round_seq = 0              # wire round ids (RTT pairing)
        self._wire = None                # transport rounds' buffers, steps
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
        # per-round scalars: tables on the device, and the round step's
        # static inputs, filled from them by one device-to-device copy each
        self._gamma_tab = torch.arange(self.gamma_max + 1, **i32)
        self._branch_tab = torch.arange(self.max_branches + 1, **i32)
        self._row_tab = torch.arange(self.sync_every, dtype=torch.long,
                                     device=dev)
        self._gamma_in = torch.zeros((), **i32)
        self._branch_in = torch.zeros((), **i32)
        self._row_in = torch.zeros((), dtype=torch.long, device=dev)
        self._eos = torch.full((), self.eos_id, **i32)
        # the tree verdict's per-row counters (tree_verify_fused): zeroed
        # once here, left at zero by every launch, owned by this session
        self._tree_counters = (torch.zeros((B,), **i32)
                               if self.max_branches else None)

    def _ensure_state(self) -> None:
        """Lazily build an all-free device state for per-slot admission."""
        if self._state is not None:
            return
        eng = self.engine
        assert self.max_prompt_len is not None, \
            "per-slot admission needs max_prompt_len at session creation"

        def make_cache(model, side):
            if self.paged and self._paged_sides[side]:
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
        go into that slot, through the session's insert step. The request's
        first token exists when this returns (per-request TTFT ends here:
        on the card the host waits for this insert on the stream, not for
        the whole device)."""
        free = self.free
        if not free:
            raise RuntimeError("no free slot; retire a finished request first")
        j = free[0]
        self._ensure_state()
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        P = self.max_prompt_len
        assert 1 <= prompt.size <= P, (prompt.size, P)
        budget = min(int(max_new), self.max_new_cap)
        blocks = self._reserve_blocks(prompt.size, budget) if self.paged \
            else {}
        # the insert's static inputs in one host copy: padded prompt,
        # length, slot, budget, then each paged side's block row
        packed = np.zeros((P + 3,), np.int32)
        packed[:prompt.size] = prompt
        packed[P:] = (prompt.size, j, budget)
        packed = np.concatenate([packed, *blocks.values()])
        step = self._insert_step(tuple(b.shape[0] for b in blocks.values()))
        step(admission=torch.from_numpy(packed))
        if self.paged:
            self._slot_blocks[j] = {
                s: [int(i) for i in ids if i >= 0]
                for s, ids in blocks.items() if ids.size}
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        self._slots[j] = SlotRecord(request_id=request_id, max_new=budget,
                                    admit_it=self.iterations)
        return j

    def _captured(self, body, inputs: dict) -> CapturedStep:
        """A step of this session: its graph is captured on this session's
        buffers (at temperature > 0 with the session's generator)."""
        sampled = self.engine.temperature > 0.0
        return CapturedStep(body, inputs, self.engine.graphs,
                            capture=self.capture, stream=self._side,
                            generator=self._gen if sampled else None)

    def _insert_step(self, n_blocks: tuple) -> CapturedStep:
        """The session's insert step (built at the first ``admit``): the
        engine's dense or paged prefill-insert on this session's state and
        lifecycle buffers, reading its inputs from views of one int32
        device buffer (``n_blocks``: each paged side's block-row width)."""
        if self._insert is None:
            eng, P = self.engine, self.max_prompt_len
            buf = torch.zeros((P + 3 + sum(n_blocks),), dtype=torch.int32,
                              device=self.device)
            args = (self._state, self._out_buf, self._cursor, self._max_new,
                    self._done, buf[:P].view(1, P), buf[P:P + 1],
                    buf[P + 1:P + 2], buf[P + 2:P + 3])
            gen = self._gen
            if self.paged:
                d, t = n_blocks
                fn = eng._insert_step_paged(self.capacity, self.slots_len, P,
                                            d, t)
                rows = (buf[P + 3:P + 3 + d], buf[P + 3 + d:])
                body = lambda: fn(*args, *rows, generator=gen)
            else:
                fn = eng._insert_step(self.capacity, self.slots_len, P)
                body = lambda: fn(*args, generator=gen)
            self._insert = self._captured(body, {"admission": buf})
        return self._insert

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
            if a is None:                     # an unpaged (recurrent) side
                out[side] = np.zeros((0,), np.int32)
                continue
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
        of rounds run. With a transport the rounds are half-duplex
        exchanges (:meth:`_run_chunk_transport`)."""
        if self.transport is not None:
            return self._run_chunk_transport(policy, max_iters, q_depth)
        n = self.sync_every
        if max_iters is not None:
            n = min(n, max_iters - self.iterations)
        if n <= 0 or not self.occupied:
            return 0
        step = self._round_step()
        chunk_t0 = time.perf_counter()
        chunk_gammas: list[int] = []
        for r in range(n):
            gamma, _fused = self._decide(policy, q_depth)
            chunk_gammas.append(gamma)
            inputs = {"gamma": self._gamma_tab[gamma],
                      "row": self._row_tab[r]}
            if self.max_branches:
                inputs["branches"] = self._branch_tab[self._branches_eff]
            self._segment(step, **inputs)
            self.iterations += 1
        self._sync_and_attribute(n, chunk_gammas, chunk_t0,
                                 colocated_rtt_ms=self.engine.rtt_ms)
        return n

    def _round_step(self) -> CapturedStep:
        """The session's round step (built at the first chunk): the engine's
        tree step, or its linear step for the pair, on this session's state
        and buffers, reading γ, b and the stats row from the static round
        inputs."""
        if self._round is None:
            eng, st = self.engine, self._state
            bufs = (self._out_buf, self._cursor, self._nacc, self._nn,
                    self._max_new, self._done, self._eos)
            ins = {"gamma": self._gamma_in, "row": self._row_in}
            if self.max_branches:
                fn = eng._tree_step(self.gamma_max, self.max_branches)
                ins["branches"] = self._branch_in
                counters = self._tree_counters
                body = lambda: fn(st, ins["gamma"], ins["branches"],
                                  ins["row"], *bufs, counters=counters)
            else:
                fn = eng._step_fn(self.gamma_max)
                gen = self._gen
                body = lambda: fn(st, ins["gamma"], ins["row"], *bufs,
                                  generator=gen)
            self._round = self._captured(body, ins)
        return self._round

    def _segment(self, step: CapturedStep, *, before=(), after=(),
                 **inputs) -> None:
        """One device segment: the host-to-device copies ``before``, the
        step, the device-to-host copies ``after``, all queued under
        ``no_host_sync``. A capture synchronizes the device on entry: the
        one call per step that captures runs outside the guard."""
        with (contextlib.nullcontext() if step.captures_next
              else no_host_sync(self.device)):
            for f in before:
                f()
            step(**inputs)
            for f in after:
                f()

    # ------------------------------------------------- transport rounds

    def _wire_init(self) -> None:
        """The split rounds' buffers (built at the first transport chunk):
        the draft's linear window (and tree window), the target's received
        window inputs, the verdict buffers, and a pinned host image of each
        buffer a round copies across."""
        if self._wire is not None:
            return
        from ..distributed.workers import DraftWindow, VerdictBuffer
        eng, B, G, dev = self.engine, self.capacity, self.gamma_max, \
            self.device
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.int32,
                                           device=dev)
        w = {"linear": DraftWindow.empty(
                 B, G, dev, vocab=eng.draft_cfg.vocab,
                 sampled=eng.temperature > 0.0),
             "verdict": VerdictBuffer(B, 0, dev),
             "tokens_in": zeros(B, G)}
        if self.max_branches:
            T = eng._tree_spec(G, self.max_branches).n_entries
            w.update(tree=DraftWindow.empty(B, T, dev, d_max=G),
                     tree_verdict=VerdictBuffer(B, G, dev),
                     grid_in=zeros(B, T))
        host = {"proposals": w["linear"].tokens,
                "received": w["linear"].received,
                "tokens_in": w["tokens_in"], "verdict": w["verdict"].flat}
        if self.max_branches:
            host.update(grid=w["tree"].tokens,
                        tree_received=w["tree"].received,
                        grid_in=w["grid_in"],
                        tree_verdict=w["tree_verdict"].flat)
        w["host"] = {k: HostImage(v) for k, v in host.items()}
        w["steps"] = {}
        self._wire = w

    def _worker_step(self, name: str) -> CapturedStep:
        """The session's captured step of one worker program (built at its
        first call), bound to the session's state and buffers: ``propose``,
        ``verify``, ``advance``, ``ingest``, ``propose_tree``,
        ``verify_tree``, ``ingest_tree``."""
        steps = self._wire["steps"]
        if name in steps:
            return steps[name]
        # the bodies close over tensors and buffer objects, never over the
        # session or the wire dict that holds the steps (no reference cycle)
        eng, st, w, G = self.engine, self._state, self._wire, self.gamma_max
        dw, tw = eng.split_workers()
        gen = self._gen
        bufs = (self._out_buf, self._cursor, self._nacc, self._nn,
                self._max_new, self._done, self._eos)
        ins: dict = {}
        lin, verdict, tokens_in = w["linear"], w["verdict"], w["tokens_in"]
        if name == "propose":
            fn = dw.propose(G)
            body = lambda: fn(st.draft_cache, st.last_token, st.pos, lin,
                              generator=gen)
        elif name == "verify":
            fn = tw.verify_commit(G)
            ins = {"gamma": self._gamma_in, "row": self._row_in}
            body = lambda: fn(st, tokens_in, lin.q_probs, ins["gamma"],
                              ins["row"], *bufs, verdict, generator=gen)
        elif name == "advance":
            fn = dw.advance(G)
            body = lambda: fn(st.draft_cache, lin)
        elif name == "ingest":
            fn = dw.ingest()
            body = lambda: fn(st.draft_cache, verdict.anchor, verdict.pos,
                              verdict.num_new)
        elif name == "propose_tree":
            fn, win = dw.propose_tree(G, self.max_branches), w["tree"]
            body = lambda: fn(st.draft_cache, st.last_token, st.pos, win)
        elif name == "verify_tree":
            fn = tw.verify_commit_tree(G, self.max_branches)
            ins = {"gamma": self._gamma_in, "branches": self._branch_in,
                   "row": self._row_in}
            grid_in, tverdict = w["grid_in"], w["tree_verdict"]
            counters = self._tree_counters
            body = lambda: fn(st, grid_in, ins["gamma"], ins["branches"],
                              ins["row"], *bufs, tverdict, counters=counters)
        elif name == "ingest_tree":
            fn, win = dw.ingest_tree(G, self.max_branches), w["tree"]
            body = lambda: fn(st.draft_cache, win)
        else:
            raise KeyError(name)
        steps[name] = self._captured(body, ins)
        return steps[name]

    def _exchange(self, msg: WindowMsg):
        """Post ``msg``, receive the window on the target side; returns
        (received window, unhidden link ms)."""
        tr = self.transport
        tr.post_window(msg)
        got, waited = tr.recv_window()
        if (got.round_id != msg.round_id
                or np.shape(got.tokens) != msg.tokens.shape):
            raise TransportProtocolError(
                f"received window {got.round_id} of shape "
                f"{np.shape(got.tokens)}, sent {msg.round_id} of shape "
                f"{msg.tokens.shape}")
        if msg.q_probs is not None and got.q_probs is not msg.q_probs:
            # the target's verify reads the draft's distributions where
            # they lie; a transport must hand that tensor through
            raise TransportProtocolError(
                "the window's q_probs did not pass through the transport")
        return got, waited

    def _return(self, verdict):
        """Post the target's verdict, receive it on the draft side; returns
        (received verdict, unhidden link ms)."""
        tr = self.transport
        tr.post_verdict(verdict)
        got, waited = tr.recv_verdict()
        if got.round_id != verdict.round_id:
            raise TransportProtocolError(
                f"received verdict {got.round_id}, sent {verdict.round_id}")
        return got, waited

    def _linear_round(self, r: int, gamma: int, n_active: int):
        """One distributed linear round; returns (received verdict, link ms,
        draft ms)."""
        from ..distributed.workers import DraftWindow
        w, h = self._wire, self._wire["host"]
        lin = w["linear"]
        t0 = time.perf_counter()
        self._segment(self._worker_step("propose"),
                      after=[h["proposals"].fetch])
        tokens = h["proposals"].wait().copy()
        draft_ms = (time.perf_counter() - t0) * 1e3
        rid = self._round_seq
        self._round_seq += 1
        msg = WindowMsg(tokens=tokens, gamma=gamma, n_active=n_active,
                        q_probs=lin.q_probs, round_id=rid)
        got, link_ms = self._exchange(msg)
        self._segment(self._worker_step("verify"),
                      before=[lambda: h["tokens_in"].put(got.tokens)],
                      after=[h["verdict"].fetch],
                      gamma=self._gamma_tab[gamma], row=self._row_tab[r])
        verdict = w["verdict"].message(h["verdict"].wait(), gamma, n_active,
                                       rid)
        got_v, waited = self._return(verdict)
        if not self.engine._draft_attention:
            img = h["received"]
            DraftWindow.pack_received(got_v, img.np)
            self._segment(self._worker_step("advance"),
                          before=[lambda: img.put(img.np)])
        return got_v, link_ms + waited, draft_ms

    def _tree_round(self, r: int, gamma: int, n_active: int):
        """One distributed tree round: the grid crosses with its parent
        table, the verdict carries the winning path back; returns (received
        verdict, link ms, draft ms)."""
        from ..distributed.workers import DraftWindow
        w, h = self._wire, self._wire["host"]
        b = self._branches_eff
        t0 = time.perf_counter()
        self._segment(self._worker_step("propose_tree"),
                      after=[h["grid"].fetch])
        grid = h["grid"].wait().copy()
        draft_ms = (time.perf_counter() - t0) * 1e3
        rid = self._round_seq
        self._round_seq += 1
        spec = self.engine._tree_spec(self.gamma_max, self.max_branches)
        msg = WindowMsg(tokens=grid, gamma=gamma, n_active=n_active,
                        round_id=rid, n_nodes=grid.shape[1], branches=b,
                        parent=spec.parent_np)
        got, link_ms = self._exchange(msg)
        self._segment(self._worker_step("verify_tree"),
                      before=[lambda: h["grid_in"].put(got.tokens)],
                      after=[h["tree_verdict"].fetch],
                      gamma=self._gamma_tab[gamma],
                      branches=self._branch_tab[b], row=self._row_tab[r])
        verdict = w["tree_verdict"].message(h["tree_verdict"].wait(), gamma,
                                            n_active, rid)
        got_v, waited = self._return(verdict)
        img = h["tree_received"]
        DraftWindow.pack_received(got_v, img.np)
        self._segment(self._worker_step("ingest_tree"),
                      before=[lambda: img.put(img.np)])
        return got_v, link_ms + waited, draft_ms

    def _fused_round(self, r: int) -> tuple[np.ndarray, float]:
        """One fused (cloud-only) round: the verify program at γ 0 commits
        the target's own next token (its window input zeroed, never read),
        the draft ingests the round's anchor so its cache stays coherent for
        a later distributed round, and tokens stream edge-ward one control
        round trip per ``FUSED_FLUSH_TOKENS`` committed tokens. Returns (the
        done flags, the unhidden link ms of the flushes)."""
        w, h = self._wire, self._wire["host"]
        self._segment(self._worker_step("verify"),
                      before=[w["tokens_in"].zero_],
                      gamma=self._gamma_tab[0], row=self._row_tab[r])
        self._segment(self._worker_step("ingest"),
                      after=[h["verdict"].fetch])
        rows = h["verdict"].wait()[:5 * self.capacity].reshape(5, -1)
        self._fused_pending += int(rows[1].sum())
        link_ms = 0.0
        while self._fused_pending >= FUSED_FLUSH_TOKENS:
            link_ms += self._flush()
            self._fused_pending -= FUSED_FLUSH_TOKENS
        return rows[4].astype(bool), link_ms

    def _flush(self) -> float:
        """One fused-mode control round trip; returns its unhidden ms."""
        self.control_roundtrips += 1
        return self.transport.control_roundtrip()

    def _run_chunk_transport(self, policy, max_iters: Optional[int],
                             q_depth: float) -> int:
        """Up to ``sync_every`` HALF-DUPLEX rounds over the transport (the
        reference's ``_run_chunk_transport``). A distributed round pays the
        link's delay both ways, a fused round skips the draft and both hops
        (:meth:`_fused_round`). The host syncs of a round are inherent —
        tokens must exist as bytes to cross a wire — so this path pays a
        full round trip of dead time per window; hiding it is the pipelined
        mode's job."""
        n = self.sync_every
        if max_iters is not None:
            n = min(n, max_iters - self.iterations)
        if n <= 0 or not self.occupied:
            return 0
        self._wire_init()
        B, tr = self.capacity, self.transport
        chunk_t0 = time.perf_counter()
        chunk_gammas: list[int] = []
        link_ms = draft_ms = 0.0
        # free slots and finished rows are inert: the host's records are
        # the device's done flags as of the last sync or admission
        done_host = np.array([rec is None or rec.done for rec in self._slots])
        it_run = 0
        for r in range(n):
            if done_host.all():
                break
            gamma, fused = self._decide(policy, q_depth)
            n_active = int(B - done_host.sum())
            if fused:
                done_host, ms = self._fused_round(r)
            else:
                round_fn = (self._tree_round if self.max_branches
                            else self._linear_round)
                verdict, ms, d_ms = round_fn(r, gamma, n_active)
                done_host = verdict.done
                draft_ms += d_ms
            link_ms += ms
            chunk_gammas.append(gamma)
            self.iterations += 1
            it_run += 1
        if it_run == 0:
            return 0
        if self._fused_pending and done_host.all():
            # the batch drained: flush the sub-chunk tail of fused tokens
            # (a session abandoned mid-stream drains it in snapshot())
            link_ms += self._flush()
            self._fused_pending = 0
        self.link_ms += link_ms
        # the TPOT feature tracks TARGET service time: the draft's proposal
        # time and the link delay come out (the delay only where the
        # transport slept it into wall time; a virtual clock gets it
        # instead)
        self._sync_and_attribute(
            it_run, chunk_gammas, chunk_t0,
            non_target_ms=draft_ms + (link_ms if tr.wall_clock else 0.0),
            virtual_extra_ms=0.0 if tr.wall_clock else link_ms)
        return it_run

    def _sync_and_attribute(self, n: int, chunk_gammas: list[int],
                            chunk_t0: float, non_target_ms: float = 0.0,
                            virtual_extra_ms: float = 0.0,
                            colocated_rtt_ms: float = 0.0) -> None:
        """Chunk epilogue: one host transfer of cursors/flags/stat rows,
        per-request acceptance attribution, window-policy feature update.
        ``chunk_gammas`` holds the EFFECTIVE per-round γ (0 for fused
        rounds, whose commits enter token counts but not acceptance stats).
        ``non_target_ms`` (slept link delay + measured draft proposal time)
        is kept out of the TPOT feature, which tracks target service time;
        the link shows in ``rtt_recent_ms`` instead. Virtual clock: the
        transport path passes its imposed-but-not-slept delay as
        ``virtual_extra_ms``; the colocated path is billed one
        ``colocated_rtt_ms`` per distributed round plus the per-token
        amortized stream flush for fused commits."""
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
        compute_ms = max(0.0, chunk_wall * 1e3 - non_target_ms)
        self._tpot_recent.append((compute_ms / n) / max(1.0, mean_tok))
        del self._alpha_recent[:-16], self._tpot_recent[:-16]
        if colocated_rtt_ms > 0.0:
            n_dist = sum(1 for g in chunk_gammas if g > 0)
            fused_tokens = int(sum(nn[r].sum() for r in range(n)
                                   if chunk_gammas[r] == 0))
            virtual_extra_ms += colocated_rtt_ms * (
                n_dist + fused_tokens / FUSED_FLUSH_TOKENS)
        self.virtual_ms += virtual_extra_ms + chunk_wall * 1e3
        self.decode_wall_s += chunk_wall

    def _features(self, q_depth: float) -> FeatureSnapshot:
        a = self._alpha_recent[-16:]
        t = self._tpot_recent[-16:]
        rtt = (self.transport.recent_rtt_ms if self.transport is not None
               else self.engine.rtt_ms)
        return FeatureSnapshot(
            q_depth=q_depth,
            alpha_recent=(sum(a) / len(a)) if a else 0.7,
            rtt_recent_ms=rtt,
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
        stats over currently-occupied slots (the ``generate()`` epilogue).
        Drains any sub-chunk tail of fused-mode tokens still pending stream
        delivery, so sessions that stop on the iteration bound pay the
        final control round trip too."""
        if self.transport is not None and self._fused_pending:
            self.link_ms += self._flush()
            self._fused_pending = 0
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
            gamma_seq=list(self.gamma_seq), produced=produced,
            pipeline_hits=self.pipeline_hits,
            pipeline_misses=self.pipeline_misses)
        return tokens, stats
