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

The device side of a session — caches, lifecycle and stats buffers, step
inputs, generator, transport buffers and the captured steps — is an
engine-owned :class:`~repro_torch.core.pool.SlotPool` of the session's
geometry (:meth:`DecodeSession._geometry`), leased when the session first
needs its state (the first ``admit``, or ``admit_batch``) and reset then,
and given back by :meth:`DecodeSession.close` (``generate``, a server's
``run`` and a host's wave close theirs; a ``with`` block does; a
``weakref.finalize`` gives back the pool of a session dropped unclosed).
A later session of the same geometry leases it again, so it replays the
graphs an earlier one captured. Two live sessions never share a pool.

On the card each step of a pool is captured once as a CUDA graph
(:mod:`.capture`): the round step at its first ``run_chunk`` and the insert
at its first ``admit`` run eagerly as the warm-up, their second call
captures and replays, every later round or admission — in this session or
a later one on the pool — only fills the step's static inputs (γ, b and
the stats row by a device-to-device copy; the padded prompt, length, slot,
budget and paged block rows by one host copy) and replays. The capture
call synchronizes the device, so it alone runs outside the no-sync guard.
``capture=False`` keeps every step eager on the card (the comparison); a
CPU session runs them eagerly by the device rule and refuses
``capture=True``. The wave prefill (``admit_batch``) and the paged release
stay eager: the first writes its prefill into the pool's buffers, the
second is one block-table row fill.

The pool's ``torch.Generator`` is re-seeded from the session's ``seed``
at the lease (the reference session's PRNG key). At temperature > 0 every
round and every admission draws from it on the device — the draft's
Gumbel noise, the verify's uniforms, the sampled anchor token — so a seed
fixes the committed tokens and no draw syncs the host.

Encoder-decoder and vlm pairs admit whole waves with their frontend
(``admit_batch(frontend=)``); per-slot admission refuses them, as the
reference does.

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
between them run under ``no_host_sync``.

With ``mode_policy="pipeline"`` the rounds are CROSS-ROUND PIPELINED
(:meth:`DecodeSession._run_chunk_pipeline`, the reference's
``_run_chunk_pipeline``): while window k's verdict is in flight the draft
proposes window k+1 from its own prediction of that verdict (every γ
proposal accepted, the reserved proposal γ as the bonus token, the host
mirror of ``slot_stop_mask`` for budget and EOS: :func:`predict_verdict`)
and posts it speculatively. A verdict equal to the prediction (num_new,
done, last_token) is a HIT and window k+1 is the next round's window;
otherwise it is a MISS: window k+1 is discarded unverified and the draft
rolls back to the commit point. The target only ever verifies a window
whose anchor is its committed last token, so at temperature 0 the tokens
are the half-duplex stream's. How the in-place port keeps the draft's
state:

- The draft's cursor. The speculative propose never reads the state the
  target's verify writes (``last_token``, ``pos``): its anchor is the
  predicted last token and its start the pending window's start (the draft
  window's ``pos``, which every propose records) plus the predicted
  ``num_new``, both from a draft-side buffer filled from the host.
- An attention draft needs no copy to roll back. Session caches are never
  ring caches (pipeline refuses one); the speculative window writes from
  the predicted start, which is at or past the committed end (a committed
  count never exceeds its prediction), and positions mask everything past
  the committed end until a later window overwrites it, before any query
  reaches it. The cache length reserves 2·γ_max past the budget
  (:meth:`DecodeSession._cache_len`) and a paged reservation the same
  overhang (:meth:`DecodeSession.blocks_needed`), so the speculative writes
  stay inside the row. This replaces the reference's kept propose cache.
- A recurrent draft (ssm, hybrid) checkpoints. ``advance`` moves the
  recurrent state in place, and the optimistic advance over window k must
  run before window k+1 is proposed, so one captured step first copies the
  pre-window state into a session-owned checkpoint and window k (anchor,
  proposals, start) into a record the speculative propose does not touch,
  then advances over the predicted prefix; a miss restores the checkpoint
  and re-advances over the record by the received ``num_new`` (one
  captured step). The speculative window's own checkpoint waits for window
  k's verdict: it is taken on a hit.

Graphs of a pipelined session: insert, propose, speculative propose and
verify (+ ingest once a fused round ran); a recurrent draft adds the
checkpoint and the rollback. Their number is flat over γ, hits, misses and
admissions.
"""

from __future__ import annotations

import contextlib
import time
import weakref
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..distributed.transport import Transport
from ..distributed.wire import TransportProtocolError, VerdictMsg, WindowMsg
from ..models.kvcache import copy_cache_, logical_blocks, reset_slot
# fused-mode tokens stream edge-ward one control round trip per this many
# committed tokens — the same amortization the link model charges
from ..sim.network import DEFAULT_FUSED_CHUNK as FUSED_FLUSH_TOKENS
from .capture import CapturedStep
from .engine import DEFAULT_GAMMA_MAX, GenerationStats
from .specdec import SpecDecodeState
from .window import FeatureSnapshot


def predict_verdict(tokens: np.ndarray, last: np.ndarray, gamma: int,
                    done: np.ndarray, cursor: np.ndarray,
                    max_new: np.ndarray, eos_id: int):
    """The pipelined mode's optimistic verdict of one window: the host
    mirror of :func:`~repro_torch.core.specdec.slot_stop_mask` applied to a
    window whose ``gamma`` proposals are all accepted and whose bonus token
    is proposal ``gamma`` (the reserved guess). ``tokens`` (B, γ_max) the
    proposals, ``last`` (B,) the window's anchor, ``done``/``cursor``/
    ``max_new`` the rows' lifecycle before the round. Returns (num_new,
    done, last_token) as the device rule would commit them; a verdict
    equal to all three is a hit."""
    B, G = tokens.shape
    bonus = tokens[:, gamma]
    committed = np.full((B, G + 1), -1, np.int32)
    committed[:, :gamma] = tokens[:, :gamma]
    committed[:, gamma] = bonus
    num = np.where(~done, np.minimum(gamma + 1,
                                     np.maximum(0, max_new - cursor)), 0)
    ar = np.arange(G + 1)[None, :]
    is_eos = (committed == eos_id) & (ar < num[:, None]) & (eos_id >= 0)
    has_eos = is_eos.any(axis=1)
    num = np.where(has_eos, np.minimum(num, is_eos.argmax(axis=1) + 1), num)
    num = num.astype(np.int32)
    done_opt = done | (cursor + num >= max_new) | has_eos
    last_opt = np.where(done, last, bonus).astype(np.int32)
    return num, done_opt, last_opt


@dataclass
class PipeWindow:
    """One posted window of the pipelined mode and its predicted verdict."""
    msg: WindowMsg
    num_new: np.ndarray              # predicted (B,) committed counts
    done: np.ndarray                 # predicted (B,) done flags
    last: np.ndarray                 # predicted (B,) last tokens
    draft_ms: float

    @property
    def pred_row(self) -> np.ndarray:
        """The draft cursor of a window speculated on this one: the
        predicted anchor, then the predicted count."""
        return np.concatenate([self.last, self.num_new])


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


def _pooled(name: str):
    """A session attribute that lives in its pool (None before the lease;
    a closed session has none)."""
    def get(self):
        if self._closed:
            raise RuntimeError("the session is closed: its pool serves "
                               "other sessions now")
        return None if self._pool is None else getattr(self._pool, name)
    return property(get)


FRONTEND_REFUSAL = ("per-slot admission needs a frontend-free arch; use "
                    "admit_batch for vlm/encdec waves")


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
                       ``"pipeline"`` honors it and overlaps window k+1's
                       draft with window k's verdict (needs a transport
                       and γ_max ≥ 2: proposal γ is the bonus guess, so γ
                       caps at γ_max − 1; linear windows only),
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
                       per pool (None: on the card, not on the CPU);
                       ``False`` on the card runs every step eagerly;
                       ``True`` on the CPU raises.

    Close a session (:meth:`close`, or use it as a context manager) when
    its requests are out: its pool then serves the next session of its
    geometry on the engine.
    """

    _state = _pooled("state")
    _out_buf = _pooled("out_buf")
    _cursor = _pooled("cursor")
    _max_new = _pooled("max_new")
    _done = _pooled("done")
    _nacc = _pooled("nacc")
    _nn = _pooled("nn")
    _gamma_tab = _pooled("gamma_tab")
    _branch_tab = _pooled("branch_tab")
    _row_tab = _pooled("row_tab")
    _gamma_in = _pooled("gamma_in")
    _branch_in = _pooled("branch_in")
    _row_in = _pooled("row_in")
    _eos = _pooled("eos")
    _tree_counters = _pooled("tree_counters")
    _gen = _pooled("gen")
    _alloc = _pooled("alloc")
    _wire = _pooled("wire")

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
        if mode_policy not in ("auto", "distributed", "fused", "pipeline"):
            raise ValueError(f"unknown mode_policy {mode_policy!r}")
        if gamma_max:
            self.gamma_max = int(gamma_max)
        elif engine.gamma_max:
            self.gamma_max = engine.gamma_max
        else:
            self.gamma_max = DEFAULT_GAMMA_MAX
        if mode_policy == "pipeline":
            if transport is None:
                raise ValueError(
                    "pipeline mode overlaps rounds across a transport; "
                    "colocated sessions have nothing to overlap")
            if self.gamma_max < 2:
                raise ValueError(
                    "pipeline mode reserves one proposal slot as the bonus "
                    "guess; gamma_max must be ≥ 2")
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
        self.seed = int(seed)
        self._pool = None
        self._closed = False
        self._finalizer = None
        self._closed_free_blocks: Optional[int] = None
        self.capacity = int(capacity)
        self.max_new_cap = int(max_new_cap)
        self.max_prompt_len = (None if max_prompt_len is None
                               else int(max_prompt_len))
        self.sync_every = max(1, int(sync_every or engine.sync_every))
        self.eos_id = -1 if eos_id is None else int(eos_id)
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
        self._slot_blocks: list[Optional[dict]] = [None] * self.capacity

        self.slots_len = (None if self.max_prompt_len is None
                          else self._cache_len(self.max_prompt_len))
        self._slots: list[Optional[SlotRecord]] = [None] * self.capacity

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
        self.pipeline_hits = 0           # verdicts as predicted
        self.pipeline_misses = 0         # … and not (the draft rolls back)
        self.speculative_windows = 0     # windows posted before the verdict
        self.control_roundtrips = 0      # fused-mode stream flushes
        self._fused_pending = 0          # fused tokens since the last flush
        self._round_seq = 0              # wire round ids (RTT pairing)
        self._alpha_recent: list[float] = []
        self._tpot_recent: list[float] = []
        self._pipe_recent: list[float] = []
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
        """Min free blocks across paged sides (None for dense sessions; a
        closed session's count at its close)."""
        if not self.paged:
            return None
        if self._closed:
            return self._closed_free_blocks
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

    # ------------------------------------------------------------ the pool

    def _geometry(self, enc_frames: int = 0) -> tuple:
        """The pool key: every value the pool's buffers and captured steps
        were built for."""
        blocks = tuple(self._pool_blocks(side)
                       if self.paged and self._paged_sides[side] else 0
                       for side in ("draft", "target"))
        wire = ("pipeline" if self.mode_policy == "pipeline"
                else "split" if self.transport is not None else None)
        return (self.capacity, self.max_new_cap, self.max_prompt_len,
                self.slots_len, self.paged, self.kv_block_size, blocks,
                self.kv_quantize, self.gamma_max, self.sync_every,
                self.max_branches, wire, self.engine.temperature > 0.0,
                self.capture, int(enc_frames))

    def _lease(self, enc_frames: int = 0) -> bool:
        """Lease and reset a pool of this session's geometry from the
        engine; returns whether its state is still to be built (a new pool,
        or one whose first session failed before building it)."""
        if self._closed:
            raise RuntimeError("the session is closed")
        key = self._geometry(enc_frames)
        pool = self.engine.lease_pool(
            key, capacity=self.capacity, max_new_cap=self.max_new_cap,
            sync_every=self.sync_every, gamma_max=self.gamma_max,
            max_branches=self.max_branches, capture=self.capture)
        pool.blocks = dict(zip(("draft", "target"), key[6]))
        self._pool = pool
        self._finalizer = weakref.finalize(self, pool.release)
        pool.reset(self.seed, self.eos_id)
        return pool.state is None

    def close(self) -> None:
        """Give the pool back to the engine (idempotent). The session's
        host-side records (counters, γ log, per-slot records) stay
        readable; its device buffers do not."""
        if self._closed:
            return
        if self._pool is not None:
            if self.paged:
                self._closed_free_blocks = self.free_kv_blocks()
            self._finalizer()
            self._pool = None
        self._closed = True

    def __enter__(self) -> "DecodeSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _ensure_state(self) -> None:
        """Lease the pool for per-slot admission: an all-free device state
        (built the first time the pool is leased)."""
        if self._state is not None:
            return
        eng = self.engine
        assert self.max_prompt_len is not None, \
            "per-slot admission needs max_prompt_len at session creation"
        for cfg in (eng.draft_cfg, eng.target_cfg):
            if cfg.arch_type in ("vlm", "encdec"):
                raise ValueError(FRONTEND_REFUSAL)
        if not self._lease():
            return

        def make_cache(model, side):
            if self.paged and self._paged_sides[side]:
                return model.init_paged_cache(
                    self.capacity, self.slots_len, self._pool.blocks[side],
                    self.kv_block_size, quantize=self.kv_quantize)
            return model.init_cache(self.capacity, self.slots_len)

        zeros = torch.zeros((self.capacity,), dtype=torch.int32,
                            device=self.device)
        self._pool.state = SpecDecodeState(
            draft_cache=make_cache(eng.draft, "draft"),
            target_cache=make_cache(eng.target, "target"),
            last_token=zeros.clone(), pos=zeros.clone())

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
                    request_ids: Optional[Sequence[int]] = None,
                    frontend=None) -> list[int]:
        """Admit one full wave into a FRESH session via batched prefill
        (the ``generate()`` path, and the only admission path for the
        vlm/encdec families). ``max_new`` may be a scalar or a per-slot
        vector; ``frontend`` (B, F, D), a tensor or array, goes to both
        models' prefill. The prefill runs eagerly into new buffers and is
        then copied into the pool's (a new pool adopts them)."""
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
        fe = (None if frontend is None
              else torch.as_tensor(frontend, device=dev))
        encdec = any(c.arch_type == "encdec" for c in
                     (self.engine.draft_cfg, self.engine.target_cfg))
        fresh = self._lease(fe.shape[1] if encdec and fe is not None else 0)
        state = self.engine._prefill(torch.as_tensor(prompts, device=dev),
                                     self.slots_len, prompt_lens=pl,
                                     generator=self._gen, frontend=fe)
        pool = self._pool
        if fresh:
            pool.state = state
        else:
            st = pool.state
            copy_cache_(st.draft_cache, state.draft_cache)
            copy_cache_(st.target_cache, state.target_cache)
            st.last_token.copy_(state.last_token)
            st.pos.copy_(state.pos)
        mn = np.minimum(np.broadcast_to(np.asarray(max_new), (B,)),
                        self.max_new_cap).astype(np.int32)
        pool.max_new.copy_(torch.from_numpy(mn))
        pool.done.zero_()
        pool.cursor.fill_(1)
        pool.out_buf[:, 0] = pool.state.last_token
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
        """A step of the pool: its graph is captured on the pool's buffers
        (at temperature > 0 with the pool's generator)."""
        sampled = self.engine.temperature > 0.0
        return CapturedStep(body, inputs, self.engine.graphs,
                            capture=self.capture, stream=self._pool.stream,
                            generator=self._gen if sampled else None)

    @property
    def _round(self) -> Optional[CapturedStep]:
        return self._pool.steps.get("round") if self._pool else None

    @property
    def _insert(self) -> Optional[CapturedStep]:
        return self._pool.steps.get("insert") if self._pool else None

    def _insert_step(self, n_blocks: tuple) -> CapturedStep:
        """The pool's insert step (built at its first ``admit``): the
        engine's dense or paged prefill-insert on the pool's state and
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
            self._pool.steps["insert"] = self._captured(
                body, {"admission": buf})
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
        # pipeline mode reserves the (γ+1)-th proposal as the bonus guess
        # the speculative next window anchors on: γ caps one below γ_max
        cap = (self.gamma_max - 1 if self.mode_policy == "pipeline"
               else self.gamma_max)
        gamma_eff = 0 if fused else min(cap, max(1, int(dec.gamma)))
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
        exchanges (:meth:`_run_chunk_transport`), pipelined ones with
        ``mode_policy="pipeline"`` (:meth:`_run_chunk_pipeline`)."""
        if self.transport is not None:
            if self.mode_policy == "pipeline":
                return self._run_chunk_pipeline(policy, max_iters, q_depth)
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
        """The pool's round step (built at its first chunk): the engine's
        tree step, or its linear step for the pair, on the pool's state
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
            self._pool.steps["round"] = self._captured(body, ins)
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
             "tokens_in": zeros(B, G),
             "last_in": zeros(B)}
        if self.max_branches:
            T = eng._tree_spec(G, self.max_branches).n_entries
            w.update(tree=DraftWindow.empty(B, T, dev, d_max=G),
                     tree_verdict=VerdictBuffer(B, G, dev),
                     grid_in=zeros(B, T))
        host = {"proposals": w["linear"].tokens,
                "received": w["linear"].received,
                "tokens_in": w["tokens_in"], "verdict": w["verdict"].flat,
                "last_in": w["last_in"]}
        if self.max_branches:
            host.update(grid=w["tree"].tokens,
                        tree_received=w["tree"].received,
                        grid_in=w["grid_in"],
                        tree_verdict=w["tree_verdict"].flat)
        if self.mode_policy == "pipeline":
            # the draft cursor of a speculative window (predicted anchor,
            # predicted count), the non-speculative window's anchor, and
            # for a recurrent draft the checkpoint and window record
            w["pred"] = zeros(2 * B)
            host.update(pred=w["pred"], anchor=w["linear"].anchor)
            st = self._state
            if any(getattr(c, "ring", False) or getattr(
                    getattr(c, "shared_attn", None), "ring", False)
                   for c in (st.draft_cache, st.target_cache)):
                raise ValueError("pipeline mode rolls an attention draft "
                                 "back by positions; a ring cache would "
                                 "wrap the speculative writes")
            if not eng._draft_attention:
                from ..distributed.workers import recurrent_clone
                w["record"] = DraftWindow.empty(B, G, dev)
                w["ckpt"] = recurrent_clone(st.draft_cache)
                host["record"] = w["record"].received
        w["host"] = {k: HostImage(v) for k, v in host.items()}
        w["steps"] = {}
        self._pool.wire = w

    def _worker_step(self, name: str) -> CapturedStep:
        """The pool's captured step of one worker program (built at its
        first call), bound to the pool's state and buffers: ``propose``,
        ``verify``, ``advance``, ``ingest``, ``propose_tree``,
        ``verify_tree``, ``ingest_tree``, the pipelined mode's
        ``propose_spec``, ``checkpoint`` and ``rollback``, and a draft
        host's ``apply``."""
        steps = self._wire["steps"]
        if name in steps:
            return steps[name]
        # the bodies close over tensors and buffer objects, never over the
        # session or the pool that holds the steps (no reference cycle)
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
        elif name == "propose_spec":
            # the draft's own cursor: predicted anchor, and the pending
            # window's start plus the predicted count (never the target's
            # last_token/pos)
            fn, pred, B = dw.propose(G), w["pred"], self.capacity
            body = lambda: fn(st.draft_cache, pred[:B], lin.pos + pred[B:],
                              lin, generator=gen)
        elif name == "checkpoint":
            fn, pred, B = dw.checkpoint(G), w["pred"], self.capacity
            ckpt, rec = w["ckpt"], w["record"]
            body = lambda: fn(st.draft_cache, ckpt, lin, rec, pred[B:])
        elif name == "rollback":
            fn, ckpt, rec = dw.rollback(G), w["ckpt"], w["record"]
            body = lambda: fn(st.draft_cache, ckpt, rec)
        elif name == "advance":
            fn = dw.advance(G)
            body = lambda: fn(st.draft_cache, lin)
        elif name == "apply":
            adv = None if eng._draft_attention else dw.advance(G)
            last_in = w["last_in"]

            def body():
                if adv is not None:
                    adv(st.draft_cache, lin)
                st.pos.copy_(lin.pos + lin.num_new)
                st.last_token.copy_(last_in)
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
        self._check_window(got, msg)
        return got, waited

    @staticmethod
    def _check_window(got: WindowMsg, msg: WindowMsg) -> None:
        """The window the target received is the one the draft posted for
        that round: its round id and shape, and the draft's
        distributions passed through where they lie."""
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
        verdict = self._verify(got, r)
        got_v, waited = self._return(verdict)
        if not self.engine._draft_attention:
            img = h["received"]
            DraftWindow.pack_received(got_v, img.np)
            self._segment(self._worker_step("advance"),
                          before=[lambda: img.put(img.np)])
        return got_v, link_ms + waited, draft_ms

    def _verify(self, got: WindowMsg, r: int) -> VerdictMsg:
        """The target's verify of a received linear window (stats row
        ``r``); returns its verdict off the device."""
        w, h = self._wire, self._wire["host"]
        self._segment(self._worker_step("verify"),
                      before=[lambda: h["tokens_in"].put(got.tokens)],
                      after=[h["verdict"].fetch],
                      gamma=self._gamma_tab[got.gamma], row=self._row_tab[r])
        return w["verdict"].message(h["verdict"].wait(), got.gamma,
                                    got.n_active, got.round_id)

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
        verdict's (5, B) rows: n_accepted, num_new, next_token, last_token,
        done; the unhidden link ms of the flushes)."""
        w, h = self._wire, self._wire["host"]
        self._segment(self._worker_step("verify"),
                      before=[w["tokens_in"].zero_],
                      gamma=self._gamma_tab[0], row=self._row_tab[r])
        self._segment(self._worker_step("ingest"),
                      after=[h["verdict"].fetch])
        rows = h["verdict"].wait()[:5 * self.capacity].reshape(5, -1).copy()
        self._fused_pending += int(rows[1].sum())
        link_ms = 0.0
        while self._fused_pending >= FUSED_FLUSH_TOKENS:
            link_ms += self._flush()
            self._fused_pending -= FUSED_FLUSH_TOKENS
        return rows, link_ms

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
                rows, ms = self._fused_round(r)
                done_host = rows[4].astype(bool)
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

    # ------------------------------------- one side of a process-split pair

    def propose_window(self, gamma: int, n_active: int,
                       round_id: int) -> WindowMsg:
        """A draft host's half of a round: propose from this session's own
        committed state and return the window to post."""
        self._wire_init()
        h = self._wire["host"]
        self._segment(self._worker_step("propose"),
                      after=[h["proposals"].fetch])
        return WindowMsg(tokens=h["proposals"].wait().copy(), gamma=gamma,
                         n_active=n_active, round_id=round_id)

    def apply_verdict(self, verdict: VerdictMsg) -> None:
        """A draft host applies the verdict it received to its own state: a
        recurrent draft re-advances over the window by ``num_new``, and
        ``pos``/``last_token`` take the committed ones (the target's verify
        writes them in process; here nothing else does)."""
        from ..distributed.workers import DraftWindow
        h = self._wire["host"]
        rec, last = h["received"], h["last_in"]
        DraftWindow.pack_received(verdict, rec.np)

        def put():
            rec.put(rec.np)
            last.put(verdict.last_token)

        self._segment(self._worker_step("apply"), before=[put])

    def verify_window(self, msg: WindowMsg, row: int) -> VerdictMsg:
        """A target host's half of a round: verify the received window into
        stats row ``row`` and return the verdict to post."""
        self._wire_init()
        return self._verify(msg, row)

    # --------------------------------------------------- pipelined rounds

    def _make_window(self, gamma: int, done_host: np.ndarray,
                     cursor_host: np.ndarray,
                     prev: Optional[PipeWindow]) -> PipeWindow:
        """Propose one window, predict its verdict and post it. ``prev``
        None: a window from the committed state (a recurrent draft takes
        its checkpoint and optimistic advance at once); else a SPECULATIVE
        window from ``prev``'s predicted verdict, proposed from the draft's
        cursor while ``prev``'s verdict is in flight (its checkpoint waits
        for that verdict: :meth:`_checkpoint` on a hit)."""
        h = self._wire["host"]
        t0 = time.perf_counter()
        if prev is None:
            self._segment(self._worker_step("propose"),
                          after=[h["proposals"].fetch, h["anchor"].fetch])
            last = h["anchor"].wait().copy()
        else:
            row = prev.pred_row
            self._segment(self._worker_step("propose_spec"),
                          before=[lambda: h["pred"].put(row)],
                          after=[h["proposals"].fetch])
            last = prev.last
        tokens = h["proposals"].wait().copy()
        max_new = np.array([rec.max_new if rec else 0 for rec in self._slots],
                           np.int32)
        num, done, last_opt = predict_verdict(tokens, last, gamma, done_host,
                                              cursor_host, max_new,
                                              self.eos_id)
        rid = self._round_seq
        self._round_seq += 1
        win = PipeWindow(
            msg=WindowMsg(tokens=tokens, gamma=gamma,
                          n_active=int(done_host.size - done_host.sum()),
                          q_probs=self._wire["linear"].q_probs, round_id=rid,
                          speculative=prev is not None),
            num_new=num, done=done, last=last_opt, draft_ms=0.0)
        if prev is None:
            self._checkpoint(win)
        else:
            self.speculative_windows += 1
        win.draft_ms = (time.perf_counter() - t0) * 1e3
        self.transport.post_window(win.msg)
        return win

    def _checkpoint(self, win: PipeWindow) -> None:
        """A recurrent draft's optimistic advance over ``win`` (the window
        just proposed): the pre-window state into the checkpoint, the window
        into the record, the state advanced by the predicted counts. An
        attention draft has nothing to do."""
        if self.engine._draft_attention:
            return
        row = win.pred_row
        h = self._wire["host"]
        self._segment(self._worker_step("checkpoint"),
                      before=[lambda: h["pred"].put(row)])

    def _run_chunk_pipeline(self, policy, max_iters: Optional[int],
                            q_depth: float) -> int:
        """Up to ``sync_every`` CROSS-ROUND PIPELINED rounds over the
        transport (the reference's ``_run_chunk_pipeline``): the target
        verifies window k and posts its verdict; while the verdict flies the
        draft decides the next γ and posts window k+1, proposed from its
        prediction of that verdict (:meth:`_make_window`). The verdict the
        draft receives resolves it: a HIT (num_new, done and last_token as
        predicted) keeps window k+1 as the next round's window — its verify
        starts without waiting for a draft scan and an upload; a MISS
        discards it unverified (``discard_window``) and rolls a recurrent
        draft back (an attention draft's stale tail is masked by position),
        and the next round re-proposes with the discarded window's γ. A
        fused decision runs unpipelined. Speculation never crosses a chunk
        boundary, so admission and retirement never invalidate a window in
        flight."""
        n = self.sync_every
        if max_iters is not None:
            n = min(n, max_iters - self.iterations)
        if n <= 0 or not self.occupied:
            return 0
        self._wire_init()
        tr = self.transport
        chunk_t0 = time.perf_counter()
        chunk_gammas: list[int] = []
        link_ms = draft_ms = 0.0
        done_host = np.array([rec is None or rec.done for rec in self._slots])
        cursor_host = np.array([rec.produced if rec else 0
                                for rec in self._slots], np.int32)
        it_run = 0
        pending: Optional[PipeWindow] = None   # posted, verdict outstanding
        carry = None          # (γ, fused) decided during the last flight
        while it_run < n and not done_host.all():
            if pending is None:
                gamma, fused = (carry if carry is not None
                                else self._decide(policy, q_depth))
                carry = None
                if fused:
                    rows, ms = self._fused_round(it_run)
                    link_ms += ms
                    done_host = rows[4].astype(bool)
                    cursor_host = cursor_host + rows[1]
                    chunk_gammas.append(0)
                    self.iterations += 1
                    it_run += 1
                    continue
                pending = self._make_window(gamma, done_host, cursor_host,
                                            None)
                draft_ms += pending.draft_ms

            # -- target: receive and verify the window in flight -----------
            got, waited = tr.recv_window()
            link_ms += waited
            self._check_window(got, pending.msg)
            tr.post_verdict(self._verify(got, it_run))

            # -- draft: speculate window k+1 while the verdict flies -------
            spec = None
            if it_run + 1 < n and not pending.done.all():
                gamma2, fused2 = self._decide(policy, q_depth)
                if fused2:
                    carry = (gamma2, fused2)      # fused runs unpipelined
                else:
                    spec = self._make_window(gamma2, pending.done,
                                             cursor_host + pending.num_new,
                                             pending)
                    draft_ms += spec.draft_ms

            # -- draft: the verdict it received resolves the speculation ---
            verdict, waited = tr.recv_verdict()
            link_ms += waited
            if verdict.round_id != got.round_id:
                raise TransportProtocolError(
                    f"received verdict {verdict.round_id}, sent "
                    f"{got.round_id}")
            hit = (np.array_equal(verdict.num_new, pending.num_new)
                   and np.array_equal(verdict.done, pending.done)
                   and np.array_equal(verdict.last_token, pending.last))
            self._pipe_recent.append(1.0 if hit else 0.0)
            if hit:
                self.pipeline_hits += 1
            else:
                self.pipeline_misses += 1
                if not self.engine._draft_attention:
                    from ..distributed.workers import DraftWindow
                    img = self._wire["host"]["record"]
                    DraftWindow.pack_received(verdict, img.np)
                    self._segment(self._worker_step("rollback"),
                                  before=[lambda: img.put(img.np)])
            done_host = np.asarray(verdict.done, bool)
            cursor_host = cursor_host + verdict.num_new
            chunk_gammas.append(got.gamma)
            self.iterations += 1
            it_run += 1
            if hit and spec is not None:
                t0 = time.perf_counter()
                self._checkpoint(spec)
                draft_ms += (time.perf_counter() - t0) * 1e3
                pending = spec                    # the speculative window
            else:                                 # is the next round's
                if spec is not None:
                    # the late verdict invalidated it; the re-proposal
                    # reuses its γ decision (made before the verdict: that
                    # is what pipelining means), keeping policy calls and
                    # gamma_seq one per committed round
                    tr.discard_window()
                    carry = (spec.msg.gamma, False)
                pending = None
        if carry is not None:
            # a decision for a round that never ran (the batch drained or
            # the chunk ended first): unwind its bookkeeping
            if carry[1]:
                self.fused_iterations -= 1
            else:
                self.gamma_sum -= carry[0]
                self.gamma_rounds -= 1
            if self.log_gamma and self.gamma_seq:
                self.gamma_seq.pop()
        if it_run == 0:
            return 0
        if self._fused_pending and done_host.all():
            link_ms += self._flush()
            self._fused_pending = 0
        self.link_ms += link_ms
        del self._pipe_recent[:-16]
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
        p = self._pipe_recent[-16:]
        rtt = (self.transport.recent_rtt_ms if self.transport is not None
               else self.engine.rtt_ms)
        return FeatureSnapshot(
            q_depth=q_depth,
            alpha_recent=(sum(a) / len(a)) if a else 0.7,
            rtt_recent_ms=rtt,
            tpot_recent_ms=(sum(t) / len(t)) if t else 50.0,
            gamma_prev=self._gamma_prev,
            # outside pipeline mode no RTT is overlapped: 0 keeps the
            # bootstrap's overlapped-RTT term inert
            pipe_hit_recent=((sum(p) / len(p)) if p else 0.0)
            if self.mode_policy == "pipeline" else 0.0,
            branches_prev=self._branches_prev)

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
