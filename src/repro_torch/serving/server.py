"""In-process serving on the port's models — continuous (iteration-level)
batching over persistent :class:`~repro_torch.core.session.DecodeSession`
pools, one per draft–target pair.

:class:`SpecDecodeServer` admits requests into free slots the moment they
have arrived and a slot is open (FIFO or length-aware LAB within the chosen
pair; with ``ServerConfig.paged_kv`` admission is also block-aware: a
request enters only when every paged side has enough free KV blocks for its
prompt + budget, otherwise it waits for retirements), routes across pairs
with a :class:`PairRouter` (least-loaded by default; sticky), decodes in
``sync_every``-round chunks per pair and retires finished requests at chunk
boundaries.

Per-request metrics include queue wait: TTFT runs from the request's own
``arrival_s`` to the end of its own prefill-insert, e2e to its retirement;
token payloads come from the per-sequence cursor.

A pair with a ``transport`` (a :class:`repro_torch.distributed.Transport`)
runs its rounds as half-duplex draft→verify→verdict exchanges over it;
:meth:`SpecDecodeServer.pair_summaries` then reports its link (bytes,
messages, measured RTT, unhidden link ms).

SLO-aware admission, process-backed pairs, the smart router and the wave
baseline come with ROADMAP item A13.
"""

from __future__ import annotations

import bisect
import math
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional, Protocol, Sequence

import numpy as np

from ..core.engine import SpecDecodeEngine
from ..core.session import DecodeSession
from ..core.window import StaticWindowPolicy, WindowPolicy


@dataclass
class ServeRequest:
    request_id: int
    prompt: np.ndarray           # (S,) int32
    max_new_tokens: int
    arrival_s: float = 0.0       # relative to the serve-loop start


@dataclass
class ServeResult:
    request_id: int
    tokens: np.ndarray           # exactly the tokens produced (cursor-true)
    ttft_ms: float               # arrival → own first token (queue incl.)
    tpot_ms: float               # first token → finish, per later token
    e2e_ms: float                # arrival → retirement
    acceptance_rate: float
    queue_ms: float = 0.0        # arrival → admission start
    pair_id: str = ""            # draft–target pair that served the request


@dataclass
class ServingPair:
    """One deployed draft→target lane: engine + window policy + mode.
    ``pair_id`` doubles as the window policy's pair key."""
    pair_id: str
    engine: SpecDecodeEngine
    policy: WindowPolicy
    transport: Optional[object] = None   # repro_torch.distributed.Transport
    mode_policy: str = "auto"            # auto | distributed | fused
    session: Optional[DecodeSession] = None  # live session, set by run()
    draining: bool = False               # drained pairs admit nothing new


@dataclass
class ServerConfig:
    max_batch: int = 8           # slot-pool capacity PER PAIR
    length_aware: bool = True    # LAB admission (vs FIFO), as in sim
    pad_to: int = 16             # prompt padding quantum
    max_prompt_len: Optional[int] = None   # continuous pad bound
                                           # (default: queue max, rounded)
    max_new_cap: Optional[int] = None      # output width (default: queue max)
    eos_id: int = -1
    sync_every: Optional[int] = None       # admission/retirement granularity
    transport: Optional[object] = None     # one-pair surface: the implicit
                                           # pair's Transport
    mode_policy: str = "auto"              # one-pair surface: the implicit
                                           # pair's mode policy
    paged_kv: bool = False       # paged block-pool KV cache per pair
    kv_block_size: int = 16      # positions per KV block (paged only)
    kv_pool_blocks: Optional[object] = None  # pool size: int, or dict
                                             # {"draft": n, "target": n};
                                             # None = dense-parity sizing
    kv_quantize: bool = False    # int8 per-entry KV quantization (paged)
    capture: Optional[bool] = None  # replay each session step from a CUDA
                                    # graph (None: on the card); False keeps
                                    # the card's steps eager


class RollingQuantile:
    """Sorted-window quantile estimator over the most recent ``size``
    samples (arrival order evicts); NaN when empty."""

    def __init__(self, size: int = 256):
        self.size = int(size)
        self._ring: deque[float] = deque()
        self._sorted: list[float] = []

    def push(self, v: float) -> None:
        v = float(v)
        if not math.isfinite(v):
            return
        if len(self._ring) >= self.size:
            old = self._ring.popleft()
            del self._sorted[bisect.bisect_left(self._sorted, old)]
        self._ring.append(v)
        bisect.insort(self._sorted, v)

    def quantile(self, p: float) -> float:
        s = self._sorted
        if not s:
            return math.nan
        k = (len(s) - 1) * min(1.0, max(0.0, p))
        lo, hi = int(math.floor(k)), int(math.ceil(k))
        if lo == hi:
            return s[lo]
        return s[lo] + (s[hi] - s[lo]) * (k - lo)

    def p50(self) -> float:
        return self.quantile(0.5)

    def p95(self) -> float:
        return self.quantile(0.95)


# -- pair routing ------------------------------------------------------------

class PairRouter(Protocol):
    """Chooses the draft–target pair that admits a request; must return an
    index with ``free_slots[i] > 0``. Routing is sticky: the server never
    migrates an admitted request."""

    def route(self, req: ServeRequest, pairs: Sequence[ServingPair],
              free_slots: Sequence[int]) -> int: ...


class LeastLoadedPairRouter:
    """The pair with the most free slots (ties break to the lowest index)."""

    def route(self, req: ServeRequest, pairs: Sequence[ServingPair],
              free_slots: Sequence[int]) -> int:
        return int(max(range(len(free_slots)), key=lambda i: free_slots[i]))


class RoundRobinPairRouter:
    """Cycle over pairs, skipping the ones with no free slot."""

    def __init__(self):
        self._next = 0

    def route(self, req: ServeRequest, pairs: Sequence[ServingPair],
              free_slots: Sequence[int]) -> int:
        n = len(free_slots)
        for k in range(n):
            i = (self._next + k) % n
            if free_slots[i] > 0:
                self._next = i + 1
                return i
        return self._next % n


PAIR_ROUTERS = {
    "least-loaded": LeastLoadedPairRouter,
    "round-robin": RoundRobinPairRouter,
}


class _ArrivalClock:
    """Wall clock for the serve loop; ``wait_until`` idles to an arrival."""

    def __init__(self):
        self._t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self._t0

    def wait_until(self, t_s: float) -> None:
        d = t_s - self.now()
        if d > 0:
            time.sleep(d)


class SpecDecodeServer:
    """Continuous slot-based scheduler over a deployment of draft–target
    pairs (one decode session per pair)."""

    def __init__(self, engine: Optional[SpecDecodeEngine] = None,
                 window_policy: Optional[WindowPolicy] = None,
                 cfg: Optional[ServerConfig] = None, *,
                 pairs: Optional[Sequence[ServingPair]] = None,
                 router: Optional[PairRouter] = None):
        self.cfg = cfg or ServerConfig()
        if pairs is None:
            assert engine is not None, \
                "pass either an engine (one-pair surface) or pairs="
            pairs = [ServingPair(
                pair_id="pair0", engine=engine,
                policy=window_policy or StaticWindowPolicy(4),
                transport=self.cfg.transport,
                mode_policy=self.cfg.mode_policy)]
        else:
            assert engine is None and window_policy is None, \
                "pairs= replaces the engine/window_policy surface"
            assert len(pairs) >= 1, "a deployment needs at least one pair"
            ids = [p.pair_id for p in pairs]
            assert len(set(ids)) == len(ids), f"duplicate pair ids: {ids}"
        self.pairs = list(pairs)
        self.router = router or LeastLoadedPairRouter()
        self.engine = self.pairs[0].engine
        self.policy = self.pairs[0].policy
        self.queue: list[ServeRequest] = []
        self.results: list[ServeResult] = []
        self._sessions: list[DecodeSession] = []
        self._served = [0] * len(self.pairs)
        self._ttft_q = [RollingQuantile() for _ in self.pairs]
        self._tpot_q = [RollingQuantile() for _ in self.pairs]

    def submit(self, req: ServeRequest) -> None:
        self.queue.append(req)

    # -- drain / re-admit ----------------------------------------------------

    def drain(self, pair_id: str) -> None:
        """Stop routing NEW requests to a pair; in-flight sequences finish."""
        self._pair_by_id(pair_id).draining = True

    def undrain(self, pair_id: str) -> None:
        self._pair_by_id(pair_id).draining = False

    def _pair_by_id(self, pair_id: str) -> ServingPair:
        for p in self.pairs:
            if p.pair_id == pair_id:
                return p
        raise KeyError(f"no pair {pair_id!r} in this deployment")

    # -- admission (FIFO vs LAB) ---------------------------------------------

    def _select_admissions(self, arrived: list[ServeRequest],
                           k: int) -> list[ServeRequest]:
        """Pick ≤ k arrived requests for ONE pair: head-of-line always goes;
        LAB fills the remaining free slots with the requests whose prompt
        lengths are closest to the head's, FIFO in arrival order."""
        if not arrived or k <= 0:
            return []
        head = arrived[0]
        if not self.cfg.length_aware:
            return arrived[:k]
        rest = sorted(arrived[1:],
                      key=lambda r: abs(len(r.prompt) - len(head.prompt)))
        return [head] + rest[:k - 1]

    # -- serve loop ----------------------------------------------------------

    def _make_session(self, pair: ServingPair,
                      pending: list[ServeRequest]) -> DecodeSession:
        q = self.cfg.pad_to
        mp = self.cfg.max_prompt_len or max(len(r.prompt) for r in pending)
        mp = ((mp + q - 1) // q) * q
        cap = self.cfg.max_new_cap or max(r.max_new_tokens for r in pending)
        eng = pair.engine
        gmax = eng.gamma_max or eng._policy_gamma_bound(pair.policy)
        return DecodeSession(eng, capacity=self.cfg.max_batch,
                             max_new_cap=cap, max_prompt_len=mp,
                             gamma_max=gmax,
                             sync_every=self.cfg.sync_every,
                             eos_id=self.cfg.eos_id, log_gamma=False,
                             mode_policy=pair.mode_policy,
                             transport=pair.transport,
                             pair_key=pair.pair_id,
                             paged=self.cfg.paged_kv,
                             kv_block_size=self.cfg.kv_block_size,
                             kv_pool_blocks=self.cfg.kv_pool_blocks,
                             kv_quantize=self.cfg.kv_quantize,
                             capture=self.cfg.capture)

    def run(self) -> list[ServeResult]:
        """Drain the submitted stream; returns per-request results.

        Per cycle: route + admit arrived requests into free slots (the
        head-of-line request picks its pair via the router, LAB/FIFO
        co-admission fills that pair's remaining slots) → run one decode
        chunk per occupied pair → retire finished slots. With nothing in
        flight the loop idles to the next arrival."""
        if not self.queue:
            return self.results
        pending = sorted(self.queue, key=lambda r: r.arrival_s)
        self.queue = []
        sessions = [self._make_session(p, pending) for p in self.pairs]
        self._sessions = sessions
        for pair, sess in zip(self.pairs, sessions):
            pair.session = sess
        self._served = [0] * len(self.pairs)
        clock = _ArrivalClock()
        # request_id -> (request, admit_start_s, first_token_s, pair_idx)
        in_flight: dict[int, tuple[ServeRequest, float, float, int]] = {}

        while pending or any(s.occupied for s in sessions):
            now = clock.now()
            arrived = [r for r in pending if r.arrival_s <= now]
            if (arrived and all(p.draining for p in self.pairs)
                    and not any(s.occupied for s in sessions)):
                raise RuntimeError(
                    "every pair is draining with requests still pending — "
                    "undrain a pair to keep serving")
            while arrived:
                frees = [0 if p.draining else len(s.free)
                         for p, s in zip(self.pairs, sessions)]
                if not any(frees):
                    break
                idx = self.router.route(arrived[0], self.pairs, frees)
                if frees[idx] <= 0:
                    break
                admitted_any = False
                for r in self._select_admissions(arrived, frees[idx]):
                    # block-aware admission: a paged session may have a
                    # free slot but not enough free KV blocks
                    if not sessions[idx].can_admit(len(r.prompt),
                                                   r.max_new_tokens):
                        continue
                    admit_start = clock.now()
                    sessions[idx].admit(r.prompt, r.max_new_tokens,
                                        request_id=r.request_id)
                    in_flight[r.request_id] = (r, admit_start, clock.now(),
                                               idx)
                    pending.remove(r)
                    arrived.remove(r)
                    self._served[idx] += 1
                    admitted_any = True
                if not admitted_any:
                    break  # no capacity progress — decode to free blocks
            if not any(s.occupied for s in sessions):
                clock.wait_until(min(r.arrival_s for r in pending))
                continue
            # q_depth: requests that have ARRIVED and wait for a slot
            q_depth = len(arrived) / max(1, 4 * self.cfg.max_batch)
            for idx, sess in enumerate(sessions):
                if not sess.occupied:
                    continue
                sess.run_chunk(self.pairs[idx].policy, q_depth=q_depth)
                for j in sess.finished_slots():
                    tokens, rec = sess.retire(j)
                    r, admit_s, first_tok_s, _ = in_flight.pop(rec.request_id)
                    end_s = clock.now()
                    n = len(tokens)
                    bits = rec.bits
                    ttft = (first_tok_s - r.arrival_s) * 1e3
                    tpot = (end_s - first_tok_s) * 1e3 / max(1, n - 1)
                    self._ttft_q[idx].push(ttft)
                    self._tpot_q[idx].push(tpot)
                    self.results.append(ServeResult(
                        request_id=r.request_id, tokens=tokens,
                        ttft_ms=ttft, tpot_ms=tpot,
                        e2e_ms=(end_s - r.arrival_s) * 1e3,
                        acceptance_rate=(sum(bits) / len(bits)) if bits
                        else 0.0,
                        queue_ms=(admit_s - r.arrival_s) * 1e3,
                        pair_id=self.pairs[idx].pair_id))
        return self.results

    # -- per-pair observability ----------------------------------------------

    def pair_summaries(self) -> dict[str, dict]:
        """Per-pair operating point after :meth:`run`, keyed by pair id:
        request/iteration counts, mean effective γ, fused fraction,
        acceptance, the pipelined mode's hit counters (0 until it is
        ported), the unhidden link ms, rolling p50/p95 TTFT/TPOT (NaN until
        a retirement lands), for paged sessions the free KV blocks, and —
        when the pair has a transport — its link stats (bytes, messages,
        measured RTT)."""
        out: dict[str, dict] = {}
        for i, (pair, sess, served) in enumerate(zip(self.pairs,
                                                     self._sessions,
                                                     self._served)):
            d = {
                "requests": served,
                "iterations": sess.iterations,
                "mean_gamma": round(sess.mean_gamma, 3),
                "fused_fraction": round(
                    sess.fused_iterations / max(1, sess.iterations), 4),
                "acceptance_rate": round(
                    sess.accepted / max(1, sess.proposed), 4),
                "pipeline_hits": sess.pipeline_hits,
                "pipeline_misses": sess.pipeline_misses,
                "link_ms": round(sess.link_ms, 2),
                "mode_policy": pair.mode_policy,
                "ttft_p50_ms": round(self._ttft_q[i].p50(), 3),
                "ttft_p95_ms": round(self._ttft_q[i].p95(), 3),
                "tpot_p50_ms": round(self._tpot_q[i].p50(), 3),
                "tpot_p95_ms": round(self._tpot_q[i].p95(), 3),
            }
            fb = sess.free_kv_blocks()
            if fb is not None:
                d["free_kv_blocks"] = fb
            tr = pair.transport
            if tr is not None:
                d.update(
                    transport=tr.describe(),
                    bytes_sent=tr.bytes_sent,
                    messages=tr.messages_sent,
                    recent_rtt_ms=round(tr.recent_rtt_ms, 3))
            out[pair.pair_id] = d
        return out
