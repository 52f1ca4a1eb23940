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
runs its rounds as draft→verify→verdict exchanges over it (half-duplex, or
pipelined with ``mode_policy="pipeline"``);
:meth:`SpecDecodeServer.pair_summaries` then reports its link (bytes,
messages, measured RTT, unhidden link ms) and its pipeline hits and misses.

A **process-backed** pair (``PairSpec.process``) has no engine here: its
``host`` (:class:`repro_torch.distributed.host.PairHostHandle`) drives a
draft and a target worker process over a socket transport, and the server
hands it the pair's share of the stream on a thread of its own, wave by
wave (:meth:`SpecDecodeServer._run_process_backed`).

Fleet traffic (:mod:`repro_torch.fleet`): a request may carry a class and
TTFT/TPOT SLOs, and its result carries them back for ``slo_report``.
``ServerConfig.slo_admission`` gates the head-of-line request between
routing and admission: when the routed pair's rolling p95 TTFT (over the
last ``slo_window`` retirements, once ``slo_min_samples`` are in) has
drifted past the request's TTFT SLO, the request goes to the healthiest
pair instead (``reroute``), or, with no healthy pair and ``shed``, is
dropped with a zero-token result marked ``shed``. The α/link/queue-aware
router :class:`~repro_torch.fleet.routing.SmartPairRouter` registers as
``PAIR_ROUTERS["smart"]``.

:class:`WaveSpecDecodeServer` keeps the wave-batched execution model (admit
a wave, drain it, admit the next) as the measured baseline.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Protocol, Sequence

import numpy as np

from ..core.engine import SpecDecodeEngine
from ..core.session import DecodeSession
from ..core.window import StaticWindowPolicy, WindowPolicy
from ..fleet.stats import RollingQuantile


@dataclass
class ServeRequest:
    request_id: int
    prompt: np.ndarray           # (S,) int32
    max_new_tokens: int
    arrival_s: float = 0.0       # relative to the serve-loop start
    request_class: str = ""      # fleet traffic class ("" = unclassified)
    slo_ttft_ms: float = 0.0     # per-request TTFT target (0 = no SLO)
    slo_tpot_ms: float = 0.0     # per-request TPOT target (0 = no SLO)


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
    request_class: str = ""      # carried from the request (SLO grading)
    slo_ttft_ms: float = 0.0
    slo_tpot_ms: float = 0.0
    shed: bool = False           # SLO admission dropped it (no tokens)


def open_session(cfg: ServerConfig, pair: "ServingPair",
                 pending: Sequence[ServeRequest]) -> DecodeSession:
    """A slot-pool session for one pair serving ``pending``: ``max_batch``
    slots, the config's output width and prompt pad bound, else the
    queue's maxima (the pad bound rounded up to ``pad_to``). Its device
    side is the engine's pool of that geometry, so a later run of the same
    geometry replays the graphs this one captured."""
    q = cfg.pad_to
    mp = cfg.max_prompt_len or max(len(r.prompt) for r in pending)
    cap = cfg.max_new_cap or max(r.max_new_tokens for r in pending)
    eng = pair.engine
    return DecodeSession(eng, capacity=cfg.max_batch, max_new_cap=cap,
                         max_prompt_len=((mp + q - 1) // q) * q,
                         gamma_max=eng.gamma_max
                         or eng._policy_gamma_bound(pair.policy),
                         sync_every=cfg.sync_every, eos_id=cfg.eos_id,
                         log_gamma=False, mode_policy=pair.mode_policy,
                         transport=pair.transport, pair_key=pair.pair_id,
                         paged=cfg.paged_kv, kv_block_size=cfg.kv_block_size,
                         kv_pool_blocks=cfg.kv_pool_blocks,
                         kv_quantize=cfg.kv_quantize, capture=cfg.capture)


@dataclass
class ServingPair:
    """One deployed draft→target lane: engine + window policy + mode.
    ``pair_id`` doubles as the window policy's pair key. A process-backed
    pair carries no engine or transport: ``host`` (a
    :class:`repro_torch.distributed.host.PairHostHandle`) serves its share
    of the stream."""
    pair_id: str
    engine: Optional[SpecDecodeEngine]
    policy: WindowPolicy
    transport: Optional[object] = None   # repro_torch.distributed.Transport
    mode_policy: str = "auto"            # auto | distributed | fused |
                                         # pipeline
    host: Optional[object] = None        # distributed.host.PairHostHandle
    session: Optional[DecodeSession] = None  # the last run's session
                                             # (closed when run() ends)
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
    slo_admission: str = "off"   # off | reroute | shed: when a pair's rolling
                                 # p95 TTFT drifts past a request's class SLO,
                                 # reroute it to a healthy pair (or shed it
                                 # outright when none exists and mode=shed)
    slo_min_samples: int = 8     # retirements per pair before SLO admission
                                 # trusts that pair's rolling p95
    slo_window: int = 256        # rolling-quantile window size per pair


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

# the α/link/queue-aware fleet router registers here too (late import:
# repro_torch.fleet.routing is dependency-free, so this cannot cycle)
from ..fleet.routing import SmartPairRouter  # noqa: E402
PAIR_ROUTERS["smart"] = SmartPairRouter


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
        hosted = [p.host is not None for p in pairs]
        assert all(hosted) or not any(hosted), \
            "process-backed and in-process pairs cannot mix in one server"
        assert all(p.engine is not None or p.host is not None
                   for p in pairs), \
            "every pair needs an engine (in-process) or a host (process)"
        self._process_backed = any(hosted)
        self.pairs = list(pairs)
        self.router = router or LeastLoadedPairRouter()
        self.engine = self.pairs[0].engine
        self.policy = self.pairs[0].policy
        self.queue: list[ServeRequest] = []
        self.results: list[ServeResult] = []
        self._sessions: list[DecodeSession] = []
        self._served = [0] * len(self.pairs)
        self._ttft_q = [RollingQuantile(self.cfg.slo_window)
                        for _ in self.pairs]
        self._tpot_q = [RollingQuantile(self.cfg.slo_window)
                        for _ in self.pairs]
        self._shed = [0] * len(self.pairs)

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

    def run(self) -> list[ServeResult]:
        """Drain the submitted stream; returns per-request results.

        Per cycle: route + admit arrived requests into free slots (the
        head-of-line request picks its pair via the router, LAB/FIFO
        co-admission fills that pair's remaining slots) → run one decode
        chunk per occupied pair → retire finished slots. With nothing in
        flight the loop idles to the next arrival. The pairs' sessions are
        closed at the end, so their pools serve the next run."""
        if not self.queue:
            return self.results
        if self._process_backed:
            return self._run_process_backed()
        pending = sorted(self.queue, key=lambda r: r.arrival_s)
        self.queue = []
        sessions = [open_session(self.cfg, p, pending) for p in self.pairs]
        self._sessions = sessions
        for pair, sess in zip(self.pairs, sessions):
            pair.session = sess
        try:
            return self._serve(pending, sessions)
        finally:
            for sess in sessions:
                sess.close()

    def _serve(self, pending: list[ServeRequest],
               sessions: list[DecodeSession]) -> list[ServeResult]:
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
                routed = self._apply_slo_admission(arrived, pending, idx,
                                                   frees, clock)
                if routed is None:
                    continue    # head shed; retry with the next head
                idx = routed
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
                        pair_id=self.pairs[idx].pair_id,
                        request_class=r.request_class,
                        slo_ttft_ms=r.slo_ttft_ms,
                        slo_tpot_ms=r.slo_tpot_ms))
        return self.results

    # -- SLO-aware admission -------------------------------------------------

    def _slo_risky(self, idx: int, req: ServeRequest) -> bool:
        """Pair idx's rolling p95 TTFT has drifted past the request's SLO
        (only once enough retirements have been observed to trust it)."""
        if req.slo_ttft_ms <= 0:
            return False
        q = self._ttft_q[idx]
        return (len(q) >= self.cfg.slo_min_samples
                and q.p95() > req.slo_ttft_ms)

    def _apply_slo_admission(self, arrived: list[ServeRequest],
                             pending: list[ServeRequest], idx: int,
                             frees: Sequence[int],
                             clock: _ArrivalClock) -> Optional[int]:
        """SLO gate between routing and admission for the head-of-line
        request. Returns the (possibly rerouted) pair index, or None when
        the head was shed (mode=shed, no healthy pair). With
        ``slo_admission='off'`` this is the identity on ``idx``."""
        if self.cfg.slo_admission == "off":
            return idx
        head = arrived[0]
        if not self._slo_risky(idx, head):
            return idx
        # healthiest alternative with a free slot: unmeasured pairs count
        # as healthy (no evidence of drift), measured ones need p95 <= SLO
        best, best_p95 = None, None
        for i in range(len(self.pairs)):
            if i == idx or frees[i] <= 0 or self._slo_risky(i, head):
                continue
            p95 = self._ttft_q[i].p95()
            key = p95 if len(self._ttft_q[i]) else 0.0
            if best_p95 is None or key < best_p95:
                best, best_p95 = i, key
        if best is not None:
            return best
        if self.cfg.slo_admission != "shed":
            return idx      # reroute mode: nowhere better, admit anyway
        end_s = clock.now()
        self._shed[idx] += 1
        pending.remove(head)
        arrived.remove(head)
        self.results.append(ServeResult(
            request_id=head.request_id, tokens=np.zeros(0, np.int32),
            ttft_ms=float("inf"), tpot_ms=0.0,
            e2e_ms=(end_s - head.arrival_s) * 1e3, acceptance_rate=0.0,
            queue_ms=(end_s - head.arrival_s) * 1e3,
            pair_id=self.pairs[idx].pair_id,
            request_class=head.request_class,
            slo_ttft_ms=head.slo_ttft_ms, slo_tpot_ms=head.slo_tpot_ms,
            shed=True))
        return None

    def _run_process_backed(self) -> list[ServeResult]:
        """Drive process-backed pairs CONCURRENTLY: each pair's host handle
        serves its round-robin share of the stream on its own thread, so
        the pairs' worker processes decode in parallel. Wave batching per
        pair (the continuous chunk scheduler needs an in-process
        session)."""
        import threading

        pending = sorted(self.queue, key=lambda r: r.arrival_s)
        self.queue = []
        buckets: list[list[ServeRequest]] = [[] for _ in self.pairs]
        for i, r in enumerate(pending):
            buckets[i % len(self.pairs)].append(r)
        self._served = [len(b) for b in buckets]
        per_pair: list[list] = [[] for _ in self.pairs]
        errors: list[BaseException] = []

        def drive(idx: int) -> None:
            try:
                per_pair[idx] = self.pairs[idx].host.serve(buckets[idx])
            except BaseException as e:   # surface on the caller's thread
                errors.append(e)

        threads = [threading.Thread(target=drive, args=(i,), daemon=True)
                   for i in range(len(self.pairs)) if buckets[i]]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        merged = sorted((res for bucket in per_pair for res in bucket),
                        key=lambda res: res.request_id)
        self.results.extend(merged)
        return self.results

    # -- per-pair observability ----------------------------------------------

    def pair_summaries(self) -> dict[str, dict]:
        """Per-pair operating point after :meth:`run`, keyed by pair id:
        request/iteration counts, mean effective γ, fused fraction,
        acceptance, the pipelined mode's hits and misses, the unhidden link
        ms, rolling p50/p95 TTFT/TPOT over the last ``slo_window``
        retirements (the windows SLO admission consults; NaN until a
        retirement lands), the requests SLO admission shed, for
        paged sessions the free KV blocks, and — when the pair has a
        transport — its link stats (bytes, messages, measured RTT). A
        process-backed pair reports its host's row
        (:meth:`~repro_torch.distributed.host.PairHostHandle.summary`)."""
        out: dict[str, dict] = {}
        if self._process_backed:
            for pair, served in zip(self.pairs, self._served):
                row = pair.host.summary()
                row["requests"] = served
                out[pair.pair_id] = row
            return out
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
                "speculative_windows": sess.speculative_windows,
                "link_ms": round(sess.link_ms, 2),
                "mode_policy": pair.mode_policy,
                "ttft_p50_ms": round(self._ttft_q[i].p50(), 3),
                "ttft_p95_ms": round(self._ttft_q[i].p95(), 3),
                "tpot_p50_ms": round(self._tpot_q[i].p50(), 3),
                "tpot_p95_ms": round(self._tpot_q[i].p95(), 3),
                "shed": self._shed[i],
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
                    discarded_windows=tr.discarded_messages,
                    recent_rtt_ms=round(tr.recent_rtt_ms, 3))
            out[pair.pair_id] = d
        return out


def wave_results(wave: Sequence[ServeRequest], rows: Sequence[tuple],
                 wave_t0: float, first_tok_s: float, wave_t1: float,
                 pair_id: str = "") -> list[ServeResult]:
    """Per-request results of one drained wave, on the serve loop's clock:
    ``rows[i]`` is request i's (committed tokens, acceptance bits), cut to
    its own budget; the wave's prefill end is every member's first-token
    time, decode time spreads per produced token, and queue wait counts in
    TTFT."""
    out = []
    for r, (tokens, bits) in zip(wave, rows):
        n = min(r.max_new_tokens, len(tokens))
        out.append(ServeResult(
            request_id=r.request_id, tokens=tokens[:n],
            ttft_ms=(first_tok_s - r.arrival_s) * 1e3,
            tpot_ms=(wave_t1 - first_tok_s) * 1e3 / max(1, n - 1),
            e2e_ms=(wave_t1 - r.arrival_s) * 1e3,
            acceptance_rate=(sum(bits) / len(bits)) if bits else 0.0,
            queue_ms=(wave_t0 - r.arrival_s) * 1e3, pair_id=pair_id))
    return out


class WaveSpecDecodeServer:
    """Wave-batched baseline: requests are admitted in waves of up to
    ``max_batch`` sequences (FIFO or LAB grouping), each wave decodes to
    the wave-max budget, and the next wave starts only when the whole wave
    has drained (the reference's ``WaveSpecDecodeServer``). Single-pair
    colocated only.

    The waves of a run share ONE :class:`DecodeSession` (slots, output
    width, prompt pad bound — from the config, else the queue's maxima):
    each wave admits into the retired slots through the session's insert
    step, and the session's steps are its pool's, so only the first wave
    of a geometry on the engine captures and every later wave, in this run
    or a later one, replays, as the reference's compiled wave program is
    reused."""

    def __init__(self, engine: SpecDecodeEngine,
                 window_policy: Optional[WindowPolicy] = None,
                 cfg: Optional[ServerConfig] = None):
        self.engine = engine
        self.policy = window_policy or StaticWindowPolicy(4)
        self.cfg = cfg or ServerConfig()
        self.queue: list[ServeRequest] = []
        self.results: list[ServeResult] = []
        self.session: Optional[DecodeSession] = None   # the last run's
                                                        # (closed after it)

    def submit(self, req: ServeRequest) -> None:
        self.queue.append(req)

    def _next_wave(self, arrived: list[ServeRequest]) -> list[ServeRequest]:
        head = arrived.pop(0)
        wave = [head]
        if self.cfg.length_aware:
            rest = sorted(arrived,
                          key=lambda r: abs(len(r.prompt) - len(head.prompt)))
            chosen = rest[: self.cfg.max_batch - 1]
            ids = {id(c) for c in chosen}
            arrived[:] = [r for r in arrived if id(r) not in ids]
            wave.extend(chosen)
        else:
            while arrived and len(wave) < self.cfg.max_batch:
                wave.append(arrived.pop(0))
        return wave

    def run(self) -> list[ServeResult]:
        """Drain the queue wave by wave; returns per-request results (see
        :func:`wave_results`). Every member of a wave is admitted with the
        wave-max budget and the wave runs at most that budget plus one
        chunk of rounds."""
        assert self.cfg.transport is None, \
            "transports need the continuous server"
        if not self.queue:
            return self.results
        pending = sorted(self.queue, key=lambda r: r.arrival_s)
        self.queue = []
        pair = ServingPair("engine", self.engine, self.policy,
                           mode_policy=self.cfg.mode_policy)
        self.session = open_session(self.cfg, pair, pending)
        with self.session as sess:
            self._waves(pending, sess)
        return self.results

    def _waves(self, pending: list[ServeRequest],
               sess: DecodeSession) -> None:
        clock = _ArrivalClock()
        while pending:
            now = clock.now()
            arrived = [r for r in pending if r.arrival_s <= now]
            if not arrived:
                clock.wait_until(min(r.arrival_s for r in pending))
                continue
            wave = self._next_wave(arrived)
            for r in wave:
                pending.remove(r)
            budget = max(r.max_new_tokens for r in wave)
            wave_t0 = clock.now()
            slots = [sess.admit(r.prompt, budget, request_id=r.request_id)
                     for r in wave]
            first_tok_s = clock.now()
            limit = sess.iterations + budget + sess.sync_every
            while sess.unfinished and sess.iterations < limit:
                sess.run_chunk(self.policy, max_iters=limit)
            rows = []
            for j in slots:
                tokens, rec = sess.retire(j)
                rows.append((tokens, rec.bits))
            self.results.extend(wave_results(wave, rows, wave_t0,
                                             first_tok_s, clock.now()))
