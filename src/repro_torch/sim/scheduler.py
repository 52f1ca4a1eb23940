"""DSD scheduler — the request lifecycle engine of DSD-Sim (paper §3.3–3.4).

Each request progresses through **Routing → Batching → Speculation →
Verification**, iterating speculation/verification until the target-decided
output length is reached. Draft devices and target servers are concurrent
processes (our SimPy-equivalent, :mod:`repro_torch.sim.events`); network links are
delay elements; per-kernel latencies come from the hardware modeling engine
(:mod:`repro_torch.sim.hwmodel`) behind the ``predict(op, shape, hardware)`` API.

Execution modes (paper §3.3):

- **Distributed** — the edge drafter generates γ tokens sequentially, ships
  them to its routed target server, which verifies the window in one batched
  forward; acceptance outcomes are replayed from the trace's ground-truth
  ``acceptance_seq`` (no probabilistic acceptance model).
- **Fused** — cloud-only: the target generates tokens autoregressively in
  chunks with no drafter and no per-window network hop (γ≤1 under AWC
  hysteresis lands here).
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Any, Optional

from .events import Environment, Store
from .network import (DEFAULT_FUSED_CHUNK, Link, LinkSpec,
                      verdict_payload_bytes, window_payload_bytes)
from .hwmodel import HardwareModel, MODELS
from .policies import (BatchingConfig, BatchingPolicy, FIFOBatching,
                       PairRoutingPolicy, RoutingPolicy, RandomRouting,
                       SimPairView)
from .analyzer import Analyzer, RequestMetrics
from .trace import AcceptanceCursor, TraceRecord
from ..core.window import StaticWindowPolicy, WindowPolicy


# --------------------------------------------------------------------------
# Cluster description
# --------------------------------------------------------------------------

@dataclass
class ClusterSpec:
    """An edge pool of drafters plus a cloud pool of target servers.

    Heterogeneity (paper §5.2: cloud pool of LLaMA2-70B/LLaMA3-70B/Qwen-72B
    on A100/H100/A6000; edge pool of 300 A40 + 300 V100 serving three draft
    models): ``target_pool`` / ``draft_pool`` assign (hw, model[, tp]) per
    server round-robin; when None the homogeneous fields apply. Per-pair
    draft quality (acceptance multiplier vs the trace's base acceptance
    stream) comes from DRAFT_QUALITY — heterogeneous pairs are exactly what
    gives per-pair adaptive window control its edge.
    """
    num_targets: int = 4
    target_hw: str = "A100"
    target_model: str = "llama2-70b"
    target_tp: int = 4                  # tensor-parallel degree per server
    num_drafters: int = 64
    draft_hw: str = "A40"
    draft_model: str = "llama2-7b"
    link: LinkSpec = field(default_factory=LinkSpec)
    target_pool: Optional[list] = None    # [(hw, model, tp), ...]
    draft_pool: Optional[list] = None     # [(hw, model), ...]
    # Heterogeneous PER-PAIR links (multi-link topologies): when set,
    # drafter ``d`` always transfers over ``drafter_link_pool[d]``
    # regardless of routed target — the lane model
    # ``repro_torch.topology.build_simulation`` maps PairSpecs onto (drafter i
    # ⇔ pair i). When None, the per-target ``link`` applies to everyone.
    drafter_link_pool: Optional[list] = None   # [LinkSpec per drafter]

    def target_at(self, tid: int) -> tuple:
        if self.target_pool:
            return tuple(self.target_pool[tid % len(self.target_pool)])
        return (self.target_hw, self.target_model, self.target_tp)

    def draft_at(self, did: int) -> tuple:
        if self.draft_pool:
            return tuple(self.draft_pool[did % len(self.draft_pool)])
        return (self.draft_hw, self.draft_model)


# Relative acceptance quality per draft model (multiplier on the trace's
# ground-truth acceptance stream; captured pairs in §5 differ in how well
# the draft tracks the target).
DRAFT_QUALITY: dict[str, float] = {
    "llama2-7b": 1.0,
    "qwen-7b": 0.82,
    "llama3.1-8b": 1.12,
}

# The paper's heterogeneous pools (§5.2).
PAPER_TARGET_POOL = [("A100", "llama2-70b", 4),
                     ("H100", "qwen-72b", 4),
                     ("A6000", "llama3-70b", 4)]
PAPER_DRAFT_POOL = [("A40", "llama2-7b"), ("V100", "qwen-7b"),
                    ("A40", "llama3.1-8b"), ("V100", "llama2-7b"),
                    ("A40", "qwen-7b"), ("V100", "llama3.1-8b")]


@dataclass
class PolicyStack:
    routing: RoutingPolicy = field(default_factory=RandomRouting)
    batching: BatchingPolicy = field(default_factory=FIFOBatching)
    batching_cfg: BatchingConfig = field(default_factory=BatchingConfig)
    window: WindowPolicy = field(default_factory=StaticWindowPolicy)
    # arrival-time lane assignment for unpinned records (drafter_id < 0);
    # None = shallowest-queue (the real server's least-loaded default)
    pair_routing: Optional[PairRoutingPolicy] = None


@dataclass
class Job:
    """A unit of target-server work."""
    request_id: int
    kind: str                 # "verify" | "fused"
    context_len: int          # KV context already cached at the target
    new_tokens: int           # tokens computed this invocation (γ or prompt+γ)
    chunk: int = 0            # fused: autoregressive tokens to produce
    enqueue_ms: float = 0.0
    done: Any = None          # Event, resolved when the batch finishes
    sort_len: int = 0         # LAB batching key


def _quality_adjusted(bits: list[int], quality: float,
                      rng: random.Random) -> list[int]:
    """Scale a ground-truth acceptance stream for a draft of different
    quality: q<1 drops accepts, q>1 converts some rejects to accepts."""
    if abs(quality - 1.0) < 1e-9:
        return bits
    out = []
    for b in bits:
        if b == 1 and quality < 1.0:
            out.append(1 if rng.random() < quality else 0)
        elif b == 0 and quality > 1.0:
            out.append(1 if rng.random() < (quality - 1.0) else 0)
        else:
            out.append(b)
    return out


class DSDSimulation:
    """Wires workload records + cluster + policies into a runnable simulation."""

    def __init__(self, cluster: ClusterSpec, policies: PolicyStack,
                 records: list[TraceRecord],
                 hwmodel: Optional[HardwareModel] = None,
                 seed: int = 0, fused_chunk: int = DEFAULT_FUSED_CHUNK,
                 pipeline: bool = False):
        self.cluster = cluster
        self.policies = policies
        self.records = records
        self.hw = hwmodel or HardwareModel()
        self.fused_chunk = fused_chunk
        # cross-round pipelining: the drafter speculatively drafts window
        # k+1 (and ships it) while window k is being verified, mirroring
        # the real path's mode_policy="pipeline" overlap model
        self.pipeline = bool(pipeline)
        self.env = Environment()
        self.rng = random.Random(seed)
        self.analyzer = Analyzer(cluster.num_targets,
                                 queue_capacity_hint=policies.batching_cfg.max_batch * 4)
        self.links = [Link(self.env, cluster.link, random.Random(seed + 1 + t))
                      for t in range(cluster.num_targets)]
        # per-drafter links (heterogeneous pair topologies) override the
        # per-target links; each keeps its own RTT tracker so pair-local
        # rtt_recent_ms features stay isolated
        self.drafter_links = None
        if cluster.drafter_link_pool:
            self.drafter_links = [
                Link(self.env, spec, random.Random(seed + 101 + d))
                for d, spec in enumerate(cluster.drafter_link_pool)]
        self.target_queues: list[Store] = [Store(self.env)
                                           for _ in range(cluster.num_targets)]
        self.target_busy = [False] * cluster.num_targets
        self.drafter_queues: dict[int, Store] = {}
        self._drafter_started: set[int] = set()
        self.drafter_active: dict[int, int] = {}   # in-service per lane

    # -- public API ----------------------------------------------------------

    def run(self, until_ms: Optional[float] = None) -> Analyzer:
        for t in range(self.cluster.num_targets):
            self.env.process(self._target_proc(t))
        self.env.process(self._source_proc())
        self.env.run(until=until_ms)
        return self.analyzer

    # -- workload source -------------------------------------------------------

    def _source_proc(self):
        for rec in sorted(self.records, key=lambda r: r.arrival_time_ms):
            delay = rec.arrival_time_ms - self.env.now
            if delay > 0:
                yield self.env.timeout(delay)
            if rec.drafter_id < 0:
                # unpinned record: the pair router assigns the lane AT
                # ARRIVAL (the sim twin of the real server's PairRouter —
                # and, like it, sticky: the lane never changes afterwards)
                did = self._route_pair(rec)
            else:
                did = rec.drafter_id % max(1, self.cluster.num_drafters)
            q = self.drafter_queues.get(did)
            if q is None:
                q = self.drafter_queues[did] = Store(self.env)
            q.put(rec)
            if did not in self._drafter_started:
                self._drafter_started.add(did)
                self.env.process(self._drafter_proc(did))

    # -- arrival-time pair routing -------------------------------------------

    def _pinned_target(self, did: int) -> int:
        pinned = getattr(self.policies.routing, "target_of_drafter", None)
        if pinned:
            return pinned[did % len(pinned)]
        return did % max(1, self.cluster.num_targets)

    def _pair_view(self) -> SimPairView:
        nd = max(1, self.cluster.num_drafters)
        depths, rtts, alphas = [], [], []
        for d in range(nd):
            q = self.drafter_queues.get(d)
            depths.append((len(q) if q is not None else 0)
                          + self.drafter_active.get(d, 0))
            if self.drafter_links is not None:
                link = self.drafter_links[d % len(self.drafter_links)]
            else:
                link = self.links[self._pinned_target(d)]
            rtts.append(link.recent_rtt_ms)
            win = self.analyzer.alpha_recent.get(
                f"{d}->{self._pinned_target(d)}")
            alphas.append(win.mean() if win else 0.7)
        return SimPairView(queue_depths=depths, rtt_ms=rtts, alpha=alphas,
                           max_batch=self.policies.batching_cfg.max_batch)

    def _route_pair(self, rec: TraceRecord) -> int:
        view = self._pair_view()
        router = self.policies.pair_routing
        if router is None:      # least-loaded default, ties to lowest lane
            return min(range(len(view.queue_depths)),
                       key=lambda i: (view.queue_depths[i], i))
        did = router.route_pair(rec, view)
        return did % max(1, self.cluster.num_drafters)

    # -- edge drafter ------------------------------------------------------------

    def _drafter_proc(self, drafter_id: int):
        q = self.drafter_queues[drafter_id]
        while True:
            rec = yield q.get()
            self.drafter_active[drafter_id] = \
                self.drafter_active.get(drafter_id, 0) + 1
            yield self.env.process(self._serve_request(rec, drafter_id))
            self.drafter_active[drafter_id] -= 1

    def _queue_depths(self) -> list[int]:
        return [len(q) + (1 if self.target_busy[i] else 0)
                for i, q in enumerate(self.target_queues)]

    def _serve_request(self, rec: TraceRecord, drafter_id: int):
        cl, pol, env = self.cluster, self.policies, self.env
        target_id = pol.routing.route(rec, self._queue_depths())
        pair_key = f"{drafter_id}->{target_id}"
        if self.drafter_links is not None:
            link = self.drafter_links[drafter_id % len(self.drafter_links)]
        else:
            link = self.links[target_id]
        draft_hw, draft_model = cl.draft_at(drafter_id)
        quality = DRAFT_QUALITY.get(draft_model, 1.0)
        pair_rng = random.Random((rec.request_id << 16) ^ drafter_id)

        m = RequestMetrics(
            request_id=rec.request_id, dataset=rec.dataset,
            drafter_id=drafter_id, target_id=target_id,
            arrival_ms=rec.arrival_time_ms, prompt_length=rec.prompt_length,
            output_length=rec.output_length,
            request_class=rec.request_class or rec.dataset,
            slo_ttft_ms=rec.slo_ttft_ms, slo_tpot_ms=rec.slo_tpot_ms)
        self.analyzer.open_request(m)

        cursor = AcceptanceCursor(_quality_adjusted(
            rec.acceptance_seq, quality, pair_rng))
        # Draft-side prefill of the prompt (edge device is busy during it).
        yield env.timeout(self.hw.prefill_ms(
            draft_hw, draft_model, [rec.prompt_length]))

        generated = 0
        target_ctx = 0            # KV tokens cached on the target
        draft_ctx = rec.prompt_length
        gamma_prev = 4.0
        branches_prev = 1.0
        # cross-round pipelining: True when the previous window was fully
        # accepted, so this round's window was already drafted and shipped
        # during the previous verification (its draft scan + outbound hop
        # are hidden)
        pipelined_credit = False
        while generated < rec.output_length:
            feats = self.analyzer.features(pair_key, target_id,
                                           link.recent_rtt_ms, gamma_prev,
                                           branches_prev=branches_prev)
            dec = pol.window.decide(pair_key, feats)
            m.gamma_sequence.append(dec.gamma)
            m.mode_sequence.append(dec.mode)
            iter_start = env.now
            # TPOT is the TARGET's time-per-output-token (paper §4.1): the
            # sample excludes link time (RTT is its own feature —
            # double-counting it here would self-damp the controller), the
            # drafter's serial proposal time (not target service), and
            # target queue wait (featured separately as q_depth — the same
            # double-count argument applies).
            iter_link_ms = 0.0
            iter_draft_ms = 0.0
            queue_wait_0 = m.queue_wait_ms

            if dec.mode == "fused":
                chunk = min(self.fused_chunk, rec.output_length - generated)
                prefill_extra = rec.prompt_length if target_ctx == 0 else 0
                job = Job(request_id=rec.request_id, kind="fused",
                          context_len=max(target_ctx, rec.prompt_length),
                          new_tokens=prefill_extra, chunk=chunk,
                          done=env.event(), sort_len=target_ctx + generated)
                # read last_delay_ms before yielding — the link is shared
                # and another drafter's transfer would clobber it
                ev = link.transfer(64)
                iter_link_ms += link.last_delay_ms
                yield ev
                self._enqueue(target_id, job)
                yield job.done
                ev = link.transfer(64)
                iter_link_ms += link.last_delay_ms
                link.record_rtt(iter_link_ms)   # explicit out+back pair
                yield ev
                produced = chunk
                target_ctx = rec.prompt_length + generated + chunk
                generated += chunk
                draft_ctx = rec.prompt_length + generated
                gamma_prev = 1.0
                branches_prev = 1.0
                pipelined_credit = False   # fused rounds speculate nothing
            else:
                gamma = dec.gamma
                # tree speculation: b > 1 widens the window to the
                # (γ, b) grid — the draft scan stays γ serial steps
                # (branches advance in LOCKSTEP, one masked pass per
                # depth), but the wire pays per NODE and the verify pass
                # computes the whole grid. Pipelining keeps b = 1 (the
                # real path forbids the combination too).
                branches = max(1, int(getattr(dec, "branches", 1)))
                if self.pipeline:
                    branches = 1
                n_nodes = 1 + gamma * branches
                out_bytes = (window_payload_bytes(gamma, n_nodes=n_nodes)
                             if branches > 1 else window_payload_bytes(gamma))
                per_step = self.hw.decode_ms(draft_hw, draft_model,
                                             [draft_ctx])
                draft_scan_ms = gamma * per_step
                if self.pipeline and pipelined_credit:
                    # this window was drafted AND shipped while the
                    # previous window was being verified: neither the
                    # draft scan nor the outbound hop costs time here —
                    # the bytes still crossed the wire
                    d_out = link.charge(out_bytes)
                else:
                    iter_draft_ms = draft_scan_ms
                    yield env.timeout(draft_scan_ms)
                    ev = link.transfer(out_bytes)
                    d_out = link.last_delay_ms
                    iter_link_ms += d_out
                    yield ev
                prefill_extra = rec.prompt_length if target_ctx == 0 else 0
                job = Job(request_id=rec.request_id, kind="verify",
                          context_len=target_ctx,
                          new_tokens=prefill_extra + gamma * branches,
                          done=env.event(), sort_len=target_ctx + prefill_extra)
                self._enqueue(target_id, job)
                yield job.done
                if self.pipeline:
                    n_acc, all_acc = cursor.consume(gamma)
                    # the NEXT window's speculative draft scan overlaps the
                    # verdict's return flight; on a full accept (hit) the
                    # round's residual exposure is max(draft, return hop),
                    # on a partial accept (miss) the optimistic draft is
                    # wasted work the flight already hid and the fresh
                    # re-draft is paid by the next (unpipelined) round
                    d_back = link.charge(verdict_payload_bytes(gamma))
                    link.record_rtt(d_out + d_back)
                    produced = min(n_acc + 1, rec.output_length - generated)
                    continuing = generated + produced < rec.output_length
                    # the speculative draft only happens when another
                    # window will follow (the real path's opt_done guard):
                    # a terminal all-accept pays just the return hop
                    hit = all_acc and continuing
                    pay_ms = max(draft_scan_ms, d_back) if hit else d_back
                    iter_link_ms += d_back
                    iter_draft_ms += pay_ms - d_back
                    yield env.timeout(pay_ms)
                    if continuing:
                        self.analyzer.record_pipeline(pair_key, all_acc)
                    pipelined_credit = hit
                else:
                    ev = link.transfer(verdict_payload_bytes(gamma))
                    iter_link_ms += link.last_delay_ms
                    link.record_rtt(d_out + link.last_delay_ms)
                    yield ev
                    n_acc, _all = cursor.consume(gamma)
                    if branches > 1 and n_acc == 0:
                        # branch-decay rescue replay (mirrors
                        # core.tree.tree_expected_accepted): the primary
                        # chain died at its root, so an alternative root
                        # — the draft's k-th-best token — gets its shot
                        # with per-rank-decayed probability; a rescued
                        # branch contributes its root plus a fresh
                        # (γ−1)-deep chain from the acceptance stream
                        r = 0.4 * min(0.98, max(0.02, feats.alpha_recent))
                        rescue_p = 1.0 - (1.0 - r) ** (branches - 1)
                        if pair_rng.random() < rescue_p:
                            n_tail = (cursor.consume(gamma - 1)[0]
                                      if gamma > 1 else 0)
                            n_acc = 1 + n_tail
                    produced = min(n_acc + 1, rec.output_length - generated)
                generated += produced
                target_ctx = rec.prompt_length + generated
                draft_ctx = rec.prompt_length + generated
                m.draft_tokens_proposed += gamma
                m.draft_tokens_accepted += n_acc
                self.analyzer.record_acceptance(pair_key, gamma, n_acc)
                gamma_prev = float(gamma)
                branches_prev = float(branches)

            m.iterations += 1
            m.tokens_generated += produced
            if math.isnan(m.first_token_ms):
                m.first_token_ms = env.now
            if produced > 0:
                iter_queue_ms = m.queue_wait_ms - queue_wait_0
                self.analyzer.record_tpot_sample(
                    max(0.0, env.now - iter_start - iter_link_ms
                        - iter_draft_ms - iter_queue_ms) / produced)

        self.analyzer.close_request(rec.request_id, env.now)

    # -- cloud target server -------------------------------------------------------

    def _enqueue(self, target_id: int, job: Job) -> None:
        job.enqueue_ms = self.env.now
        self.analyzer.queue_depth[target_id] += 1
        self.target_queues[target_id].put(job)

    def _target_proc(self, tid: int):
        cl, env = self.cluster, self.env
        q = self.target_queues[tid]
        cfg = self.policies.batching_cfg
        while True:
            head = yield q.get()
            self.analyzer.queue_depth[tid] -= 1
            if cfg.batch_window_ms > 0 and len(q) < cfg.max_batch - 1:
                yield env.timeout(cfg.batch_window_ms)
            batch = self._form_batch(tid, head, cfg)
            self.target_busy[tid] = True
            wait = sum(env.now - j.enqueue_ms for j in batch)
            self.analyzer.net_queue_delay_ms += wait
            for j in batch:
                rm = self.analyzer.requests.get(j.request_id)
                if rm:
                    rm.queue_wait_ms += env.now - j.enqueue_ms

            latency_ms = self._batch_latency_ms(batch, tid)
            yield env.timeout(latency_ms)
            self.target_busy[tid] = False
            self.analyzer.record_batch(tid, len(batch), latency_ms)
            for j in batch:
                j.done.succeed()

    def _form_batch(self, tid: int, head: Job, cfg: BatchingConfig) -> list[Job]:
        """Apply the batching policy over same-kind queued jobs only."""
        q = self.target_queues[tid]
        other_kind = [j for j in q.items if j.kind != head.kind]
        same_kind = [j for j in q.items if j.kind == head.kind]
        q.items.clear()
        q.items.extend(same_kind)
        batch = self.policies.batching.form_batch(q, head, cfg)
        taken = len(same_kind) - len(q.items)
        self.analyzer.queue_depth[tid] -= taken
        # restore non-matching jobs at the front, preserving arrival order
        for j in reversed(other_kind):
            q.items.appendleft(j)
        return batch

    def _batch_latency_ms(self, batch: list[Job], tid: int = 0) -> float:
        cl = self.cluster
        t_hw, t_model, t_tp = cl.target_at(tid)
        if batch[0].kind == "verify":
            ctx = [j.context_len for j in batch]
            new = [max(1, j.new_tokens) for j in batch]
            if self.policies.batching_cfg.chunked_prefill:
                # chunked prefill caps per-pass prefill tokens; model as the
                # same total compute (chunks are serialized inside the pass)
                chunk = self.policies.batching_cfg.prefill_chunk
                new = [min(n, chunk) if n > chunk else n for n in new]
                extra = sum(max(0, j.new_tokens - chunk) for j in batch)
                base = self.hw.decode_ms(t_hw, t_model, ctx, new, tp=t_tp)
                if extra > 0:
                    base += self.hw.prefill_ms(t_hw, t_model, [extra],
                                               tp=t_tp)
                return base
            return self.hw.decode_ms(t_hw, t_model, ctx, new, tp=t_tp)
        # fused: sequential autoregressive chunk on the target
        steps = max(j.chunk for j in batch)
        ctx = [j.context_len for j in batch]
        prefill = sum(j.new_tokens for j in batch)
        per_step = self.hw.decode_ms(t_hw, t_model, ctx, tp=t_tp)
        total = steps * per_step
        if prefill > 0:
            total += self.hw.prefill_ms(t_hw, t_model, [prefill], tp=t_tp)
        return total
