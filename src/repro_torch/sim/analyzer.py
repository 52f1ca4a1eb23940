"""Performance analyzer for DSD-Sim (paper §3.5).

Collects the two metric families the paper defines and serves the rolling
feature snapshots that window policies (notably AWC) consume:

- **Per-request**: TTFT, TPOT, end-to-end latency, acceptance ratio, routing
  decision, and the per-iteration γ decision sequence.
- **System-level**: throughput, per-target utilization, aggregate network
  queueing delay.

Everything is emitted as structured JSON (``to_json``), usable both for
offline analysis and as AWC training input.
"""

from __future__ import annotations

import json
import math
from collections import deque
from dataclasses import dataclass, field, asdict
from typing import Any, Optional


@dataclass
class RequestMetrics:
    request_id: int
    dataset: str
    drafter_id: int
    target_id: int
    arrival_ms: float
    prompt_length: int
    output_length: int
    first_token_ms: float = math.nan      # absolute time of first verified token
    finish_ms: float = math.nan
    tokens_generated: int = 0
    draft_tokens_proposed: int = 0
    draft_tokens_accepted: int = 0
    iterations: int = 0
    gamma_sequence: list[int] = field(default_factory=list)
    mode_sequence: list[str] = field(default_factory=list)
    queue_wait_ms: float = 0.0            # total time spent in target queues
    request_class: str = ""               # fleet traffic class ("" = dataset)
    slo_ttft_ms: float = 0.0              # per-request TTFT target (0 = none)
    slo_tpot_ms: float = 0.0              # per-request TPOT target (0 = none)

    @property
    def ttft_ms(self) -> float:
        return self.first_token_ms - self.arrival_ms

    @property
    def e2e_ms(self) -> float:
        return self.finish_ms - self.arrival_ms

    @property
    def tpot_ms(self) -> float:
        n = max(1, self.tokens_generated - 1)
        return (self.finish_ms - self.first_token_ms) / n

    @property
    def acceptance_rate(self) -> float:
        return self.draft_tokens_accepted / max(1, self.draft_tokens_proposed)


def _percentile(sorted_vals: list[float], p: float) -> float:
    if not sorted_vals:
        return math.nan
    k = (len(sorted_vals) - 1) * p
    lo, hi = int(math.floor(k)), int(math.ceil(k))
    if lo == hi:
        return sorted_vals[lo]
    return sorted_vals[lo] + (sorted_vals[hi] - sorted_vals[lo]) * (k - lo)


class RollingWindow:
    """Fixed-size rolling mean used for the AWC feature snapshots."""

    def __init__(self, size: int = 64, default: float = 0.0):
        self.buf: deque[float] = deque(maxlen=size)
        self.default = default

    def push(self, v: float) -> None:
        self.buf.append(v)

    def mean(self) -> float:
        if not self.buf:
            return self.default
        return sum(self.buf) / len(self.buf)


class Analyzer:
    """Central metric sink + rolling feature provider."""

    def __init__(self, num_targets: int, queue_capacity_hint: int = 64):
        self.requests: dict[int, RequestMetrics] = {}
        self.num_targets = num_targets
        self.queue_capacity_hint = queue_capacity_hint
        # rolling state for features
        self.alpha_recent: dict[str, RollingWindow] = {}
        self.pipe_recent: dict[str, RollingWindow] = {}
        self.pipeline_hits = 0
        self.pipeline_misses = 0
        self.tpot_recent = RollingWindow(size=128, default=50.0)
        self.queue_depth: list[int] = [0] * num_targets
        self.busy_ms: list[float] = [0.0] * num_targets
        self.batch_sizes: list[int] = []
        self.net_queue_delay_ms: float = 0.0
        self._first_arrival: Optional[float] = None
        self._last_finish: float = 0.0
        self.completed = 0

    # -- recording ----------------------------------------------------------

    def open_request(self, m: RequestMetrics) -> None:
        self.requests[m.request_id] = m
        if self._first_arrival is None or m.arrival_ms < self._first_arrival:
            self._first_arrival = m.arrival_ms

    def record_acceptance(self, pair_key: str, proposed: int, accepted: int) -> None:
        win = self.alpha_recent.get(pair_key)
        if win is None:
            win = self.alpha_recent[pair_key] = RollingWindow(size=32, default=0.7)
        if proposed > 0:
            win.push(accepted / proposed)

    def record_pipeline(self, pair_key: str, hit: bool) -> None:
        """One resolved cross-round speculation: the optimistic window was
        kept (hit — its RTT was hidden) or rolled back (miss)."""
        win = self.pipe_recent.get(pair_key)
        if win is None:
            win = self.pipe_recent[pair_key] = RollingWindow(size=32,
                                                             default=0.0)
        win.push(1.0 if hit else 0.0)
        if hit:
            self.pipeline_hits += 1
        else:
            self.pipeline_misses += 1

    def record_batch(self, target_id: int, size: int, busy_ms: float) -> None:
        self.busy_ms[target_id] += busy_ms
        self.batch_sizes.append(size)

    def record_tpot_sample(self, ms_per_token: float) -> None:
        self.tpot_recent.push(ms_per_token)

    def close_request(self, request_id: int, finish_ms: float) -> None:
        m = self.requests[request_id]
        m.finish_ms = finish_ms
        self.completed += 1
        self._last_finish = max(self._last_finish, finish_ms)

    # -- feature snapshot (AWC §4.1) -----------------------------------------

    def features(self, pair_key: str, target_id: int, rtt_recent_ms: float,
                 gamma_prev: float,
                 branches_prev: float = 1.0) -> "FeatureTuple":
        from ..core.window import FeatureSnapshot
        depth = self.queue_depth[target_id] / max(1, self.queue_capacity_hint)
        alpha = self.alpha_recent.get(pair_key)
        pipe = self.pipe_recent.get(pair_key)
        return FeatureSnapshot(
            q_depth=depth,
            alpha_recent=alpha.mean() if alpha else 0.7,
            rtt_recent_ms=rtt_recent_ms,
            tpot_recent_ms=self.tpot_recent.mean(),
            gamma_prev=gamma_prev,
            pipe_hit_recent=pipe.mean() if pipe else 0.0,
            branches_prev=branches_prev,
        )

    # -- summary --------------------------------------------------------------

    def summary(self) -> dict[str, Any]:
        done = [m for m in self.requests.values() if not math.isnan(m.finish_ms)]
        ttft = sorted(m.ttft_ms for m in done if not math.isnan(m.first_token_ms))
        tpot = sorted(m.tpot_ms for m in done if m.tokens_generated > 1)
        e2e = sorted(m.e2e_ms for m in done)
        span_ms = (self._last_finish - (self._first_arrival or 0.0)) or 1.0
        total_busy = sum(self.busy_ms)
        util = total_busy / (self.num_targets * span_ms) if span_ms > 0 else 0.0
        prop = sum(m.draft_tokens_proposed for m in done)
        acc = sum(m.draft_tokens_accepted for m in done)
        # SLO attainment over requests that carry an SLO (graded with the
        # same repro_torch.fleet.workload.slo_report rule the real server's
        # results are graded with, so attainment is comparable sim↔real);
        # lazy import — fleet.workload has no sim dependency at module level
        from ..fleet.workload import slo_report
        slo = slo_report([
            {"request_class": m.request_class or m.dataset,
             "slo_ttft_ms": m.slo_ttft_ms, "slo_tpot_ms": m.slo_tpot_ms,
             "ttft_ms": m.ttft_ms, "tpot_ms": m.tpot_ms}
            for m in done])
        return {
            "completed": len(done),
            "throughput_rps": len(done) / (span_ms / 1e3),
            "token_throughput_tps":
                sum(m.tokens_generated for m in done) / (span_ms / 1e3),
            "ttft_ms": {"mean": sum(ttft) / len(ttft) if ttft else math.nan,
                        "p50": _percentile(ttft, 0.5),
                        "p99": _percentile(ttft, 0.99)},
            "tpot_ms": {"mean": sum(tpot) / len(tpot) if tpot else math.nan,
                        "p50": _percentile(tpot, 0.5),
                        "p99": _percentile(tpot, 0.99)},
            "e2e_ms": {"mean": sum(e2e) / len(e2e) if e2e else math.nan,
                       "p50": _percentile(e2e, 0.5)},
            "acceptance_rate": acc / max(1, prop),
            "slo": slo,
            "target_utilization": util,
            "mean_batch_size":
                sum(self.batch_sizes) / len(self.batch_sizes)
                if self.batch_sizes else 0.0,
            "net_queue_delay_ms": self.net_queue_delay_ms,
            "pipeline_hits": self.pipeline_hits,
            "pipeline_misses": self.pipeline_misses,
            "mean_gamma":
                (sum(sum(m.gamma_sequence) for m in done)
                 / max(1, sum(len(m.gamma_sequence) for m in done))),
        }

    def to_json(self, path: Optional[str] = None) -> str:
        payload = {
            "summary": self.summary(),
            "requests": [
                {**asdict(m),
                 "ttft_ms": m.ttft_ms, "tpot_ms": m.tpot_ms, "e2e_ms": m.e2e_ms,
                 "acceptance_rate": m.acceptance_rate}
                for m in self.requests.values()
                if not math.isnan(m.finish_ms)
            ],
        }
        blob = json.dumps(payload, indent=1)
        if path:
            with open(path, "w") as f:
                f.write(blob)
        return blob
