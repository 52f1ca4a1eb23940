"""Fleet workload subsystem: trace-driven, SLO-aware serving.

The paper's pitch is *agile* edge-cloud serving under real traffic; this
package is the workload/routing layer that makes traffic a first-class,
declarative input — the production-traffic rung of the ROADMAP:

- :mod:`repro_torch.fleet.workload` — :class:`RequestClass` (chat vs
  long-context vs batch-offline, each with length distributions and
  per-class TTFT/TPOT SLOs) and :class:`TraceSpec` (diurnal curves,
  bursts, replay of recorded arrivals), JSON round-trippable like
  :class:`repro_torch.topology.ClusterSpec` and consumable by BOTH DSD-Sim and
  the real multi-pair server from ONE seeded request stream;
- :mod:`repro_torch.fleet.routing` — α/link/queue-aware pair scoring shared by
  the real :class:`~repro_torch.serving.SpecDecodeServer` router and the sim's
  arrival-time pair router, so routing-policy *ordering* is comparable
  sim↔real;
- :mod:`repro_torch.fleet.stats` — bounded rolling-quantile windows (per-pair
  p50/p95 TTFT/TPOT) feeding both observability and SLO-aware admission;
- :mod:`repro_torch.fleet.elastic` — queue-depth-driven scale-up/down of
  ``process: true`` pairs through the existing
  ``spawn_pair``/``PairHostHandle`` machinery.
"""

from .stats import RollingQuantile
from .workload import (FleetRequest, RequestClass, TraceSpec,
                       WorkloadError, fleet_serve_requests,
                       fleet_trace_records, generate_requests, slo_report)
from .routing import (LeastLoadedSimPairRouter, SmartPairRouter,
                      SmartSimPairRouter, pair_cost)
from .elastic import ElasticPairPool

__all__ = [
    "ElasticPairPool", "FleetRequest", "LeastLoadedSimPairRouter",
    "RequestClass", "RollingQuantile", "SmartPairRouter",
    "SmartSimPairRouter", "TraceSpec", "WorkloadError",
    "fleet_serve_requests", "fleet_trace_records", "generate_requests",
    "pair_cost", "slo_report",
]
