"""AWC training-dataset generation (paper §4.2), a copy of the reference
``repro/core/awc/dataset.py`` wired to the port's DSD-Sim (``sim/``) and
window policies: the same scenarios, seeds and sweeps give the reference's
rows exactly (host code only; no device).

For every scenario — (workload trace, network configuration, hardware
deployment) — the simulator sweeps speculation window sizes γ ∈ [2, 12] plus
the fused execution mode, records feature vectors + policy outputs +
performance metrics (TTFT/TPOT/throughput), and labels each feature snapshot
of the *winning* configuration with the γ minimizing a weighted SLO
objective:

    J(cfg) = w_tpot · TPOT + w_ttft · TTFT + w_thr / throughput

(fused is encoded as label γ=1 — the deployment rule γ≤1 ⇒ fused).
"""

from __future__ import annotations

import itertools
import math
import random
from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np

from ...sim.hwmodel import HardwareModel
from ...sim.network import LinkSpec
from ...sim.policies import BatchingConfig, LengthAwareBatching, JSQRouting
from ...sim.scheduler import ClusterSpec, DSDSimulation, PolicyStack
from ...sim.trace import WorkloadGenerator
from ..window import FeatureSnapshot, OracleStaticPolicy, WindowDecision


class RecordingWindowPolicy:
    """Wraps a policy; logs every (feature, decision) pair it makes."""

    def __init__(self, inner):
        self.inner = inner
        self.log: list[tuple[list[float], int]] = []

    def decide(self, pair_key: str, feats: FeatureSnapshot) -> WindowDecision:
        dec = self.inner.decide(pair_key, feats)
        self.log.append((feats.as_list(),
                         1 if dec.mode == "fused" else dec.gamma))
        return dec

    def name(self) -> str:
        return f"recording({self.inner.name()})"


@dataclass
class Scenario:
    dataset: str = "gsm8k"
    rtt_ms: float = 10.0
    rate_per_s: float = 30.0
    num_targets: int = 4
    num_drafters: int = 64
    target_hw: str = "A100"
    target_model: str = "llama2-70b"
    target_tp: int = 4
    draft_hw: str = "A40"
    draft_model: str = "llama2-7b"
    num_requests: int = 60
    seed: int = 0
    heterogeneous: bool = False   # paper §5.2 mixed pools


@dataclass
class SweepResult:
    scenario: Scenario
    gamma: int            # winning label (1 == fused)
    objective: float
    per_gamma: dict[int, float]
    rows: list[tuple[list[float], int]]


def default_grid(seed: int = 0, small: bool = False) -> list[Scenario]:
    """Scenario grid; the full grid reaches the paper's >2000-scenario scale
    when combined with per-seed replication (benchmarks/table2 uses it)."""
    # Target-bound serving regimes (paper §5.2: ~30 drafters per target).
    rtts = [5.0, 10.0, 20.0, 30.0, 45.0, 60.0] if not small else [10.0, 60.0]
    rates = [30.0, 50.0, 70.0] if not small else [40.0]
    datasets = ["gsm8k", "cnndm", "humaneval"] if not small else ["gsm8k"]
    sizes = [(2, 64), (2, 128)] if not small else [(2, 64)]
    out = []
    i = 0
    for rtt, rate, ds, (nt, nd) in itertools.product(rtts, rates, datasets, sizes):
        out.append(Scenario(dataset=ds, rtt_ms=rtt, rate_per_s=rate,
                            num_targets=nt, num_drafters=nd,
                            seed=seed + i))
        i += 1
    return out


def _run(scn: Scenario, window_policy, hw: Optional[HardwareModel] = None):
    from ...sim.scheduler import PAPER_DRAFT_POOL, PAPER_TARGET_POOL
    cluster = ClusterSpec(
        num_targets=scn.num_targets, target_hw=scn.target_hw,
        target_model=scn.target_model, target_tp=scn.target_tp,
        num_drafters=scn.num_drafters, draft_hw=scn.draft_hw,
        draft_model=scn.draft_model,
        target_pool=PAPER_TARGET_POOL if scn.heterogeneous else None,
        draft_pool=PAPER_DRAFT_POOL if scn.heterogeneous else None,
        link=LinkSpec(rtt_ms=scn.rtt_ms, jitter_ms=max(0.5, scn.rtt_ms * 0.08)))
    policies = PolicyStack(routing=JSQRouting(), batching=LengthAwareBatching(),
                           batching_cfg=BatchingConfig(max_batch=16),
                           window=window_policy)
    gen = WorkloadGenerator(scn.dataset, scn.rate_per_s, scn.num_drafters,
                            seed=scn.seed)
    sim = DSDSimulation(cluster, policies, gen.generate(scn.num_requests),
                        hwmodel=hw, seed=scn.seed)
    return sim.run().summary()


def objective(summary: dict, w_tpot: float = 1.0, w_ttft: float = 0.1,
              w_thr: float = 2000.0) -> float:
    tpot = summary["tpot_ms"]["mean"]
    ttft = summary["ttft_ms"]["mean"]
    thr = max(1e-6, summary["throughput_rps"])
    if math.isnan(tpot):
        tpot = 1e4
    if math.isnan(ttft):
        ttft = 1e4
    return w_tpot * tpot + w_ttft * ttft + w_thr / thr


def sweep_scenario(scn: Scenario, gammas: Iterable[int] = range(2, 13),
                   include_fused: bool = True,
                   hw: Optional[HardwareModel] = None) -> SweepResult:
    """Paper §4.2: record (feature vector, policy output, metrics) during
    EVERY sweep run; after the sweep, label all recorded snapshots with the
    scenario's objective-minimizing configuration. Recording only the
    winner's replay would leak the label through the γ_prev feature (the
    net would learn the copy-γ_prev shortcut — observed before this fix)."""
    per_gamma: dict[int, float] = {}
    recorders: dict[int, RecordingWindowPolicy] = {}
    for g in gammas:
        rec = RecordingWindowPolicy(OracleStaticPolicy(g))
        per_gamma[g] = objective(_run(scn, rec, hw))
        recorders[g] = rec
    if include_fused:
        rec = RecordingWindowPolicy(OracleStaticPolicy(1, fused=True))
        per_gamma[1] = objective(_run(scn, rec, hw))
        recorders[1] = rec
    best = min(per_gamma, key=per_gamma.get)
    # Soft regression target: objective-weighted γ average. Near-ties
    # (γ=2/3/4 within a few % of each other) should pull the prediction to
    # their centroid rather than collapse onto an arbitrary winner — the
    # WC-DNN regresses a continuous γ (paper §4.3), so the target should be
    # continuous too.
    o_min = per_gamma[best]
    temp = max(1e-6, 0.04 * o_min)
    ws = {g: math.exp(-(o - o_min) / temp) for g, o in per_gamma.items()}
    z = sum(ws.values())
    soft = sum(g * w for g, w in ws.items()) / z
    rows = [(f, soft) for rec in recorders.values() for f, _ in rec.log]
    return SweepResult(scenario=scn, gamma=best, objective=per_gamma[best],
                       per_gamma=per_gamma, rows=rows)


def generate_dataset(scenarios: list[Scenario],
                     max_rows_per_scenario: int = 256,
                     hw: Optional[HardwareModel] = None,
                     rng_seed: int = 0) -> tuple[np.ndarray, np.ndarray, list[SweepResult]]:
    """Returns (X (N,5), y (N,), sweep results)."""
    rng = random.Random(rng_seed)
    X, y, results = [], [], []
    for scn in scenarios:
        res = sweep_scenario(scn, hw=hw)
        rows = res.rows
        if len(rows) > max_rows_per_scenario:
            rows = rng.sample(rows, max_rows_per_scenario)
        for feats, label in rows:
            X.append(feats)
            y.append(float(label))
        results.append(res)
    return (np.asarray(X, np.float32), np.asarray(y, np.float32), results)


# --------------------------------------------------------------------------
# Sweep-calibrated per-pair labels (v2 — the shipped WC-DNN training path)
# --------------------------------------------------------------------------

def sweep_scenario_pairwise(scn: Scenario,
                            deltas=(-2.0, -1.0, 0.0, 1.0, 2.0),
                            hw: Optional[HardwareModel] = None,
                            obj_seeds: tuple = (0,)
                            ) -> SweepResult:
    """Per-pair labels via a sweep over *shifted analytic controllers*.

    Global-γ sweeps can only label a whole scenario with one γ — useless in
    heterogeneous clusters where each draft–target pair wants a different
    window. Instead we sweep the per-pair analytic controller
    (Eq.(1)/(2)-based ``bootstrap_gamma``) shifted by a scalar δ, pick the
    objective-minimizing δ*, and label every recorded feature vector with
    ``bootstrap(features) + δ*`` — a per-pair target the 5-feature WC-DNN
    can actually express. γ_prev leaks nothing: bootstrap ignores it.
    """
    from .model import bootstrap_gamma
    from ..window import AWCWindowPolicy

    import dataclasses as _dc
    per_delta: dict[float, float] = {}
    recorders: dict[float, RecordingWindowPolicy] = {}
    for d in deltas:
        objs = []
        pol = None
        for s in obj_seeds:     # seed-averaged objective: stabler δ*
            pol = RecordingWindowPolicy(AWCWindowPolicy(
                lambda f, d=d: bootstrap_gamma(f, mode_aware=False) + d))
            objs.append(objective(_run(
                _dc.replace(scn, seed=scn.seed + 1000 * s), pol, hw)))
        per_delta[d] = sum(objs) / len(objs)
        recorders[d] = pol
    # fused-everywhere alternative (γ ≡ 1)
    fused_obj = sum(
        objective(_run(_dc.replace(scn, seed=scn.seed + 1000 * s),
                       OracleStaticPolicy(1, fused=True), hw))
        for s in obj_seeds) / len(obj_seeds)
    best = min(per_delta, key=per_delta.get)
    rows: list[tuple[list[float], float]] = []
    if fused_obj < per_delta[best] * 0.97:
        # the scenario prefers cloud-only execution: label everything 1
        for rec in recorders.values():
            rows.extend((f, 1.0) for f, _ in rec.log)
        gamma_repr = 1
    else:
        # floor at 2: in a distributed-optimal scenario a small window must
        # stay distributed — labels of ~1 would push the deployed policy
        # through the fused hysteresis on transient low-α features (observed
        # fused-thrash collapse on the bursty humaneval workload)
        for rec in recorders.values():
            rows.extend(
                (f, max(2.0, min(12.0,
                                 bootstrap_gamma(f, mode_aware=False)
                                 + best)))
                for f, _ in rec.log)
        gamma_repr = int(round(4 + best))
    return SweepResult(scenario=scn, gamma=gamma_repr,
                       objective=min(per_delta[best], fused_obj),
                       per_gamma={int(d): v for d, v in per_delta.items()},
                       rows=rows)


def default_grid_v2(seed: int = 0, small: bool = False) -> list[Scenario]:
    """Heterogeneous-heavy grid for the shipped checkpoint."""
    rtts = [5.0, 10.0, 20.0, 30.0, 45.0, 60.0, 90.0] if not small else [10.0]
    rates = [30.0, 50.0, 70.0] if not small else [40.0]
    datasets = ["gsm8k", "cnndm", "humaneval"] if not small else ["gsm8k"]
    out = []
    i = 0
    for rtt, rate, ds in itertools.product(rtts, rates, datasets):
        out.append(Scenario(dataset=ds, rtt_ms=rtt, rate_per_s=rate,
                            num_targets=3, num_drafters=60,
                            heterogeneous=True, seed=seed + i))
        i += 1
        if not small and rtt in (10.0, 45.0):
            out.append(Scenario(dataset=ds, rtt_ms=rtt, rate_per_s=rate,
                                num_targets=2, num_drafters=64,
                                heterogeneous=False, seed=seed + i))
            i += 1
    return out


def generate_dataset_v2(scenarios: list[Scenario],
                        max_rows_per_scenario: int = 256,
                        hw: Optional[HardwareModel] = None,
                        rng_seed: int = 0):
    rng = random.Random(rng_seed)
    X, y, results = [], [], []
    for scn in scenarios:
        res = sweep_scenario_pairwise(scn, hw=hw)
        rows = res.rows
        if len(rows) > max_rows_per_scenario:
            rows = rng.sample(rows, max_rows_per_scenario)
        for feats, label in rows:
            X.append(feats)
            y.append(float(label))
        results.append(res)
    return (np.asarray(X, np.float32), np.asarray(y, np.float32), results)
