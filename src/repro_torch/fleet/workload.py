"""Trace-driven fleet workloads: request classes, load shapes, SLOs.

A :class:`TraceSpec` describes a heterogeneous request stream the way
:class:`repro_torch.topology.ClusterSpec` describes a deployment — declaratively
and JSON round-trippable. It combines

- :class:`RequestClass` rows (chat vs long-context vs batch-offline …):
  per-class lognormal prompt/output length distributions, per-class
  TTFT/TPOT SLOs (0 = no SLO), an arrival weight, and the per-class
  acceptance regime (``alpha``/``rho``) the sim's Markov acceptance
  streams replay;
- a load *shape*: ``constant`` Poisson, ``diurnal`` (sinusoidal rate
  modulation — the day/night curve), ``burst`` (periodic rate spikes), or
  ``replay`` of an explicitly recorded arrival list.

:func:`generate_requests` expands a spec into one seeded, deterministic
:class:`FleetRequest` stream; identical specs replay identical streams.
Two adapters consume the SAME stream so sim↔real workload parity is a
property of the spec:

- :func:`fleet_serve_requests` → real-path
  :class:`repro_torch.serving.ServeRequest` rows (token prompts drawn from the
  same seed, SLOs attached);
- :func:`fleet_trace_records` → DSD-Sim :class:`repro_torch.sim.trace
  .TraceRecord` rows (class-matched Markov acceptance bits, SLOs
  attached, ``drafter_id = -1`` so the sim's pair router assigns the lane
  at arrival time).

Nonhomogeneous arrivals use Lewis–Shedler thinning: sample a homogeneous
Poisson stream at the shape's peak rate, keep each arrival with
probability ``rate(t)/peak`` — exact, and deterministic under one
``random.Random(seed)``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import random
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


class WorkloadError(ValueError):
    """A TraceSpec / RequestClass failed validation."""


# canonical class presets (chat / long-context / batch-offline); a
# TraceSpec may declare any classes it likes — these are the paper-shaped
# defaults benches and examples start from
def default_classes() -> list["RequestClass"]:
    return [
        RequestClass(name="chat", weight=0.6, prompt_mean=24, prompt_sigma=0.4,
                     prompt_max=128, output_mean=24, output_sigma=0.4,
                     output_max=96, slo_ttft_ms=2000.0, slo_tpot_ms=120.0,
                     alpha=0.8, rho=0.5),
        RequestClass(name="long-context", weight=0.25, prompt_mean=220,
                     prompt_sigma=0.35, prompt_max=1024, output_mean=48,
                     output_sigma=0.4, output_max=192, slo_ttft_ms=6000.0,
                     slo_tpot_ms=300.0, alpha=0.7, rho=0.45),
        RequestClass(name="batch-offline", weight=0.15, prompt_mean=48,
                     prompt_sigma=0.5, prompt_max=512, output_mean=96,
                     output_sigma=0.5, output_max=384, slo_ttft_ms=0.0,
                     slo_tpot_ms=0.0, alpha=0.75, rho=0.5),
    ]


@dataclass
class RequestClass:
    """One traffic class: length distributions + SLOs + acceptance regime.

    Lengths are lognormal (empirically heavy-tailed, matching
    :mod:`repro_torch.sim.trace`'s dataset profiles); ``slo_ttft_ms`` /
    ``slo_tpot_ms`` are per-request latency targets (0 disables that SLO —
    batch-offline traffic typically carries none); ``alpha``/``rho`` feed
    the sim's two-state Markov acceptance stream for requests of this
    class (the real path measures acceptance, the sim replays it)."""
    name: str
    weight: float = 1.0          # share of arrivals (normalized over classes)
    prompt_mean: float = 32.0    # lognormal mean prompt length (tokens)
    prompt_sigma: float = 0.4    # lognormal sigma of ln(length)
    prompt_min: int = 4
    prompt_max: int = 512
    output_mean: float = 32.0
    output_sigma: float = 0.4
    output_min: int = 4
    output_max: int = 256
    slo_ttft_ms: float = 0.0     # time-to-first-token target (0 = no SLO)
    slo_tpot_ms: float = 0.0     # time-per-output-token target (0 = no SLO)
    alpha: float = 0.8           # stationary acceptance rate (sim replay)
    rho: float = 0.5             # acceptance burstiness (sim replay)


TRACE_SHAPES = ("constant", "diurnal", "burst", "replay")


@dataclass
class TraceSpec:
    """A declarative request stream: classes × load shape × seed.

    ``rate_per_s`` is the MEAN offered load; ``shape`` modulates it:

    - ``constant`` — homogeneous Poisson at ``rate_per_s``;
    - ``diurnal``  — rate(t) = rate·(1 + amplitude·sin(2πt/period)), the
      day/night curve compressed to ``diurnal_period_s``;
    - ``burst``    — rate jumps to rate·burst_multiplier for
      ``burst_len_s`` every ``burst_every_s`` (flash crowds);
    - ``replay``   — ``replay_arrivals_s`` IS the arrival clock
      (optionally with per-arrival ``replay_classes``); ``rate_per_s``
      is ignored.
    """
    classes: list[RequestClass] = field(default_factory=default_classes)
    num_requests: int = 32
    rate_per_s: float = 4.0
    shape: str = "constant"
    diurnal_period_s: float = 60.0
    diurnal_amplitude: float = 0.5       # in [0, 1)
    burst_every_s: float = 10.0
    burst_len_s: float = 1.0
    burst_multiplier: float = 4.0
    replay_arrivals_s: list[float] = field(default_factory=list)
    replay_classes: list[str] = field(default_factory=list)
    seed: int = 0

    # -- validation ----------------------------------------------------------

    def validate(self) -> "TraceSpec":
        """Structural validation; raises :class:`WorkloadError` with the
        first violation. Returns self for chaining."""
        if not self.classes:
            raise WorkloadError("a trace needs at least one request class")
        seen: set[str] = set()
        for c in self.classes:
            if not c.name or not isinstance(c.name, str):
                raise WorkloadError(
                    f"class name must be a non-empty string, got {c.name!r}")
            if c.name in seen:
                raise WorkloadError(f"duplicate class name {c.name!r}")
            seen.add(c.name)
            if c.weight < 0:
                raise WorkloadError(f"class {c.name!r}: negative weight")
            for fname in ("prompt_mean", "prompt_sigma", "output_mean",
                          "output_sigma"):
                if getattr(c, fname) < 0:
                    raise WorkloadError(
                        f"class {c.name!r}: negative {fname}")
            if c.prompt_mean <= 0 or c.output_mean <= 0:
                raise WorkloadError(
                    f"class {c.name!r}: length means must be > 0")
            for lo, hi, what in ((c.prompt_min, c.prompt_max, "prompt"),
                                 (c.output_min, c.output_max, "output")):
                if lo < 1 or hi < lo:
                    raise WorkloadError(
                        f"class {c.name!r}: need 1 <= {what}_min <= "
                        f"{what}_max, got [{lo}, {hi}]")
            if c.slo_ttft_ms < 0 or c.slo_tpot_ms < 0:
                raise WorkloadError(
                    f"class {c.name!r}: SLOs must be >= 0 (0 = no SLO)")
            if not (0.0 <= c.alpha <= 1.0) or not (0.0 <= c.rho < 1.0):
                raise WorkloadError(
                    f"class {c.name!r}: need 0 <= alpha <= 1, 0 <= rho < 1")
        if sum(c.weight for c in self.classes) <= 0:
            raise WorkloadError("class weights sum to zero")
        if self.num_requests < 0:
            raise WorkloadError("num_requests must be >= 0")
        if self.shape not in TRACE_SHAPES:
            raise WorkloadError(
                f"shape must be one of {TRACE_SHAPES}, got {self.shape!r}")
        if self.shape == "replay":
            if not self.replay_arrivals_s:
                raise WorkloadError("shape='replay' needs replay_arrivals_s")
            if any(t < 0 for t in self.replay_arrivals_s):
                raise WorkloadError("replay arrivals must be >= 0")
            if any(b < a for a, b in zip(self.replay_arrivals_s,
                                         self.replay_arrivals_s[1:])):
                raise WorkloadError("replay arrivals must be nondecreasing")
            if self.replay_classes:
                if len(self.replay_classes) != len(self.replay_arrivals_s):
                    raise WorkloadError(
                        "replay_classes must match replay_arrivals_s length")
                for name in self.replay_classes:
                    if name not in seen:
                        raise WorkloadError(
                            f"replay class {name!r} not declared in classes")
        else:
            if self.rate_per_s <= 0:
                raise WorkloadError(
                    f"shape {self.shape!r} needs rate_per_s > 0")
        if self.shape == "diurnal" and not (0 <= self.diurnal_amplitude < 1):
            raise WorkloadError("diurnal_amplitude must be in [0, 1)")
        if self.shape == "diurnal" and self.diurnal_period_s <= 0:
            raise WorkloadError("diurnal_period_s must be > 0")
        if self.shape == "burst":
            if (self.burst_every_s <= 0 or self.burst_len_s <= 0
                    or self.burst_multiplier < 1):
                raise WorkloadError(
                    "burst shape needs burst_every_s > 0, burst_len_s > 0, "
                    "burst_multiplier >= 1")
        return self

    # -- JSON round trip -----------------------------------------------------

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent) + "\n"

    @classmethod
    def from_dict(cls, d: dict) -> "TraceSpec":
        d = dict(d)
        raw_classes = d.pop("classes", None)
        fields = {f.name for f in dataclasses.fields(cls)}
        for k in d:
            if k not in fields:
                raise WorkloadError(f"unknown field {k!r} for TraceSpec")
        spec = cls(**d)
        if raw_classes is not None:
            cfields = {f.name for f in dataclasses.fields(RequestClass)}
            classes = []
            for c in raw_classes:
                for k in c:
                    if k not in cfields:
                        raise WorkloadError(
                            f"unknown field {k!r} for RequestClass")
                classes.append(RequestClass(**c))
            spec.classes = classes
        return spec

    @classmethod
    def from_json(cls, text: str) -> "TraceSpec":
        return cls.from_dict(json.loads(text))

    # -- rate shape ----------------------------------------------------------

    def rate_at(self, t_s: float) -> float:
        """Instantaneous offered load at ``t_s`` (requests/s)."""
        r = self.rate_per_s
        if self.shape == "diurnal":
            return r * (1.0 + self.diurnal_amplitude
                        * math.sin(2.0 * math.pi * t_s
                                   / self.diurnal_period_s))
        if self.shape == "burst":
            phase = t_s % self.burst_every_s
            return r * self.burst_multiplier if phase < self.burst_len_s \
                else r
        return r

    def peak_rate(self) -> float:
        if self.shape == "diurnal":
            return self.rate_per_s * (1.0 + self.diurnal_amplitude)
        if self.shape == "burst":
            return self.rate_per_s * self.burst_multiplier
        return self.rate_per_s


@dataclass
class FleetRequest:
    """One generated request: the spec-independent unit both the real
    server adapter and the sim adapter consume."""
    request_id: int
    request_class: str
    prompt_len: int
    output_len: int
    arrival_s: float
    slo_ttft_ms: float = 0.0
    slo_tpot_ms: float = 0.0
    alpha: float = 0.8
    rho: float = 0.5


def _lognormal_int(rng: random.Random, mean: float, sigma: float,
                   lo: int, hi: int) -> int:
    mu = math.log(mean) - 0.5 * sigma * sigma
    val = int(round(math.exp(rng.gauss(mu, sigma))))
    return max(lo, min(hi, val))


def generate_requests(trace: TraceSpec) -> list[FleetRequest]:
    """Expand a validated spec into its deterministic request stream.

    One ``random.Random(trace.seed)`` drives everything (arrival thinning,
    class sampling, lengths), so identical specs produce identical streams
    — the seeded-determinism contract tests gate on."""
    trace.validate()
    rng = random.Random(trace.seed)
    weights = [max(0.0, c.weight) for c in trace.classes]
    total_w = sum(weights)

    def sample_class() -> RequestClass:
        x = rng.random() * total_w
        for c, w in zip(trace.classes, weights):
            x -= w
            if x < 0:
                return c
        return trace.classes[-1]

    by_name = {c.name: c for c in trace.classes}
    arrivals: list[tuple[float, RequestClass]] = []
    if trace.shape == "replay":
        for i, t in enumerate(trace.replay_arrivals_s[:trace.num_requests
                                                      or None]):
            cls = (by_name[trace.replay_classes[i]]
                   if trace.replay_classes else sample_class())
            arrivals.append((float(t), cls))
        if trace.num_requests:
            arrivals = arrivals[:trace.num_requests]
    else:
        peak = trace.peak_rate()
        t = 0.0
        while len(arrivals) < trace.num_requests:
            t += rng.expovariate(peak)
            # Lewis–Shedler thinning: exact nonhomogeneous Poisson
            if rng.random() * peak <= trace.rate_at(t):
                arrivals.append((t, sample_class()))

    out = []
    for rid, (t, c) in enumerate(arrivals):
        out.append(FleetRequest(
            request_id=rid, request_class=c.name,
            prompt_len=_lognormal_int(rng, c.prompt_mean, c.prompt_sigma,
                                      c.prompt_min, c.prompt_max),
            output_len=_lognormal_int(rng, c.output_mean, c.output_sigma,
                                      c.output_min, c.output_max),
            arrival_s=t, slo_ttft_ms=c.slo_ttft_ms, slo_tpot_ms=c.slo_tpot_ms,
            alpha=c.alpha, rho=c.rho))
    return out


# --------------------------------------------------------------------------
# adapters: ONE stream → real server requests AND sim trace records
# --------------------------------------------------------------------------

def fleet_serve_requests(reqs: list[FleetRequest], vocab: int,
                         seed: int = 0) -> list:
    """Real-path adapter: token prompts drawn from ``seed`` (deterministic
    given the stream), SLOs and class carried on each
    :class:`~repro_torch.serving.ServeRequest`."""
    from ..serving import ServeRequest
    rng = np.random.default_rng(seed)
    out = []
    for r in reqs:
        out.append(ServeRequest(
            request_id=r.request_id,
            prompt=rng.integers(0, vocab, r.prompt_len).astype(np.int32),
            max_new_tokens=r.output_len, arrival_s=r.arrival_s,
            request_class=r.request_class, slo_ttft_ms=r.slo_ttft_ms,
            slo_tpot_ms=r.slo_tpot_ms))
    return out


def fleet_trace_records(reqs: list[FleetRequest], seed: int = 0,
                        max_gamma: int = 16, drafter_id: int = -1) -> list:
    """Sim adapter: class-matched Markov acceptance bits, SLOs attached.

    ``drafter_id=-1`` marks the record "route me at arrival" — the sim's
    :class:`~repro_torch.sim.policies.PolicyStack` pair router assigns the lane
    the way the real server's :class:`PairRouter` does."""
    from ..sim.trace import TraceRecord, markov_acceptance_seq
    rng = random.Random(seed)
    out = []
    for r in reqs:
        bits = markov_acceptance_seq(rng, r.output_len * max_gamma,
                                     r.alpha, r.rho)
        out.append(TraceRecord(
            request_id=r.request_id, prompt_length=r.prompt_len,
            output_length=r.output_len, acceptance_seq=bits,
            arrival_time_ms=r.arrival_s * 1e3, drafter_id=drafter_id,
            dataset=r.request_class, request_class=r.request_class,
            slo_ttft_ms=r.slo_ttft_ms, slo_tpot_ms=r.slo_tpot_ms))
    return out


# --------------------------------------------------------------------------
# SLO attainment
# --------------------------------------------------------------------------

def slo_report(rows: list[dict]) -> dict:
    """Aggregate SLO attainment from per-request measurement rows.

    Each row: ``{"request_class", "slo_ttft_ms", "slo_tpot_ms",
    "ttft_ms", "tpot_ms", "shed"(opt)}``. A request ATTAINS when every
    SLO it carries is met and it was not shed; requests carrying no SLO
    are excluded from the attainment denominator (batch-offline traffic
    cannot pad the score). The same function grades the real server's
    results and the sim analyzer's requests, so attainment numbers are
    directly comparable."""
    graded = attained = 0
    per_class: dict[str, dict] = {}
    for row in rows:
        cls = row.get("request_class") or "default"
        pc = per_class.setdefault(
            cls, {"requests": 0, "graded": 0, "attained": 0, "shed": 0})
        pc["requests"] += 1
        has_slo = (row.get("slo_ttft_ms", 0) > 0
                   or row.get("slo_tpot_ms", 0) > 0)
        if row.get("shed"):
            pc["shed"] += 1
        if not has_slo:
            continue
        graded += 1
        pc["graded"] += 1
        ok = not row.get("shed")
        if ok and row.get("slo_ttft_ms", 0) > 0:
            ok = row.get("ttft_ms", math.inf) <= row["slo_ttft_ms"]
        if ok and row.get("slo_tpot_ms", 0) > 0:
            ok = row.get("tpot_ms", math.inf) <= row["slo_tpot_ms"]
        if ok:
            attained += 1
            pc["attained"] += 1
    for pc in per_class.values():
        pc["attainment"] = (pc["attained"] / pc["graded"]
                            if pc["graded"] else 1.0)
    return {
        "graded": graded,
        "attained": attained,
        "attainment": attained / graded if graded else 1.0,
        "per_class": per_class,
    }


def serve_results_rows(results: list) -> list[dict]:
    """ServeResult rows → :func:`slo_report` input."""
    return [{
        "request_class": r.request_class, "slo_ttft_ms": r.slo_ttft_ms,
        "slo_tpot_ms": r.slo_tpot_ms, "ttft_ms": r.ttft_ms,
        "tpot_ms": r.tpot_ms, "shed": r.shed,
    } for r in results]
