"""Workload traces for DSD-Sim (paper §3.2).

A trace record carries exactly the Table-1 schema:

    prompt_length, output_length, acceptance_seq, arrival_time_ms, drafter_id

``acceptance_seq`` is the *ground-truth* per-draft-token accept/reject stream
for a given draft–target pair. The paper captures these from real GPU
profiling runs; here they come from either (i) real draft/target pairs
executed by the engine (``SpecDecodeEngine.capture_traces``), or
(ii) a calibrated synthetic process matched to each benchmark's acceptance
regime. The synthetic process is a two-state Markov chain — acceptance in LLM
speculation is empirically bursty (runs of easy tokens accept together), and
burstiness is precisely what gives adaptive γ policies their edge.

Arrivals: trace-driven replay or synthetic Poisson (global rate, uniformly
spread over drafters), per §3.2 "Arrival Process".
"""

from __future__ import annotations

import json
import math
import random
from dataclasses import dataclass, field, asdict
from typing import Iterator, Optional


@dataclass
class TraceRecord:
    request_id: int
    prompt_length: int
    output_length: int
    acceptance_seq: list[int]
    arrival_time_ms: float
    drafter_id: int              # < 0: unpinned — the scheduler's pair
                                 # router assigns the lane at arrival time
    dataset: str = "synthetic"
    request_class: str = ""      # fleet traffic class ("" = dataset name)
    slo_ttft_ms: float = 0.0     # per-request TTFT target (0 = no SLO)
    slo_tpot_ms: float = 0.0     # per-request TPOT target (0 = no SLO)

    def to_json(self) -> str:
        return json.dumps(asdict(self))

    @staticmethod
    def from_json(line: str) -> "TraceRecord":
        return TraceRecord(**json.loads(line))


@dataclass(frozen=True)
class DatasetProfile:
    """Statistical profile of one benchmark workload.

    Lengths are lognormal (empirically heavy-tailed); acceptance is a 2-state
    Markov chain with stationary rate ``alpha`` and stickiness ``rho``
    (P[accept|prev accept] = alpha + rho(1-alpha)).
    """
    name: str
    prompt_mean: float
    prompt_sigma: float     # lognormal sigma of ln(length)
    output_mean: float
    output_sigma: float
    alpha: float            # stationary acceptance rate
    rho: float              # burstiness / autocorrelation in [0,1)
    max_prompt: int = 4096
    max_output: int = 1024


# Profiles matched to the paper's three benchmarks (§3.2, §5): GSM8K is
# reasoning (short prompts, medium outputs, high acceptance — the paper's
# largest AWC win), CNN/DailyMail is summarization (long prompts, short
# outputs), HumanEval is code (medium prompts, long outputs, volatile
# acceptance).
PROFILES: dict[str, DatasetProfile] = {
    "gsm8k":     DatasetProfile("gsm8k",      60, 0.45, 100, 0.50, 0.80, 0.55),
    "cnndm":     DatasetProfile("cnndm",     700, 0.35,  60, 0.45, 0.65, 0.40),
    "humaneval": DatasetProfile("humaneval", 130, 0.50, 180, 0.60, 0.72, 0.65),
}


def _lognormal_int(rng: random.Random, mean: float, sigma: float,
                   lo: int, hi: int) -> int:
    mu = math.log(mean) - 0.5 * sigma * sigma
    val = int(round(math.exp(rng.gauss(mu, sigma))))
    return max(lo, min(hi, val))


def markov_acceptance_seq(rng: random.Random, n: int, alpha: float,
                          rho: float) -> list[int]:
    """Two-state Markov chain with stationary P[accept]=alpha, stickiness rho."""
    p_aa = alpha + rho * (1.0 - alpha)          # accept -> accept
    p_ra = alpha * (1.0 - rho) / max(1e-9, 1.0 - rho * alpha)  # reject -> accept
    p_ra = min(1.0, max(0.0, p_ra))
    seq = []
    state = 1 if rng.random() < alpha else 0
    for _ in range(n):
        seq.append(state)
        p = p_aa if state == 1 else p_ra
        state = 1 if rng.random() < p else 0
    return seq


def empirical_alpha(seq: list[int]) -> float:
    return sum(seq) / max(1, len(seq))


class WorkloadGenerator:
    """Synthetic workload per §3.2: Poisson arrivals, profile-driven records."""

    def __init__(self, profile: DatasetProfile | str, rate_per_s: float,
                 num_drafters: int, seed: int = 0,
                 max_gamma: int = 16):
        self.profile = PROFILES[profile] if isinstance(profile, str) else profile
        self.rate = rate_per_s
        self.num_drafters = num_drafters
        self.rng = random.Random(seed)
        self.max_gamma = max_gamma

    def generate(self, n_requests: int, start_ms: float = 0.0) -> list[TraceRecord]:
        t = start_ms
        records = []
        p = self.profile
        for rid in range(n_requests):
            t += self.rng.expovariate(self.rate) * 1e3
            out_len = _lognormal_int(self.rng, p.output_mean, p.output_sigma,
                                     4, p.max_output)
            # Enough acceptance bits for worst case: every iteration draws up
            # to max_gamma bits and may accept as few as 1 token.
            bits = markov_acceptance_seq(self.rng, out_len * self.max_gamma,
                                         p.alpha, p.rho)
            records.append(TraceRecord(
                request_id=rid,
                prompt_length=_lognormal_int(self.rng, p.prompt_mean,
                                             p.prompt_sigma, 4, p.max_prompt),
                output_length=out_len,
                acceptance_seq=bits,
                arrival_time_ms=t,
                drafter_id=self.rng.randrange(self.num_drafters),
                dataset=p.name,
            ))
        return records


def load_trace(path: str) -> list[TraceRecord]:
    with open(path) as f:
        return [TraceRecord.from_json(line) for line in f if line.strip()]


def save_trace(records: list[TraceRecord], path: str) -> None:
    with open(path, "w") as f:
        for r in records:
            f.write(r.to_json() + "\n")


class AcceptanceCursor:
    """Streams a record's acceptance bits across speculation iterations.

    ``consume(gamma)`` returns (n_accepted_draft_tokens, all_accepted):
    the standard SD semantics — scan γ bits, stop at the first 0.
    If the trace runs dry, recycle from the start (records carry a generous
    bit budget so this is rare).
    """

    def __init__(self, seq: list[int]):
        self.seq = seq or [1]
        self.pos = 0

    def consume(self, gamma: int) -> tuple[int, bool]:
        n_acc = 0
        for _ in range(gamma):
            bit = self.seq[self.pos % len(self.seq)]
            self.pos += 1
            if bit == 1:
                n_acc += 1
            else:
                return n_acc, False
        return n_acc, True
