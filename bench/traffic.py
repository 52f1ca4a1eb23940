"""The one request generator: a traffic mix (``traffic/<mix>.json``) and a
seed in, a list of requests out.

Lengths are lognormal with the mix's mean and sigma (mu = ln(mean) -
sigma^2/2, as ``repro_torch/sim/trace.py`` and ``fleet/workload.py`` draw
them), rounded and clipped only at the mix's [min, max]. Arrivals are
open-loop Poisson at ``rate_per_s`` (i.i.d. exponential gaps), or a
backlog due at t = 0.

Every seed gets the same work in another order. The prompt lengths, the
output lengths and the gaps are each one i.i.d. sample, drawn from a
stream that does not depend on the seed (``DRAW_SEED``); the seed permutes
each sample over the whole run and draws the token ids, uniform over the
vocabulary. No order is imposed below the run: any 32 consecutive
arrivals are 32 draws of the sample, so their count in a stretch of time
varies as a Poisson stream's does, and lengths reach the lognormal's tail
up to the caps."""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

DRAW_SEED = 20241015      # the stream of the shared lengths and gaps


@dataclass
class Request:
    request_id: int
    prompt: np.ndarray       # (S,) int32
    max_new: int
    arrival_s: float         # due time, relative to the serve loop's start


def lognormal_lengths(rng: np.random.Generator, mean: float, sigma: float,
                      n: int, lo: int, hi: int) -> np.ndarray:
    """n i.i.d. lognormal lengths of the given mean, rounded, clipped to
    [lo, hi]."""
    mu = math.log(mean) - 0.5 * sigma * sigma
    return np.clip(np.rint(rng.lognormal(mu, sigma, n)), lo, hi
                   ).astype(np.int64)


def request_count(mix: dict, seconds: float) -> int:
    """Requests a run needs: the backlog's size, or enough Poisson arrivals
    to outlast ``seconds`` of serving with a fifth to spare."""
    arr = mix["arrivals"]
    if arr["kind"] == "backlog":
        return int(arr["requests"])
    return math.ceil(1.2 * arr["rate_per_s"] * seconds) + 1


def generate(mix: dict, seed: int, seconds: float, vocab: int
             ) -> list[Request]:
    """The run's requests in due order: ``seconds`` is the serving time the
    stream has to cover (the ramp and the window)."""
    n = request_count(mix, seconds)
    p, o, arr = mix["prompt"], mix["output"], mix["arrivals"]
    if arr["kind"] not in ("poisson", "backlog"):
        raise ValueError(f"unknown arrivals kind {arr['kind']!r}")
    shared = np.random.default_rng(DRAW_SEED)
    plen = lognormal_lengths(shared, p["mean"], p["sigma"], n, p["min"],
                             p["max"])
    olen = lognormal_lengths(shared, o["mean"], o["sigma"], n, o["min"],
                             o["max"])
    gaps = (shared.exponential(1.0 / float(arr["rate_per_s"]), n)
            if arr["kind"] == "poisson" else np.zeros(n))
    rng = np.random.default_rng(abs(int(seed)))
    plen, olen, gaps = (rng.permutation(plen), rng.permutation(olen),
                        rng.permutation(gaps))
    due = np.cumsum(gaps)
    return [Request(i, rng.integers(0, vocab, int(plen[i])).astype(np.int32),
                    int(olen[i]), float(due[i])) for i in range(n)]
