"""The one generator: deterministic per seed, the same work on every seed
in another order, i.i.d. below the run, and its profile's moments."""

import math

import numpy as np
import pytest

import traffic

MIX = {"prompt": {"mean": 60, "sigma": 0.45, "min": 4, "max": 256},
       "output": {"mean": 100, "sigma": 0.5, "min": 4, "max": 512},
       "temperature": 1.0, "arrivals": {"kind": "poisson", "rate_per_s": 3.0}}


def test_same_seed_same_requests():
    a = traffic.generate(MIX, 2**31 + 11, 40, 1000)
    b = traffic.generate(MIX, 2**31 + 11, 40, 1000)
    assert [(r.max_new, r.arrival_s) for r in a] == \
        [(r.max_new, r.arrival_s) for r in b]
    assert all((x.prompt == y.prompt).all() for x, y in zip(a, b))


def test_every_seed_gets_the_same_work_in_another_order():
    a = traffic.generate(MIX, 1, 40, 1000)
    b = traffic.generate(MIX, 2**33 + 5, 40, 1000)
    assert len(a) == len(b)
    assert [r.max_new for r in a] != [r.max_new for r in b]
    for key in (lambda r: r.max_new, lambda r: len(r.prompt)):
        assert sorted(map(key, a)) == sorted(map(key, b))
    gaps_a = np.diff([0.0] + [r.arrival_s for r in a])
    gaps_b = np.diff([0.0] + [r.arrival_s for r in b])
    assert np.allclose(sorted(gaps_a), sorted(gaps_b))
    assert not np.allclose(gaps_a, gaps_b)


def test_arrivals_are_not_smoothed_below_the_run():
    """Counts of arrivals in 32-arrival stretches vary as i.i.d. gaps do:
    the spans of 32 consecutive gaps are not all alike."""
    r = traffic.generate(MIX, 7, 400, 1000)
    due = np.array([x.arrival_s for x in r])
    spans = due[32::32] - due[:-32:32]
    # a sum of 32 exponential gaps has a coefficient of variation 1/sqrt(32)
    cv = spans.std() / spans.mean()
    assert 0.6 / math.sqrt(32) < cv < 1.5 / math.sqrt(32)


@pytest.mark.parametrize("mean,sigma", [(60, 0.45), (100, 0.5), (700, 0.35),
                                        (180, 0.6)])
def test_lengths_match_the_lognormal_moments(mean, sigma):
    rng = np.random.default_rng(3)
    q = traffic.lognormal_lengths(rng, mean, sigma, 20000, 1, 10**6)
    assert abs(q.mean() / mean - 1) < 0.03
    assert abs(np.median(q) / math.exp(math.log(mean) - sigma**2 / 2) - 1) \
        < 0.03
    assert abs(np.log(q).std() / sigma - 1) < 0.05
    # i.i.d. draws reach the tail: beyond the 99.9th percentile's rank
    assert q.max() > math.exp(math.log(mean) - sigma**2 / 2 + 3.0 * sigma)


def test_poisson_rate_and_backlog():
    r = traffic.generate(MIX, 3, 100, 1000)
    gaps = np.diff([0.0] + [x.arrival_s for x in r])
    assert abs(gaps.mean() * 3.0 - 1) < 0.05
    assert len(r) >= 1.2 * 3.0 * 100
    back = traffic.generate({**MIX, "arrivals": {"kind": "backlog",
                                                 "requests": 64}}, 3, 0, 50)
    assert len(back) == 64 and all(x.arrival_s == 0 for x in back)
    assert all(0 <= x.prompt.min() and x.prompt.max() < 50 for x in back)


def test_lengths_clipped_to_the_caps():
    m = {**MIX, "output": {"mean": 100, "sigma": 2.0, "min": 4, "max": 120}}
    r = traffic.generate(m, 5, 40, 100)
    assert max(x.max_new for x in r) == 120 and min(x.max_new for x in r) >= 4
