"""Synthetic token data pipeline, the port of the reference
``repro/training/data.py`` (numpy only; its batches are byte-equal to the
reference's for one config).

The reference draws each token with ``rng.choice(v, p=p)``, building p
(O(vocab)) and its CDF for every token: 1–9 s per batch at the published
vocabularies (50280–151936) and 8192 tokens. p depends only on the
previous token's Markov state, so the port builds each state's CDF once,
exactly as ``Generator.choice`` builds it (cumsum, divided by its last
entry), and draws with the same single ``rng.random()`` and the same
``searchsorted(side="right")``: the same tokens from the same stream.

Deterministic, seedable, infinite stream of LM batches with a structured
synthetic language (Zipfian unigrams + a first-order Markov kernel + copy
spans) — enough signal that a ~100M model's loss visibly drops within a few
hundred steps (examples/train_draft_torch.py), unlike uniform-random tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab: int
    seq_len: int
    batch: int
    seed: int = 0
    zipf_a: float = 1.2
    markov_states: int = 64
    copy_prob: float = 0.15
    frontend_tokens: int = 0      # encdec/vlm: stub embedding length
    frontend_dim: int = 0


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab
        # Zipf unigram over vocab
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self.unigram = ranks ** (-cfg.zipf_a)
        self.unigram /= self.unigram.sum()
        # low-rank Markov structure: state -> next-token distribution tilt
        k = min(cfg.markov_states, v)
        self.state_of = rng.integers(0, k, size=v)
        self.tilt = rng.dirichlet(np.ones(k) * 0.3, size=k)  # (k, k)
        self.rng = rng
        self._cdfs: dict = {}     # Markov state (None: unigram) → CDF

    def _cdf(self, state):
        """``Generator.choice``'s CDF of the next-token distribution."""
        cdf = self._cdfs.get(state)
        if cdf is None:
            if state is None:
                p = self.unigram
            else:
                # mix unigram with the state tilt projected back onto vocab
                p = 0.7 * self.unigram
                boost_states = self.tilt[state]
                p = p + 0.3 * boost_states[self.state_of] * self.unigram \
                    * len(boost_states)
                p = p / p.sum()
            cdf = p.cumsum()
            cdf /= cdf[-1]
            self._cdfs[state] = cdf
        return cdf

    def _draw(self, rng: np.random.Generator, state) -> int:
        """``rng.choice(vocab, p=p)`` for the state's p: one uniform."""
        return int(self._cdf(state).searchsorted(rng.random(),
                                                 side="right"))

    def _sample_seq(self, rng: np.random.Generator, n: int) -> np.ndarray:
        cfg = self.cfg
        out = np.empty(n, dtype=np.int32)
        out[0] = self._draw(rng, None)
        i = 1
        while i < n:
            if i > 8 and rng.random() < cfg.copy_prob:
                # copy a recent span (teaches induction-style structure)
                span = rng.integers(2, min(8, i))
                start = rng.integers(0, i - span)
                ln = min(span, n - i)
                out[i:i + ln] = out[start:start + ln]
                i += ln
                continue
            out[i] = self._draw(rng, int(self.state_of[out[i - 1]]))
            i += 1
        return out

    def batches(self) -> Iterator[dict]:
        cfg = self.cfg
        step = 0
        while True:
            rng = np.random.default_rng((cfg.seed, step))
            toks = np.stack([self._sample_seq(rng, cfg.seq_len + 1)
                             for _ in range(cfg.batch)])
            batch = {"tokens": toks[:, :-1].astype(np.int32),
                     "labels": toks[:, 1:].astype(np.int32)}
            if cfg.frontend_tokens:
                dim = cfg.frontend_dim
                batch["frontend"] = rng.standard_normal(
                    (cfg.batch, cfg.frontend_tokens, dim)).astype(np.float32)
            yield batch
            step += 1
