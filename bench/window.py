"""The records a run keeps and the end-to-end arithmetic over them.

Times are seconds on the host's ``perf_counter``. The window runs from the
end of the first chunk that ends after the ramp (``w0``) to the end of the
first chunk that ends ``seconds`` after it (``w1``): both are chunk
boundaries, where the session has synchronized, so everything between them
is whole work of the window.

- TTFT: every request due in [w0, w1): due → end of its own
  prefill-insert, or w1 - due when it is still waiting at w1 (a stall
  cannot hide).
- TPOT: every request that retires in (w0, w1] with >= 2 tokens:
  (retirement - first token) / (tokens - 1), the ``ServeResult``
  definition.
- tokens/s: tokens committed in the window (the first token of each
  admission in it, and each chunk's cursor advances over the slots) over
  w1 - w0."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class RequestRecord:
    request_id: int
    due: float                          # absolute due time
    prompt_len: int
    budget: int
    admit_start: Optional[float] = None
    first: Optional[float] = None       # end of its prefill-insert
    retire: Optional[float] = None
    tokens: Optional[np.ndarray] = None
    rounds: list = field(default_factory=list)   # (gamma, n_acc, n_new)
    rounds_resident: int = 0            # rounds run while it held a slot


@dataclass
class ChunkRecord:
    t0: float
    t1: float
    rounds: int
    gammas: list                        # effective gamma per round, 0 fused
    tokens: int                         # cursor advances over the slots
    work: list                          # per active slot-round: (cached
                                        # positions, gamma, tokens committed)
    traced: bool = False


@dataclass
class AdmitRecord:
    t0: float
    t1: float
    prompt_len: int
    traced: bool = False


@dataclass
class Window:
    w0: float
    w1: float

    @property
    def seconds(self) -> float:
        return self.w1 - self.w0


def percentile(values, q: float) -> Optional[float]:
    """The q-th percentile with linear interpolation between order
    statistics (numpy's default), or None for no values."""
    if len(values) == 0:
        return None
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def ttft_samples_ms(reqs, win: Window) -> list:
    out = []
    for r in reqs:
        if not (win.w0 <= r.due < win.w1):
            continue
        end = r.first if r.first is not None and r.first <= win.w1 else win.w1
        out.append((end - r.due) * 1e3)
    return out


def queue_samples_ms(reqs, win: Window) -> list:
    out = []
    for r in reqs:
        if not (win.w0 <= r.due < win.w1):
            continue
        start = (r.admit_start if r.admit_start is not None
                 and r.admit_start <= win.w1 else win.w1)
        out.append((start - r.due) * 1e3)
    return out


def tpot_samples_ms(reqs, win: Window) -> list:
    out = []
    for r in reqs:
        if r.retire is None or not (win.w0 < r.retire <= win.w1):
            continue
        n = len(r.tokens)
        if n >= 2:
            out.append((r.retire - r.first) * 1e3 / (n - 1))
    return out


def in_window(t0: float, t1: float, win: Window) -> bool:
    return t0 >= win.w0 and t1 <= win.w1


def window_tokens(chunks, admits, win: Window) -> int:
    return (sum(c.tokens for c in chunks if in_window(c.t0, c.t1, win))
            + sum(1 for a in admits if in_window(a.t0, a.t1, win)))


def queue_length(reqs, t: float) -> int:
    """Requests due by t and not yet admitted at t."""
    return sum(1 for r in reqs if r.due <= t
               and (r.admit_start is None or r.admit_start > t))
