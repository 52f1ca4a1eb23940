"""Routing and batching policies for DSD-Sim (paper §3.4).

Routing policies pick a target server for each request given a read-only
snapshot of queue depths. Batching policies decide which queued jobs form
the next batch on a target server.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Callable, Optional, Protocol, Sequence


# --------------------------------------------------------------------------
# Routing
# --------------------------------------------------------------------------

class RoutingPolicy(Protocol):
    def route(self, request: Any, queue_depths: Sequence[int]) -> int: ...
    def name(self) -> str: ...


class RandomRouting:
    def __init__(self, seed: int = 0):
        self.rng = random.Random(seed)

    def route(self, request: Any, queue_depths: Sequence[int]) -> int:
        return self.rng.randrange(len(queue_depths))

    def name(self) -> str:
        return "random"


class RoundRobinRouting:
    def __init__(self):
        self._next = 0

    def route(self, request: Any, queue_depths: Sequence[int]) -> int:
        i = self._next % len(queue_depths)
        self._next += 1
        return i

    def name(self) -> str:
        return "round_robin"


class JSQRouting:
    """Join-the-Shortest-Queue; ties broken by lowest index (deterministic)."""

    def route(self, request: Any, queue_depths: Sequence[int]) -> int:
        best, best_d = 0, None
        for i, d in enumerate(queue_depths):
            if best_d is None or d < best_d:
                best, best_d = i, d
        return best

    def name(self) -> str:
        return "jsq"


class PinnedRouting:
    """Fixed drafter→target map: request ``r`` on drafter ``d`` always
    verifies on ``target_of_drafter[d]``. This is how a declarative
    topology's draft–target PAIRS materialize in the simulator
    (:func:`repro_torch.topology.build_simulation`): drafter i is pair i, and
    its routing is part of the spec, not a load-balancing decision."""

    def __init__(self, target_of_drafter: Sequence[int]):
        assert len(target_of_drafter) >= 1, "need at least one pair"
        self.target_of_drafter = list(target_of_drafter)

    def route(self, request: Any, queue_depths: Sequence[int]) -> int:
        did = getattr(request, "drafter_id", 0)
        return self.target_of_drafter[did % len(self.target_of_drafter)]

    def name(self) -> str:
        return "pinned"


ROUTING: dict[str, Callable[..., Any]] = {
    "random": RandomRouting,
    "round_robin": RoundRobinRouting,
    "jsq": JSQRouting,
}


# --------------------------------------------------------------------------
# Pair routing (arrival-time lane assignment)
# --------------------------------------------------------------------------

@dataclass
class SimPairView:
    """Read-only per-PAIR snapshot for arrival-time lane assignment.

    One entry per drafter lane (under :class:`PinnedRouting` drafter i IS
    pair i, so this is the sim twin of the real server's
    ``(pairs, free_slots)`` routing view): current queue depth (queued +
    in-service), the lane's recent link RTT, and its rolling acceptance."""
    queue_depths: list[int]
    rtt_ms: list[float]
    alpha: list[float]
    max_batch: int = 16


class PairRoutingPolicy(Protocol):
    """Assigns an unpinned record (``drafter_id < 0``) to a drafter lane
    when it ARRIVES — the analogue of the real server's ``PairRouter``
    (sticky: the lane never changes afterwards). Distinct from
    :class:`RoutingPolicy`, which picks a target server per verify job."""

    def route_pair(self, record: Any, view: SimPairView) -> int: ...
    def name(self) -> str: ...


# --------------------------------------------------------------------------
# Batching
# --------------------------------------------------------------------------

@dataclass
class BatchingConfig:
    max_batch: int = 16
    batch_window_ms: float = 2.0     # wait this long after first arrival
    continuous: bool = True          # iteration-level (ORCA-style) batching
    chunked_prefill: bool = False    # split long prompts into chunks
    prefill_chunk: int = 512


class BatchingPolicy(Protocol):
    def form_batch(self, queue, head: Any, cfg: BatchingConfig) -> list[Any]: ...
    def name(self) -> str: ...


class FIFOBatching:
    """Take the head plus the next max_batch-1 jobs in arrival order."""

    def form_batch(self, queue, head: Any, cfg: BatchingConfig) -> list[Any]:
        batch = [head]
        while queue.items and len(batch) < cfg.max_batch:
            batch.append(queue.items.popleft())
        return batch

    def name(self) -> str:
        return "fifo"


class LengthAwareBatching:
    """LAB (paper §5.3): batch the head-of-line job with queued jobs whose
    context lengths are closest to it, minimizing intra-batch padding."""

    def form_batch(self, queue, head: Any, cfg: BatchingConfig) -> list[Any]:
        batch = [head]
        if not queue.items or len(batch) >= cfg.max_batch:
            return batch
        head_len = getattr(head, "sort_len", 0)
        candidates = sorted(
            queue.items, key=lambda j: abs(getattr(j, "sort_len", 0) - head_len))
        chosen = candidates[: cfg.max_batch - 1]
        chosen_ids = {id(c) for c in chosen}
        # remove chosen from the queue preserving order of the rest
        remaining = [j for j in queue.items if id(j) not in chosen_ids]
        queue.items.clear()
        queue.items.extend(remaining)
        batch.extend(chosen)
        return batch

    def name(self) -> str:
        return "lab"


BATCHING: dict[str, Callable[..., Any]] = {
    "fifo": FIFOBatching,
    "lab": LengthAwareBatching,
}
