"""Discrete-event simulation core for DSD-Sim.

SimPy is not available in this environment, so this module implements the
subset of SimPy semantics the paper's simulator relies on:

- ``Environment`` with a monotonically increasing virtual clock,
- generator-based *processes* that ``yield`` events,
- ``timeout(delay)`` delay events,
- ``Store`` — an unbounded FIFO channel with blocking ``get`` and
  non-blocking ``put`` (used for device queues),
- process join (``yield env.process(...)`` waits for completion).

The scheduler is deterministic: events scheduled at the same timestamp fire
in insertion order (stable heap via a sequence counter), which makes every
simulation run exactly reproducible given a seed for the workload.
"""

from __future__ import annotations

import heapq
from collections import deque
from typing import Any, Callable, Generator, Optional


class Event:
    """A one-shot event. Callbacks run when the event is triggered."""

    __slots__ = ("env", "callbacks", "value", "triggered", "_scheduled")

    def __init__(self, env: "Environment"):
        self.env = env
        self.callbacks: list[Callable[[Any], None]] = []
        self.value: Any = None
        self.triggered = False
        self._scheduled = False

    def succeed(self, value: Any = None) -> "Event":
        if self.triggered:
            raise RuntimeError("event already triggered")
        self.triggered = True
        self.value = value
        self._flush()
        return self

    def _flush(self) -> None:
        # Callbacks fire at the current simulation time, after any events
        # already queued "now" (FIFO among same-time events).
        if not self._scheduled and self.callbacks:
            self._scheduled = True
            self.env._schedule(self.env.now, self._run_callbacks)

    def _run_callbacks(self) -> None:
        callbacks, self.callbacks = self.callbacks, []
        self._scheduled = False
        for cb in callbacks:
            cb(self.value)

    def add_callback(self, cb: Callable[[Any], None]) -> None:
        if self.triggered:
            self.callbacks.append(cb)
            self._flush()
        else:
            self.callbacks.append(cb)


class Timeout(Event):
    """An event that fires ``delay`` time units after creation."""

    __slots__ = ()

    def __init__(self, env: "Environment", delay: float, value: Any = None):
        if delay < 0:
            raise ValueError(f"negative timeout delay: {delay}")
        super().__init__(env)
        self.value = value
        env._schedule(env.now + delay, self._fire)

    def _fire(self) -> None:
        self.triggered = True
        self._flush()


class Process(Event):
    """Wraps a generator; the process resumes whenever its yielded event fires.

    The Process is itself an Event that triggers (with the generator's return
    value) when the generator completes, enabling ``yield env.process(...)``
    joins.
    """

    __slots__ = ("_gen",)

    def __init__(self, env: "Environment", gen: Generator):
        super().__init__(env)
        self._gen = gen
        env._schedule(env.now, lambda: self._step(None))

    def _step(self, value: Any) -> None:
        try:
            target = self._gen.send(value)
        except StopIteration as stop:
            self.succeed(getattr(stop, "value", None))
            return
        if not isinstance(target, Event):
            raise TypeError(
                f"process yielded {target!r}; processes must yield Event objects"
            )
        target.add_callback(self._step)


class Store:
    """Unbounded FIFO store (queue) with blocking ``get``.

    ``items`` is exposed read-only so batching policies can inspect queue
    contents (e.g. length-aware batching scans waiting requests).
    """

    __slots__ = ("env", "items", "_getters")

    def __init__(self, env: "Environment"):
        self.env = env
        self.items: deque = deque()
        self._getters: deque[Event] = deque()

    def __len__(self) -> int:
        return len(self.items)

    def put(self, item: Any) -> None:
        self.items.append(item)
        self._dispatch()

    def _dispatch(self) -> None:
        while self._getters and self.items:
            getter = self._getters.popleft()
            getter.succeed(self.items.popleft())

    def get(self) -> Event:
        ev = Event(self.env)
        if self.items:
            ev.succeed(self.items.popleft())
        else:
            self._getters.append(ev)
        return ev

    def pop_where(self, pred: Callable[[Any], bool]) -> Optional[Any]:
        """Remove and return the first queued item matching ``pred`` (or None).

        Used by length-aware batching to pull similar-length requests out of
        the middle of the queue.
        """
        for i, item in enumerate(self.items):
            if pred(item):
                del self.items[i]
                return item
        return None


class Environment:
    """Deterministic event loop with a virtual clock."""

    __slots__ = ("now", "_heap", "_seq")

    def __init__(self):
        self.now: float = 0.0
        self._heap: list[tuple[float, int, Callable[[], None]]] = []
        self._seq = 0

    def _schedule(self, at: float, fn: Callable[[], None]) -> None:
        self._seq += 1
        heapq.heappush(self._heap, (at, self._seq, fn))

    def timeout(self, delay: float, value: Any = None) -> Timeout:
        return Timeout(self, delay, value)

    def event(self) -> Event:
        return Event(self)

    def process(self, gen: Generator) -> Process:
        return Process(self, gen)

    def store(self) -> Store:
        return Store(self)

    def run(self, until: Optional[float] = None) -> None:
        """Run until the heap drains or the clock passes ``until``."""
        while self._heap:
            at, _, fn = self._heap[0]
            if until is not None and at > until:
                self.now = until
                return
            heapq.heappop(self._heap)
            self.now = at
            fn()
        if until is not None:
            self.now = max(self.now, until)
