"""Compile-once on the card: each step of a decode session captured once as
a CUDA graph and replayed for every later round or admission — the torch
form of the reference engine's ``jax.jit(..., donate_argnums=...)`` steps
and its ``_jit_cache`` (``repro/core/engine.py``).

A :class:`CapturedStep` wraps one step as a function of no arguments that
reads every input from, and writes every result into, tensors whose
addresses never change (the session's caches, cursors and stats rows, and
the step's own static ``inputs``). A call first copies the values it is
given into those inputs, then:

1. the first call is the warm-up: the step runs eagerly on the session's
   side stream and is a real round or admission. It pays for what must
   not happen under capture: the kernel library's build and load,
   ``cudaFuncSetAttribute`` on a kernel's first launch, cuBLAS handles and
   workspaces for the stream;
2. the second call captures the step on that stream (capture runs
   nothing) and replays the graph at once, which does the round;
3. every later call only replays.

With ``capture=False`` (a CPU session by the device rule, or an explicit
eager session on the card) every call runs the step eagerly: one code
path, two ways to run it. A failed capture raises; nothing falls back to
the eager path on its own.

At temperature > 0 the session's device generator is registered with the
graph, so each replay draws fresh numbers from it, the ones the eager step
would have drawn (Philox offsets advance by the graph's total on every
replay).

Kernel launches are host counts (:data:`repro_torch.kernels.LAUNCHES`).
Capture launches nothing, so the launches the captured body counted are
taken back and kept; every replay adds them again, and the counts stay
what an eager run would show.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..kernels import LAUNCHES

# graphs captured by every CapturedStep of this process (the re-capture
# sentry's global count, ``analysis/sanitize.py``)
_GRAPHS_CAPTURED = 0


def graphs_captured() -> int:
    """CUDA graphs captured in this process so far."""
    return _GRAPHS_CAPTURED


@dataclass
class GraphCounts:
    """An engine's graph bookkeeping, summed over its sessions' steps."""
    captured: int = 0        # graphs captured
    replays: int = 0         # calls served by a replay (the capture's own
                             # replay included)
    warm_ups: int = 0        # eager first calls of steps that capture


class CapturedStep:
    """One step of one decode session: warm-up, capture, replays.

    ``body``       the step, no arguments; reads and writes only tensors
                   whose addresses stay fixed,
    ``inputs``     its static inputs by name (device tensors the body
                   reads); a call ``step(name=value, ...)`` copies each
                   value in first,
    ``counts``     the engine's :class:`GraphCounts`,
    ``capture``    False: every call runs ``body`` eagerly,
    ``stream``     the side stream of the warm-up and the capture (CUDA),
    ``generator``  the device generator the body draws from, registered
                   with the graph (None when the body draws nothing).
    """

    def __init__(self, body: Callable[[], None], inputs: dict,
                 counts: GraphCounts, *, capture: bool,
                 stream: Optional["torch.cuda.Stream"] = None,
                 generator: Optional[torch.Generator] = None):
        self.body = body
        self.inputs = inputs
        self.counts = counts
        self.capture = bool(capture)
        self.stream = stream
        self.generator = generator
        self.graph = None
        self.launches: dict[str, int] = {}   # launches one replay makes
        self.calls = 0

    @property
    def captures_next(self) -> bool:
        """The next call captures: it synchronizes the device on entry
        (``torch.cuda.graph``), so callers run it outside ``no_host_sync``."""
        return self.capture and self.graph is None and self.calls == 1

    def __call__(self, **values) -> None:
        for name, value in values.items():
            self.inputs[name].copy_(value)
        first = self.calls == 0
        self.calls += 1
        if not self.capture:
            self.body()
        elif first:
            self._warm_up()
        else:
            if self.graph is None:
                self._capture()
            self._replay()

    # --------------------------------------------------------------- phases

    def _warm_up(self) -> None:
        with self._on_side_stream():
            self.body()
        self.counts.warm_ups += 1

    def _capture(self) -> None:
        graph = self._new_graph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        before = dict(LAUNCHES)
        with self._capturing(graph):
            self.body()
        # nothing ran: take back what the body counted, keep it per replay
        self.launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES
                         if LAUNCHES[k] != before[k]}
        for k, n in self.launches.items():
            LAUNCHES[k] -= n
        self.graph = graph
        self.counts.captured += 1
        global _GRAPHS_CAPTURED
        _GRAPHS_CAPTURED += 1

    def _replay(self) -> None:
        self.graph.replay()
        for k, n in self.launches.items():
            LAUNCHES[k] += n
        self.counts.replays += 1

    # the three points where the card's stream and graph API enter (a test
    # stands in for them)

    @contextlib.contextmanager
    def _on_side_stream(self):
        main = torch.cuda.current_stream()
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            yield
        main.wait_stream(self.stream)

    def _new_graph(self):
        return torch.cuda.CUDAGraph()

    def _capturing(self, graph) -> contextlib.AbstractContextManager:
        return torch.cuda.graph(graph, stream=self.stream)
