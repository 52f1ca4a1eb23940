"""Runtime re-capture sentry, the torch form of the reference's
``repro/analysis/sanitize.py``.

The engine's capture-once contract (one captured CUDA graph per step of a
slot pool, ``core/capture.py``; a second session of known geometry only
replays) is checked here: :func:`capture_guard` turns "this region must
not capture" into a context manager that raises on exit.

:func:`total_graphs_captured` counts the CUDA graphs captured in this
process since it started (every :class:`~repro_torch.core.capture.
CapturedStep` counts its capture): what an untracked guard snapshots.
With ``track`` (engines, or any object with ``graphs.captured`` and
``step_programs()``), a guard counts the tracked engines' graphs captured
and steps built instead: the capture-once invariant of those engines
specifically. A worker host runs each steady-state wave under one
(``distributed/host.py``).
"""

from __future__ import annotations


def total_graphs_captured() -> int:
    """CUDA graphs captured in this process so far."""
    from ..core.capture import graphs_captured
    return graphs_captured()


class RecaptureError(RuntimeError):
    """A guarded region captured more graphs (or built more steps) than it
    declared."""


class CaptureGuard:
    """Context manager asserting a bounded number of captures.

    ``allowed`` is the number of graphs (and, tracked, steps) the region
    may add (0 for steady-state regions; ``None`` to only count). ``.count``
    is live inside the region; on a clean exit the guard raises
    :class:`RecaptureError` iff ``count > allowed``. An exception already
    propagating out of the region takes precedence."""

    def __init__(self, allowed: int | None = 0, what: str = "",
                 track=None):
        self.allowed = None if allowed is None else int(allowed)
        self.what = what
        if track is not None and not isinstance(track, (list, tuple)):
            track = [track]
        self.track = list(track) if track else None
        self._start = (0, 0)

    def _now(self) -> tuple[int, int]:
        if self.track:
            return (sum(t.graphs.captured for t in self.track),
                    sum(t.step_programs() for t in self.track))
        return (total_graphs_captured(), 0)

    def __enter__(self) -> "CaptureGuard":
        self._start = self._now()
        return self

    @property
    def graphs(self) -> int:
        return self._now()[0] - self._start[0]

    @property
    def steps(self) -> int:
        return self._now()[1] - self._start[1]

    @property
    def count(self) -> int:
        return self.graphs + self.steps

    def __exit__(self, exc_type, exc, tb) -> bool:
        if (exc_type is None and self.allowed is not None
                and self.count > self.allowed):
            label = f"{self.what}: " if self.what else ""
            raise RecaptureError(
                f"{label}captured {self.graphs} graph(s) and built "
                f"{self.steps} step(s) where at most {self.allowed} were "
                f"allowed — the capture-once invariant is broken")
        return False


def capture_guard(track=None, what: str = "",
                  allowed: int | None = 0) -> CaptureGuard:
    """``with capture_guard(engine, "steady-state wave"): ...`` (tracked)
    or ``with capture_guard(allowed=0, what="…"): ...`` (every graph of
    the process)."""
    return CaptureGuard(allowed=allowed, what=what, track=track)
