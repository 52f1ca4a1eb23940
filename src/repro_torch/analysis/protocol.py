"""Full-duplex transport protocol race detector, the port of the
reference's ``repro/analysis/protocol.py`` over the port's transports.

:class:`CheckedTransport` wraps any :class:`repro_torch.distributed.
transport.Transport` and validates the pipelined speculation protocol as a state
machine over round ids, raising :class:`ProtocolViolation` at the first
out-of-order operation instead of letting a race silently corrupt the
decode:

- a window round id is posted at most once;
- ``recv_window`` requires a window in flight (no blind dequeue);
- a verdict may only be posted for a round whose window the target
  actually received, and only once (no verdict-before-window, no
  double-verdict);
- ``recv_verdict`` requires a verdict in flight;
- ``discard_window`` may only drop an in-flight *speculative* window
  (the optimistic next-round draft a miss superseded);
- :meth:`CheckedTransport.assert_drained` certifies that nothing is left
  on the wire — i.e. every superseded speculative window was discarded.

The wrapper is behavior-transparent: every check runs before delegating
to the wrapped transport's own primitives, delay/RTT/byte accounting is
untouched, and everything else (``wall_clock``, ``recent_rtt_ms``,
``control_roundtrip``, ...) passes straight through.
"""

from __future__ import annotations

from collections import deque


class ProtocolViolation(AssertionError):
    """The full-duplex window/verdict protocol was driven out of order."""


# the wire module needs numpy and the sim's payload models only: the
# checker translates transport-level protocol errors without importing the
# transport and worker stack
from ..distributed.wire import TransportProtocolError as _TransportError


class CheckedTransport:
    """Protocol-validating proxy around a Transport instance."""

    def __init__(self, inner):
        self._inner = inner
        self._windows: deque = deque()       # (round_id, speculative) in flight
        self._verdicts: deque = deque()      # round ids in flight
        self._window_rounds: set = set()     # every round id ever posted
        self._window_received: set = set()   # received, awaiting verdict
        self._verdict_posted: set = set()
        self.checked_ops = 0

    def _delegate(self, fn, *args):
        """Run an inner-transport primitive; a transport-level protocol
        error (empty-stream recv, malformed frame, peer hangup) is the
        same class of bug this checker exists to catch — re-raise it as a
        :class:`ProtocolViolation` so the suite fails at the call site."""
        try:
            return fn(*args)
        except _TransportError as e:
            raise ProtocolViolation(f"transport protocol error: {e}") from e

    # -- checked protocol surface -------------------------------------------

    def post_window(self, msg):
        self.checked_ops += 1
        rid = msg.round_id
        if rid in self._window_rounds:
            raise ProtocolViolation(
                f"window round {rid} posted twice (round ids must be unique "
                f"per stream)")
        self._window_rounds.add(rid)
        self._windows.append((rid, bool(msg.speculative)))
        return self._delegate(self._inner.post_window, msg)

    def _check_recv_window(self) -> None:
        self.checked_ops += 1
        if not self._windows:
            raise ProtocolViolation(
                "recv_window with no window in flight (double-recv or "
                "recv-before-post)")
        rid, _spec = self._windows.popleft()
        self._window_received.add(rid)

    def recv_window(self):
        self._check_recv_window()
        return self._delegate(self._inner.recv_window)

    def post_verdict(self, msg):
        self.checked_ops += 1
        rid = msg.round_id
        if rid in self._verdict_posted:
            raise ProtocolViolation(f"verdict for round {rid} posted twice")
        if rid not in self._window_received:
            raise ProtocolViolation(
                f"verdict for round {rid} posted before its window was "
                f"received (windows seen: {sorted(self._window_received)})")
        self._verdict_posted.add(rid)
        self._verdicts.append(rid)
        return self._delegate(self._inner.post_verdict, msg)

    def _check_recv_verdict(self) -> None:
        self.checked_ops += 1
        if not self._verdicts:
            raise ProtocolViolation(
                "recv_verdict with no verdict in flight (double-recv or "
                "recv-before-post)")
        self._verdicts.popleft()

    def recv_verdict(self):
        self._check_recv_verdict()
        return self._delegate(self._inner.recv_verdict)

    def discard_window(self):
        self.checked_ops += 1
        if not self._windows:
            raise ProtocolViolation("discard_window with no window in flight")
        rid, spec = self._windows.popleft()
        if not spec:
            raise ProtocolViolation(
                f"discard_window dropped NON-speculative window round {rid} "
                f"— only superseded optimistic drafts may be discarded")
        return self._delegate(self._inner.discard_window)

    # half-duplex convenience paths: same checks, same base-class semantics
    def send_window(self, msg):
        self.post_window(msg)
        self._check_recv_window()
        return self._delegate(self._inner._recv, _FWD)[1]

    def send_verdict(self, msg):
        self.post_verdict(msg)
        self._check_recv_verdict()
        return self._delegate(self._inner._recv, _BWD)[1]

    # -- certification -------------------------------------------------------

    def assert_drained(self) -> None:
        """No window/verdict may remain in flight: every speculative
        window a miss superseded must have been discarded, every verdict
        consumed. Call at chunk/run boundaries."""
        if self._windows:
            rounds = [rid for rid, _ in self._windows]
            raise ProtocolViolation(
                f"undrained windows in flight for rounds {rounds} — "
                f"superseded speculative window never discarded")
        if self._verdicts:
            raise ProtocolViolation(
                f"undrained verdicts in flight for rounds "
                f"{list(self._verdicts)}")

    # -- transparency --------------------------------------------------------

    def describe(self) -> str:
        return self._inner.describe()

    def __getattr__(self, name):
        return getattr(self._inner, name)


# queue direction keys of repro_torch.distributed.transport, duplicated
# here so importing the checker never imports the transport stack
_FWD = "window"
_BWD = "verdict"
