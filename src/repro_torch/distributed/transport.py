"""Transports connecting the DraftWorker (edge) and TargetWorker (cloud)
(the port of the reference ``repro/distributed/transport.py``).

A transport delivers :mod:`repro_torch.distributed.wire` messages and
accounts the one-way delay each delivery imposes. The link is
FULL-DUPLEX: each direction (window stream draft→target, verdict stream
target→draft) is an independent in-flight queue.

Two delay models:

- :class:`InProcessTransport` — zero delay. The regression anchor: a
  session routed through it commits greedy tokens identical to the
  colocated ``DecodeSession`` path.
- :class:`EmulatedLinkTransport` — samples the link model of
  :mod:`repro_torch.sim.network` (RTT/2 + symmetric truncated jitter +
  payload/bandwidth serialization, from one :class:`LinkSpec`).

Delivery protocol: ``post_*`` stamps a message with its sampled one-way
delay and enqueues it (never blocks); ``recv_*`` dequeues the oldest
message and waits out whatever part of its flight the caller's compute did
not already hide. With ``sleep=True`` (wall-clock transports) the residual
wait is a real ``time.sleep``; with ``sleep=False`` it accumulates on a
virtual clock offset instead, so tests stay fast and deterministic while
the arithmetic is identical.

Every transport keeps per-direction ``delay_log`` lists of the SAMPLED
delays it imposed. Window and verdict deliveries pair into round trips BY
``round_id`` (not delivery order); :attr:`Transport.recent_rtt_ms` is the
mean of the recent pairs and is what
:meth:`repro_torch.core.session.DecodeSession._features` feeds the window
policy as ``rtt_recent_ms`` — AWC adapts to the link actually observed.
With one seed and one sequence of messages, every delay, byte count and
RTT equals the reference transport's.
"""

from __future__ import annotations

import random
import time
from collections import deque

from ..sim.network import (LinkSpec, RttTracker, expected_rtt_ms,
                           sample_one_way_ms)
from .wire import TransportProtocolError, VerdictMsg, WindowMsg

CONTROL_PAYLOAD_BYTES = 64   # fused-mode chunk flush / control messages

FWD = "window"    # draft → target
BWD = "verdict"   # target → draft


class Transport:
    """Base transport: full-duplex queues + delivery accounting + paired
    RTT measurement.

    Subclasses implement :meth:`_sample_delay_ms` (the imposed one-way
    delay for a payload). ``wall_clock`` tells both the transport and the
    session whether residual waits are real sleeps (part of measured wall
    time) or virtual-clock charges.
    """

    wall_clock: bool = True

    def __init__(self):
        self.bytes_sent = 0
        self.messages_sent = 0
        self.discarded_messages = 0
        # same paired estimator the sim's Link uses — sim and real paths
        # must compute the AWC rtt_recent_ms feature identically
        self._rtt = RttTracker()
        self._queues = {FWD: deque(), BWD: deque()}
        self._out_delay_ms: dict = {}          # round_id → window delay
        self.delay_log = {FWD: [], BWD: []}    # sampled delays, per direction
        self._voffset_s = 0.0                  # virtual clock (sleep=False)

    # -- delay model ---------------------------------------------------------

    def _sample_delay_ms(self, payload_bytes: int) -> float:
        raise NotImplementedError

    def _default_rtt_ms(self) -> float:
        return 0.0

    # -- clock ---------------------------------------------------------------

    def _now_s(self) -> float:
        """Hybrid clock: real compute time plus virtually-elapsed link
        waits (identical to wall time for sleeping transports)."""
        return time.perf_counter() + self._voffset_s

    # -- full-duplex post / recv ---------------------------------------------

    def _post(self, direction: str, msg, payload_bytes: int,
              round_id=None) -> float:
        delay_ms = self._sample_delay_ms(payload_bytes)
        self.bytes_sent += payload_bytes
        self.messages_sent += 1
        log = self.delay_log[direction]
        log.append(delay_ms)
        if len(log) > 512:
            del log[:256]
        if round_id is not None:
            if direction == FWD:
                self._out_delay_ms[round_id] = delay_ms
            else:
                out = self._out_delay_ms.pop(round_id, None)
                if out is not None:
                    self._rtt.record_rtt(out + delay_ms)
        self._queues[direction].append((msg, self._now_s() + delay_ms / 1e3))
        return delay_ms

    def _recv(self, direction: str):
        """Dequeue the oldest in-flight message on ``direction``; wait out
        the part of its flight not already hidden by the caller's compute.
        Returns ``(msg, waited_ms)`` — ``waited_ms`` is the UNHIDDEN link
        time actually imposed on the caller."""
        try:
            msg, ready_s = self._queues[direction].popleft()
        except IndexError:
            raise TransportProtocolError(
                f"recv on empty {direction!r} stream: nothing in flight "
                f"(recv-before-post or double-recv)") from None
        wait_s = ready_s - self._now_s()
        if wait_s <= 0.0:
            return msg, 0.0
        if self.wall_clock:
            t0 = time.perf_counter()
            time.sleep(wait_s)
            return msg, (time.perf_counter() - t0) * 1e3
        self._voffset_s += wait_s
        return msg, wait_s * 1e3

    def post_window(self, msg: WindowMsg) -> float:
        """Draft → target, non-blocking. Returns the sampled delay (ms)."""
        return self._post(FWD, msg, msg.payload_bytes, msg.round_id)

    def recv_window(self) -> tuple:
        return self._recv(FWD)

    def post_verdict(self, msg: VerdictMsg) -> float:
        """Target → draft, non-blocking. Returns the sampled delay (ms)."""
        return self._post(BWD, msg, msg.payload_bytes, msg.round_id)

    def recv_verdict(self) -> tuple:
        return self._recv(BWD)

    def discard_window(self):
        """Drop the oldest in-flight draft→target message without waiting:
        a verdict invalidated the speculative window it answers. The bytes
        were already spent on the wire (they stay counted); the pending
        RTT half-pair is cleared so it can never mismatch a later verdict."""
        try:
            msg, _ready = self._queues[FWD].popleft()
        except IndexError:
            raise TransportProtocolError(
                "discard_window on empty 'window' stream: no superseded "
                "speculative window in flight") from None
        self.discarded_messages += 1
        rid = getattr(msg, "round_id", None)
        if rid is not None:
            self._out_delay_ms.pop(rid, None)
        return msg

    # -- half-duplex convenience (propose → ship → verify → verdict) ---------

    def send_window(self, msg: WindowMsg) -> float:
        """Post + immediately wait out the delivery (half-duplex path).
        Returns the imposed one-way delay (ms)."""
        self.post_window(msg)
        return self._recv(FWD)[1]

    def send_verdict(self, msg: VerdictMsg) -> float:
        """Target → draft, blocking. Returns the imposed delay (ms)."""
        self.post_verdict(msg)
        return self._recv(BWD)[1]

    def control_roundtrip(self,
                          payload_bytes: int = CONTROL_PAYLOAD_BYTES) -> float:
        """One small out+back exchange (fused-mode token-stream flush)."""
        out = self._post(FWD, None, payload_bytes)
        _, w1 = self._recv(FWD)
        back = self._post(BWD, None, payload_bytes)
        _, w2 = self._recv(BWD)
        self._rtt.record_rtt(out + back)
        return w1 + w2

    # -- measurement ---------------------------------------------------------

    @property
    def recent_rtt_ms(self) -> float:
        """Mean of the recently completed round trips (window/verdict
        pairs matched by ``round_id``)."""
        return self._rtt.mean_recent_ms(self._default_rtt_ms())

    @property
    def in_flight(self) -> int:
        return len(self._queues[FWD]) + len(self._queues[BWD])

    def describe(self) -> str:
        return type(self).__name__


class InProcessTransport(Transport):
    """Colocated draft and target: zero-delay delivery.

    The messages still materialize on the host (token ids leave the device
    exactly as they would for a real link), so the protocol is identical —
    only the imposed delay is zero. Greedy tokens through this transport
    are identical to the colocated ``DecodeSession`` path."""

    wall_clock = True

    def _sample_delay_ms(self, payload_bytes: int) -> float:
        return 0.0

    def describe(self) -> str:
        return "in-process"


class EmulatedLinkTransport(Transport):
    """Edge–cloud link emulation driven by a :class:`LinkSpec`.

    Each delivery samples :func:`repro_torch.sim.network.sample_one_way_ms`
    — the delay model DSD-Sim's ``Link`` uses. With ``sleep=True``
    (default) the unhidden part of each flight blocks as real wall-clock
    sleep, so real-model decoding experiences the network the simulator
    predicts; with ``sleep=False`` it lands on the virtual clock instead
    (fast deterministic tests — seed the jitter RNG per test)."""

    def __init__(self, spec: LinkSpec, seed: int = 0, sleep: bool = True):
        super().__init__()
        self.spec = spec
        self.sleep = bool(sleep)
        self.wall_clock = self.sleep
        self._rng = random.Random(seed)

    def _sample_delay_ms(self, payload_bytes: int) -> float:
        return sample_one_way_ms(self.spec, self._rng, payload_bytes)

    def _default_rtt_ms(self) -> float:
        return expected_rtt_ms(self.spec)

    def describe(self) -> str:
        return (f"emulated-link(rtt={self.spec.rtt_ms}ms, "
                f"jitter={self.spec.jitter_ms}ms, "
                f"bw={self.spec.bandwidth_gbps}Gbps, sleep={self.sleep})")


def make_transport(link: LinkSpec | None, seed: int = 0,
                   sleep: bool = True) -> Transport | None:
    """Transport for one draft–target pair from its declarative
    :class:`LinkSpec` — the construction rule of every deployment surface
    (the ``launch.serve`` flags, the tests, ``chip_smoke.py``):

    - ``link is None``      → ``None`` (colocated pair: no transport, the
      engine's virtual ``rtt_ms`` accounting applies);
    - ``link.rtt_ms <= 0``  → :class:`InProcessTransport` (zero delay,
      bit-identical to the colocated path at temperature 0);
    - otherwise             → :class:`EmulatedLinkTransport` on ``link``
      (``sleep=False`` routes imposed delays to the virtual clock for
      fast deterministic tests).
    """
    if link is None:
        return None
    if link.rtt_ms <= 0:
        return InProcessTransport()
    return EmulatedLinkTransport(link, seed=seed, sleep=sleep)
