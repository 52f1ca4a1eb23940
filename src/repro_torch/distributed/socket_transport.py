"""TCP socket transport: the edge–cloud boundary as real byte streams (the
port of the reference ``repro/distributed/socket_transport.py``).

:class:`SocketTransport` is a :class:`repro_torch.distributed.transport.
Transport` whose two protocol directions are two REAL TCP streams —
windows draft→target on one, verdicts target→draft on the other.
Messages cross as length-prefixed frames over the hardened
:func:`repro_torch.distributed.wire.encode_window` /
:func:`~repro_torch.distributed.wire.decode_window` codecs (and the
verdict pair); a third frame kind carries small JSON control messages for
the fused-mode flush.

Frame layout (little-endian), the reference's byte for byte, so a frame
written by either package is read by the other::

    4s  magic           b"DSDF"
    B   kind            FRAME_WINDOW | FRAME_VERDICT | FRAME_CONTROL
    d   ready_s         sender CLOCK_MONOTONIC deadline for link emulation
    d   delay_ms        the sampled one-way delay behind ``ready_s``
    I   length          payload byte count (0 allowed for control frames)

Link emulation: when the transport carries a
:class:`repro_torch.sim.network.LinkSpec`, the SENDER samples the one-way
delay and stamps ``ready_s = now + delay`` into the frame; the RECEIVER
sleeps only the residual part of the flight its own compute did not hide.

Three constructors:

- :meth:`SocketTransport.loopback` — one object holding BOTH ends of two
  localhost streams: a drop-in transport for a single-process session
  whose every message still crosses the kernel's TCP stack.
- :meth:`SocketTransport.draft_endpoint` /
  :meth:`SocketTransport.target_endpoint` — one HALF each: the draft half
  sends windows / receives verdicts, the target half the reverse.

``bytes_sent`` keeps charging the paper's modeled payload bytes (sim ↔
real comparability); the actual framed bytes are in ``wire_bytes``.
Protocol breakage — EOF mid-frame, bad magic, unknown kind, oversized
length, recv timeout, sending on a direction this endpoint does not own, a
window the codec refuses (one carrying ``q_probs``) — raises
:class:`repro_torch.distributed.wire.TransportProtocolError`.
"""

from __future__ import annotations

import json
import random
import socket
import struct
import time

from ..sim.network import LinkSpec, expected_rtt_ms, sample_one_way_ms
from .transport import BWD, FWD, Transport
from .wire import (TransportProtocolError, VerdictMsg, WindowMsg,
                   decode_verdict, decode_window, encode_verdict,
                   encode_window)

# magic, kind, ready_s (monotonic deadline), delay_ms (sampled), length
_FRAME_HDR = struct.Struct("<4sBddI")
_FRAME_MAGIC = b"DSDF"
_MAX_FRAME_BYTES = 64 << 20          # sanity bound on header-declared length

FRAME_WINDOW = 1
FRAME_VERDICT = 2
FRAME_CONTROL = 3


def _encode_control(obj) -> bytes:
    return b"" if obj is None else json.dumps(obj).encode("utf-8")


def _decode_control(payload: bytes):
    return None if not payload else json.loads(payload.decode("utf-8"))


# Kind ↔ codec tables: every frame kind has both halves of its codec.
FRAME_ENCODERS = {
    FRAME_WINDOW: encode_window,
    FRAME_VERDICT: encode_verdict,
    FRAME_CONTROL: _encode_control,
}
FRAME_DECODERS = {
    FRAME_WINDOW: decode_window,
    FRAME_VERDICT: decode_verdict,
    FRAME_CONTROL: _decode_control,
}


def send_frame(sock: socket.socket, kind: int, payload: bytes,
               ready_s: float = 0.0, delay_ms: float = 0.0) -> int:
    """Write one length-prefixed frame; returns total bytes on the wire."""
    if kind not in FRAME_ENCODERS:
        raise TransportProtocolError(f"send_frame: unknown frame kind {kind}")
    if len(payload) > _MAX_FRAME_BYTES:
        raise TransportProtocolError(
            f"send_frame: payload of {len(payload)} bytes exceeds the "
            f"{_MAX_FRAME_BYTES}-byte frame bound")
    head = _FRAME_HDR.pack(_FRAME_MAGIC, kind, ready_s, delay_ms,
                           len(payload))
    try:
        sock.sendall(head + payload)
    except OSError as e:
        raise TransportProtocolError(f"send_frame: peer gone ({e})") from e
    return len(head) + len(payload)


def _recv_exact(sock: socket.socket, n: int, what: str) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except socket.timeout:
            raise TransportProtocolError(
                f"recv_frame: timed out waiting for {what} "
                f"({len(buf)}/{n} bytes)") from None
        except OSError as e:
            raise TransportProtocolError(
                f"recv_frame: socket error reading {what} ({e})") from e
        if not chunk:
            raise TransportProtocolError(
                f"recv_frame: peer closed the stream mid-{what} "
                f"({len(buf)}/{n} bytes)")
        buf += chunk
    return bytes(buf)


def recv_frame(sock: socket.socket):
    """Read one frame; returns ``(kind, payload, ready_s, delay_ms)``.
    Malformed framing raises :class:`TransportProtocolError`."""
    head = _recv_exact(sock, _FRAME_HDR.size, "frame header")
    magic, kind, ready_s, delay_ms, length = _FRAME_HDR.unpack(head)
    if magic != _FRAME_MAGIC:
        raise TransportProtocolError(
            f"recv_frame: bad frame magic {magic!r} at offset 0 "
            f"(want {_FRAME_MAGIC!r}) — streams out of sync")
    if kind not in FRAME_DECODERS:
        raise TransportProtocolError(f"recv_frame: unknown frame kind {kind}")
    if length > _MAX_FRAME_BYTES:
        raise TransportProtocolError(
            f"recv_frame: declared payload of {length} bytes exceeds the "
            f"{_MAX_FRAME_BYTES}-byte frame bound — corrupt length prefix")
    payload = _recv_exact(sock, length, "frame payload") if length else b""
    return kind, payload, ready_s, delay_ms


def _tcp_pair(timeout_s: float):
    """One connected localhost TCP stream; returns (client, server) ends."""
    lst = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        lst.bind(("127.0.0.1", 0))
        lst.listen(1)
        cli = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        cli.connect(lst.getsockname())
        srv, _ = lst.accept()
    finally:
        lst.close()
    for s in (cli, srv):
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        s.settimeout(timeout_s)
    return cli, srv


class SocketTransport(Transport):
    """Transport over two TCP streams (see module docstring).

    ``tx`` / ``rx`` map protocol directions (``FWD`` = window stream,
    ``BWD`` = verdict stream) to connected sockets. The loopback shape
    owns all four endpoints; an endpoint half owns one per table.
    """

    wall_clock = True

    def __init__(self, tx: dict, rx: dict, *, link: LinkSpec | None = None,
                 seed: int = 0, timeout_s: float = 30.0, owned=()):
        super().__init__()
        self._tx = dict(tx)
        self._rx = dict(rx)
        self.link = link
        self.timeout_s = float(timeout_s)
        self._rng = random.Random(seed)
        self._owned = list(owned)
        self.wire_bytes = 0              # actual framed bytes, incl. headers
        self._live = {FWD: 0, BWD: 0}    # best-effort in-flight counters
        for s in set(self._tx.values()) | set(self._rx.values()):
            s.settimeout(self.timeout_s)

    # -- construction shapes -------------------------------------------------

    @classmethod
    def loopback(cls, link: LinkSpec | None = None, seed: int = 0,
                 timeout_s: float = 30.0) -> "SocketTransport":
        """Both ends of both streams in one object: a drop-in transport
        for a single-process session whose every message still crosses
        the kernel's TCP stack."""
        w_tx, w_rx = _tcp_pair(timeout_s)
        v_tx, v_rx = _tcp_pair(timeout_s)
        return cls(tx={FWD: w_tx, BWD: v_tx}, rx={FWD: w_rx, BWD: v_rx},
                   link=link, seed=seed, timeout_s=timeout_s,
                   owned=[w_tx, w_rx, v_tx, v_rx])

    @classmethod
    def draft_endpoint(cls, window_sock: socket.socket,
                       verdict_sock: socket.socket, *,
                       link: LinkSpec | None = None, seed: int = 0,
                       timeout_s: float = 30.0) -> "SocketTransport":
        """Edge half: sends windows, receives verdicts."""
        return cls(tx={FWD: window_sock}, rx={BWD: verdict_sock}, link=link,
                   seed=seed, timeout_s=timeout_s,
                   owned=[window_sock, verdict_sock])

    @classmethod
    def target_endpoint(cls, window_sock: socket.socket,
                        verdict_sock: socket.socket, *,
                        link: LinkSpec | None = None, seed: int = 0,
                        timeout_s: float = 30.0) -> "SocketTransport":
        """Cloud half: receives windows, sends verdicts."""
        return cls(tx={BWD: verdict_sock}, rx={FWD: window_sock}, link=link,
                   seed=seed, timeout_s=timeout_s,
                   owned=[window_sock, verdict_sock])

    def _sock(self, table: dict, direction: str, op: str) -> socket.socket:
        try:
            return table[direction]
        except KeyError:
            raise TransportProtocolError(
                f"{op} on {direction!r}: this endpoint does not own that "
                f"direction (split draft/target half)") from None

    # -- delay model ---------------------------------------------------------

    def _sample_delay_ms(self, payload_bytes: int) -> float:
        if self.link is None:
            return 0.0
        return sample_one_way_ms(self.link, self._rng, payload_bytes)

    def _default_rtt_ms(self) -> float:
        return expected_rtt_ms(self.link) if self.link is not None else 0.0

    # -- framed post / recv --------------------------------------------------

    def _post(self, direction: str, msg, payload_bytes: int,
              round_id=None) -> float:
        sock = self._sock(self._tx, direction, "post")
        if msg is None or isinstance(msg, dict):
            kind = FRAME_CONTROL
        else:
            kind = FRAME_WINDOW if direction == FWD else FRAME_VERDICT
        try:
            payload = FRAME_ENCODERS[kind](msg)
        except ValueError as e:
            raise TransportProtocolError(
                f"post on {direction!r}: message refused by the wire codec "
                f"({e})") from e
        delay_ms = self._sample_delay_ms(payload_bytes)
        ready_s = time.perf_counter() + delay_ms / 1e3
        self.wire_bytes += send_frame(sock, kind, payload, ready_s, delay_ms)
        self.bytes_sent += payload_bytes     # modeled bytes (sim parity)
        self.messages_sent += 1
        log = self.delay_log[direction]
        log.append(delay_ms)
        if len(log) > 512:
            del log[:256]
        if round_id is not None and direction == FWD:
            # RTT pairing completes at recv(BWD) — the verdict frame
            # carries its own sampled delay — so a SPLIT draft endpoint
            # measures round trips too, not just the loopback shape.
            self._out_delay_ms[round_id] = delay_ms
        self._live[direction] += 1
        return delay_ms

    def _recv(self, direction: str):
        sock = self._sock(self._rx, direction, "recv")
        kind, payload, ready_s, delay_ms = recv_frame(sock)
        expected = FRAME_WINDOW if direction == FWD else FRAME_VERDICT
        if kind not in (expected, FRAME_CONTROL):
            raise TransportProtocolError(
                f"recv on {direction!r}: got frame kind {kind}, want "
                f"{expected} or control — streams crossed")
        try:
            msg = FRAME_DECODERS[kind](payload)
        except ValueError as e:
            raise TransportProtocolError(
                f"recv on {direction!r}: undecodable payload ({e})") from e
        if direction == BWD and isinstance(msg, VerdictMsg):
            out = self._out_delay_ms.pop(msg.round_id, None)
            if out is not None:
                self._rtt.record_rtt(out + delay_ms)
        self._live[direction] -= 1
        wait_s = ready_s - time.perf_counter()
        if wait_s <= 0.0:
            return msg, 0.0
        t0 = time.perf_counter()
        time.sleep(wait_s)
        return msg, (time.perf_counter() - t0) * 1e3

    def discard_window(self):
        """Read and drop the oldest window frame without waiting out its
        emulated flight (the bytes were already spent on the wire)."""
        sock = self._sock(self._rx, FWD, "discard_window")
        kind, payload, _ready_s, _delay_ms = recv_frame(sock)
        if kind != FRAME_WINDOW:
            raise TransportProtocolError(
                f"discard_window: got frame kind {kind}, want window")
        try:
            msg = FRAME_DECODERS[kind](payload)
        except ValueError as e:
            raise TransportProtocolError(
                f"discard_window: undecodable window ({e})") from e
        self.discarded_messages += 1
        self._live[FWD] -= 1
        self._out_delay_ms.pop(msg.round_id, None)
        return msg

    def control_roundtrip(self, payload_bytes: int = 64) -> float:
        if FWD not in self._tx or FWD not in self._rx:
            raise TransportProtocolError(
                "control_roundtrip needs both ends of both streams "
                "(loopback shape); split endpoints exchange control frames "
                "through their own command loop")
        return super().control_roundtrip(payload_bytes)

    # -- lifecycle / measurement ---------------------------------------------

    @property
    def in_flight(self) -> int:
        return max(0, self._live[FWD]) + max(0, self._live[BWD])

    def close(self) -> None:
        for s in self._owned:
            try:
                s.close()
            except OSError:
                pass
        self._owned = []

    def __del__(self):  # pragma: no cover - interpreter-shutdown best effort
        try:
            self.close()
        except Exception:
            pass

    def describe(self) -> str:
        shape = ("loopback" if FWD in self._tx and FWD in self._rx
                 else "draft-endpoint" if FWD in self._tx
                 else "target-endpoint")
        link = ("none" if self.link is None
                else f"rtt={self.link.rtt_ms}ms")
        return f"socket({shape}, link={link})"
