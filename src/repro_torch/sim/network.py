"""The edge–cloud link model (the port of the link part of the reference
``repro/sim/network.py``): each message experiences RTT/2 one-way latency
plus sampled jitter plus a serialization term (payload_bytes / bandwidth).
Jitter is drawn from a truncated normal; truncation is SYMMETRIC
(±min(0.9·RTT/2, 4·jitter_ms)) so the sampled mean one-way delay equals
the analytic :func:`expected_one_way_ms` and the link never goes acausal.

The same delay model backs the real execution path: the port's
:class:`repro_torch.distributed.transport.EmulatedLinkTransport` samples
:func:`sample_one_way_ms` with the same :class:`LinkSpec` and imposes the
delay as wall-clock sleep (or on a virtual clock). Given one seed, the
delays, payload prices and RTT estimates equal the reference's exactly.

The event-driven ``Link`` of DSD-Sim comes with the simulator (ROADMAP
A14); this module holds only what the real path needs.
"""

from __future__ import annotations

import random
from dataclasses import dataclass


# Tokens streamed per fused-mode control round trip: the simulator's
# ``fused_chunk`` default AND the real path's stream-flush quantum
# (``repro_torch.core.session.FUSED_FLUSH_TOKENS``) — one constant so the
# fused-mode link charges cannot drift between sim and real.
DEFAULT_FUSED_CHUNK = 8


@dataclass
class LinkSpec:
    rtt_ms: float = 10.0
    jitter_ms: float = 1.0
    bandwidth_gbps: float = 1.0  # edge uplink
    name: str = "edge-cloud"


def sample_one_way_ms(spec: LinkSpec, rng: random.Random,
                      payload_bytes: int = 64) -> float:
    """One-way delay sample: RTT/2 + symmetric truncated jitter + serialization.

    Jitter ~ N(0, (jitter_ms/2)²) truncated to ±min(0.9·RTT/2, 4·jitter_ms).
    Symmetric truncation keeps the sample mean equal to
    ``expected_one_way_ms``, and the 0.9·RTT/2 bound keeps the delay
    strictly positive."""
    half_rtt = spec.rtt_ms / 2.0
    bound = min(0.9 * half_rtt, 4.0 * spec.jitter_ms)
    jitter = rng.gauss(0.0, spec.jitter_ms / 2.0)
    jitter = max(-bound, min(jitter, bound))
    ser_ms = payload_bytes * 8 / (spec.bandwidth_gbps * 1e9) * 1e3
    return max(0.0, half_rtt + jitter + ser_ms)


class RttTracker:
    """Round-trip estimation over explicitly paired one-way delays.

    Callers complete an exchange (window out + verdict back, or control
    out + stream back) and record the paired sum via :meth:`record_rtt`;
    a single direction's delay is never doubled, and pairing never depends
    on delivery order (the transport matches the two halves by wire
    ``round_id``). The AWC ``rtt_recent_ms`` feature reads
    :meth:`mean_recent_ms`."""

    __slots__ = ("_rtts",)

    def __init__(self):
        self._rtts: list[float] = []

    def record_rtt(self, rtt_ms: float) -> None:
        """Record one complete out+back round trip."""
        self._rtts.append(rtt_ms)
        if len(self._rtts) > 256:
            del self._rtts[:128]

    def mean_recent_ms(self, default: float) -> float:
        """Mean of the recently recorded round trips; ``default`` before
        the first completed exchange (half a pair is not an RTT)."""
        if not self._rtts:
            return default
        tail = self._rtts[-32:]
        return sum(tail) / len(tail)


def window_payload_bytes(gamma: int, n_nodes: int | None = None) -> int:
    """Draft→target payload: token ids (4B) + per-token draft prob (4B) +
    header. Tree windows (``n_nodes`` = grid entries incl. the anchor) are
    priced per NODE: id + draft prob + a 4B parent index."""
    if n_nodes is not None:
        return 48 + 12 * n_nodes
    return 48 + 8 * gamma


def verdict_payload_bytes(gamma: int) -> int:
    """Target→draft payload: accept count + corrected/bonus token id (8B)
    plus one 4B target logprob per window position + header."""
    return 48 + 8 + 4 * gamma


def expected_one_way_ms(spec: LinkSpec, payload_bytes: int = 64) -> float:
    return spec.rtt_ms / 2.0 + payload_bytes * 8 / (spec.bandwidth_gbps * 1e9) * 1e3


def expected_rtt_ms(spec: LinkSpec, out_payload_bytes: int = 64,
                    back_payload_bytes: int = 64) -> float:
    """Analytic round trip for an out+back exchange on ``spec``."""
    return (expected_one_way_ms(spec, out_payload_bytes)
            + expected_one_way_ms(spec, back_payload_bytes))
