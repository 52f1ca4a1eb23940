"""Wire types for distributed draft–target execution (the port of the
reference ``repro/distributed/wire.py``; numpy only).

These are the ONLY objects that cross the edge–cloud boundary in the real
execution path (paper Fig. 1b): the draft ships a speculation window
(token ids + per-token draft probabilities), the target ships back a
verdict (accept count + corrected/bonus token + per-position logprobs).
Payload sizes come from the link model's price functions
(:func:`repro_torch.sim.network.window_payload_bytes` /
:func:`repro_torch.sim.network.verdict_payload_bytes`), scaled by the
number of slots actively decoding.

- ``round_id`` orders the exchange stream: a window and its verdict carry
  the same id, which lets a full-duplex transport pair the two one-way
  delays of one exchange into a measured RTT even when deliveries
  interleave.
- ``speculative`` marks a window proposed optimistically while the
  previous one was still being verified (the pipelined mode); a receiver
  may discard it unverified.

``q_probs`` (the draft distributions the stochastic accept/resample rule
needs at temperature > 0) is a device pass-through: a CUDA (or CPU)
tensor that stays where it is and is never serialized; the payload price
already counts the paper's per-token q(t_i). Greedy decoding does not use
it.

:func:`encode_window` / :func:`decode_window` (and the verdict pair) give
the messages their byte representation, the same bytes as the reference's
codecs for the same message: the same ``struct`` headers and magics, the
same hardened decode errors, the same refusal of a window that carries
``q_probs``. Either package decodes the other's bytes.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Any

import numpy as np

from ..sim.network import verdict_payload_bytes, window_payload_bytes


class TransportProtocolError(RuntimeError):
    """The transport delivery contract was broken: a recv/discard on an
    empty stream, a malformed or truncated frame off a real socket, a
    message the wire codec refuses, or a peer that hung up mid-exchange."""


@dataclass
class WindowMsg:
    """Draft → target: one speculation window for the whole slot batch.

    Tree rounds (``n_nodes > 0``) ship the (B, T) grid window — entry 0
    is the anchor — plus the (T,) parent table that pins the tree
    topology; the payload is then priced per NODE (token id + parent
    index + per-node q(t)), strictly more bytes than a linear window of
    the same depth. ``n_nodes == 0`` is today's linear chain, byte-for-
    byte unchanged on the wire."""
    tokens: np.ndarray            # (B, gamma_max | n_nodes) int32 proposals
    gamma: int                    # active window size this round (≤ gamma_max)
    n_active: int                 # slots actually decoding (payload scaling)
    q_probs: Any = None           # wire-passthrough: (B, gamma_max, V) draft
                                  # dists, a device tensor never serialized
    round_id: int = 0             # exchange ordinal (pairs with its verdict)
    speculative: bool = False     # optimistic pipeline window (invalidatable)
    n_nodes: int = 0              # tree entries incl. anchor (0 = linear)
    branches: int = 1             # active branch width this round (≤ b_max)
    parent: Any = None            # (n_nodes,) int32 parent table (tree only)

    @property
    def payload_bytes(self) -> int:
        per = (window_payload_bytes(self.gamma, n_nodes=self.n_nodes)
               if self.n_nodes else window_payload_bytes(self.gamma))
        return max(1, self.n_active) * per


@dataclass
class VerdictMsg:
    """Target → draft: the verdict for one speculation window.

    ``n_accepted``/``num_new`` are post-lifecycle (budget/EOS-clamped)
    counts; ``next_token`` is the raw corrected/bonus token and
    ``last_token`` the per-slot anchor for the next round (frozen for done
    rows)."""
    n_accepted: np.ndarray        # (B,) int32
    num_new: np.ndarray           # (B,) int32
    next_token: np.ndarray        # (B,) int32 raw corrected/bonus token
    last_token: np.ndarray        # (B,) int32 next-round anchor
    done: np.ndarray              # (B,) bool
    gamma: int
    n_active: int
    round_id: int = 0             # id of the window this verdict answers
    path: Any = None              # (B, d_max) int32 winning-path entries
                                  # (tree rounds — drives the draft's KV
                                  # relocation; None for linear rounds)

    @property
    def payload_bytes(self) -> int:
        return max(1, self.n_active) * verdict_payload_bytes(self.gamma)


# --------------------------------------------------------------------------
# Byte serialization (the socket transport's seam)
# --------------------------------------------------------------------------

# magic, round, γ, n_active, B, Γ|T, spec byte, n_nodes, branches
_WINDOW_HDR = struct.Struct("<4sqiiiiBii")
# magic, round, γ, n_active, B, path width (0 = linear verdict)
_VERDICT_HDR = struct.Struct("<4sqiiii")
_WINDOW_MAGIC = b"DSDW"
_VERDICT_MAGIC = b"DSDV"


def encode_window(msg: WindowMsg) -> bytes:
    """Serialize a window to bytes (token ids only — ``q_probs`` is the
    documented device pass-through and does not cross this seam). Tree
    windows append the (n_nodes,) int32 parent table after the tokens.

    A window carrying ``q_probs`` is REFUSED: those are the draft
    distributions the stochastic accept rule needs at temperature > 0,
    and silently dropping them here would make a byte-serializing
    transport decode wrong tokens downstream. Sampled decoding stays on
    device-passthrough transports until distribution shipping lands."""
    if msg.q_probs is not None:
        raise ValueError(
            "encode_window: window carries q_probs (temperature > 0 "
            "sampling); draft distributions do not cross the byte seam — "
            "use an in-process transport for sampled decoding")
    tokens = np.ascontiguousarray(msg.tokens, np.int32)
    B, G = tokens.shape
    head = _WINDOW_HDR.pack(_WINDOW_MAGIC, msg.round_id, msg.gamma,
                            msg.n_active, B, G, 1 if msg.speculative else 0,
                            msg.n_nodes, msg.branches)
    blob = head + tokens.tobytes()
    if msg.n_nodes:
        parent = np.ascontiguousarray(msg.parent, np.int32)
        assert parent.shape == (msg.n_nodes,), (parent.shape, msg.n_nodes)
        blob += parent.tobytes()
    return blob


def _check_magic(blob: bytes, magic: bytes, what: str) -> None:
    """Magic FIRST: a frame of the wrong type (or line noise) must fail
    on its first 4 bytes, before any header field is trusted."""
    if len(blob) < 4:
        raise ValueError(
            f"truncated {what}: {len(blob)} bytes, need at least 4 for the "
            f"magic at offset 0")
    if blob[:4] != magic:
        raise ValueError(
            f"bad {what} magic {bytes(blob[:4])!r} at offset 0 "
            f"(want {magic!r})")


def decode_window(blob: bytes) -> WindowMsg:
    """Inverse of :func:`encode_window`, hardened for bytes off a real
    socket: magic first, then header completeness, header plausibility,
    and an EXACT total-length check against the header-declared counts —
    a truncated or corrupted blob raises ``ValueError`` naming the
    offset instead of a cryptic ``struct.error`` / short ``frombuffer``."""
    _check_magic(blob, _WINDOW_MAGIC, "window")
    if len(blob) < _WINDOW_HDR.size:
        raise ValueError(
            f"truncated window header: {len(blob)} bytes, need "
            f"{_WINDOW_HDR.size} (truncation at offset {len(blob)})")
    (_magic, round_id, gamma, n_active, B, G, spec, n_nodes,
     branches) = _WINDOW_HDR.unpack_from(blob)
    if B < 1 or G < 1 or gamma < 0 or n_active < 0 or n_nodes < 0 \
            or branches < 1 or (n_nodes and n_nodes != G):
        raise ValueError(
            f"implausible window header (B={B}, G={G}, gamma={gamma}, "
            f"n_active={n_active}, n_nodes={n_nodes}, branches={branches})")
    off = _WINDOW_HDR.size
    expected = off + 4 * B * G + (4 * n_nodes if n_nodes else 0)
    if len(blob) != expected:
        raise ValueError(
            f"window length mismatch: header declares B={B}, G={G}, "
            f"n_nodes={n_nodes} → {expected} bytes, got {len(blob)} "
            f"(truncation/corruption at offset {min(len(blob), expected)})")
    tokens = np.frombuffer(blob, np.int32, count=B * G,
                           offset=off).reshape(B, G).copy()
    off += 4 * B * G
    parent = None
    if n_nodes:
        parent = np.frombuffer(blob, np.int32, count=n_nodes,
                               offset=off).copy()
    return WindowMsg(tokens=tokens, gamma=gamma, n_active=n_active,
                     round_id=round_id, speculative=bool(spec),
                     n_nodes=n_nodes, branches=branches, parent=parent)


def encode_verdict(msg: VerdictMsg) -> bytes:
    arrs = [np.ascontiguousarray(a, np.int32) for a in
            (msg.n_accepted, msg.num_new, msg.next_token, msg.last_token)]
    done = np.ascontiguousarray(msg.done, np.uint8)
    B = arrs[0].shape[0]
    path = (None if msg.path is None
            else np.ascontiguousarray(msg.path, np.int32))
    D = 0 if path is None else path.shape[1]
    head = _VERDICT_HDR.pack(_VERDICT_MAGIC, msg.round_id, msg.gamma,
                             msg.n_active, B, D)
    blob = head + b"".join(a.tobytes() for a in arrs) + done.tobytes()
    if path is not None:
        assert path.shape == (B, D), (path.shape, B, D)
        blob += path.tobytes()
    return blob


def decode_verdict(blob: bytes) -> VerdictMsg:
    """Inverse of :func:`encode_verdict`, hardened the same way as
    :func:`decode_window`: magic → header → plausibility → exact length,
    each failure a ``ValueError`` naming the offending offset."""
    _check_magic(blob, _VERDICT_MAGIC, "verdict")
    if len(blob) < _VERDICT_HDR.size:
        raise ValueError(
            f"truncated verdict header: {len(blob)} bytes, need "
            f"{_VERDICT_HDR.size} (truncation at offset {len(blob)})")
    (_magic, round_id, gamma, n_active, B, D) = _VERDICT_HDR.unpack_from(blob)
    if B < 1 or D < 0 or gamma < 0 or n_active < 0:
        raise ValueError(
            f"implausible verdict header (B={B}, D={D}, gamma={gamma}, "
            f"n_active={n_active})")
    expected = _VERDICT_HDR.size + 16 * B + B + 4 * B * D
    if len(blob) != expected:
        raise ValueError(
            f"verdict length mismatch: header declares B={B}, D={D} → "
            f"{expected} bytes, got {len(blob)} "
            f"(truncation/corruption at offset {min(len(blob), expected)})")
    off = _VERDICT_HDR.size
    arrs = []
    for _ in range(4):
        arrs.append(np.frombuffer(blob, np.int32, count=B, offset=off).copy())
        off += 4 * B
    done = np.frombuffer(blob, np.uint8, count=B, offset=off).astype(bool)
    off += B
    path = None
    if D:
        path = np.frombuffer(blob, np.int32, count=B * D,
                             offset=off).reshape(B, D).copy()
    return VerdictMsg(n_accepted=arrs[0], num_new=arrs[1], next_token=arrs[2],
                      last_token=arrs[3], done=done, gamma=gamma,
                      n_active=n_active, round_id=round_id, path=path)
