"""The port's wire, frames, transports and link model against the JAX
reference's (``repro/distributed``, ``repro/sim/network.py``), with no
model in the loop.

- The codecs write the reference's bytes for linear, tree and speculative
  windows and for linear and tree verdicts, and each package decodes the
  other's bytes; the hardened decode errors (bad magic, truncation, length
  mismatch, implausible header) and the refusal of a window that carries
  ``q_probs`` raise in the same cases with the same messages.
- ``send_frame``/``recv_frame`` across the packages over a real TCP socket
  pair, both ways, for window, verdict and control frames.
- The link model: ``sample_one_way_ms`` over seeded ``random.Random``
  streams, ``RttTracker``, ``expected_rtt_ms`` and the payload prices.
- The transports: protocol errors on empty streams, RTT paired by
  ``round_id`` out of order, and a seeded emulated link's delay log,
  bytes, messages and RTT equal to the reference transport's for one
  message sequence.

Equality is exact.
"""

import random
import socket
import struct

import numpy as np
import pytest
import torch

from repro.distributed import socket_transport as j_sock
from repro.distributed import transport as j_tr
from repro.distributed import wire as j_wire
from repro.sim import network as j_net
from repro_torch.distributed import socket_transport as t_sock
from repro_torch.distributed import transport as t_tr
from repro_torch.distributed import wire as t_wire
from repro_torch.sim import network as t_net


def _windows(wire):
    rng = np.random.default_rng(0)
    return {
        "linear": wire.WindowMsg(
            tokens=rng.integers(0, 151936, (4, 8)).astype(np.int32),
            gamma=5, n_active=3, round_id=17),
        "speculative": wire.WindowMsg(
            tokens=rng.integers(0, 128, (2, 3)).astype(np.int32), gamma=3,
            n_active=2, round_id=2 ** 40, speculative=True),
        "tree": wire.WindowMsg(
            tokens=rng.integers(0, 128, (3, 13)).astype(np.int32), gamma=4,
            n_active=3, round_id=5, n_nodes=13, branches=3,
            parent=np.array([0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9],
                            np.int32)),
    }


def _verdicts(wire):
    rng = np.random.default_rng(1)
    B = 3
    base = dict(n_accepted=rng.integers(0, 5, B).astype(np.int32),
                num_new=rng.integers(0, 6, B).astype(np.int32),
                next_token=rng.integers(0, 128, B).astype(np.int32),
                last_token=rng.integers(0, 128, B).astype(np.int32),
                done=np.array([True, False, True]), gamma=4, n_active=2,
                round_id=9)
    return {"linear": wire.VerdictMsg(**base),
            "tree": wire.VerdictMsg(**base, path=rng.integers(
                0, 13, (B, 4)).astype(np.int32))}


def _assert_same_msg(a, b):
    for f in a.__dataclass_fields__:
        va, vb = getattr(a, f), getattr(b, f)
        if isinstance(va, np.ndarray) or isinstance(vb, np.ndarray):
            np.testing.assert_array_equal(va, vb)
            assert np.asarray(va).dtype == np.asarray(vb).dtype, f
        else:
            assert va == vb, f


# ------------------------------------------------------------- codecs

@pytest.mark.parametrize("kind", ["linear", "speculative", "tree"])
def test_window_bytes_match_reference(kind):
    """Same message → same bytes; each package decodes the other's."""
    jm, tm = _windows(j_wire)[kind], _windows(t_wire)[kind]
    jb, tb = j_wire.encode_window(jm), t_wire.encode_window(tm)
    assert tb == jb
    _assert_same_msg(t_wire.decode_window(jb), j_wire.decode_window(tb))
    assert tm.payload_bytes == jm.payload_bytes


@pytest.mark.parametrize("kind", ["linear", "tree"])
def test_verdict_bytes_match_reference(kind):
    jm, tm = _verdicts(j_wire)[kind], _verdicts(t_wire)[kind]
    jb, tb = j_wire.encode_verdict(jm), t_wire.encode_verdict(tm)
    assert tb == jb
    _assert_same_msg(t_wire.decode_verdict(jb), j_wire.decode_verdict(tb))
    assert tm.payload_bytes == jm.payload_bytes


def _corruptions():
    w = j_wire.encode_window(_windows(j_wire)["tree"])
    v = j_wire.encode_verdict(_verdicts(j_wire)["tree"])
    hdr = struct.Struct("<4sqiiiiBii")
    bad_hdr = hdr.pack(b"DSDW", 1, 3, 1, 0, 4, 0, 0, 1) + b"\0" * 16
    return {
        "window_bad_magic": ("window", b"XXXX" + w[4:]),
        "window_short_magic": ("window", w[:3]),
        "window_truncated_header": ("window", w[:20]),
        "window_truncated_body": ("window", w[:-5]),
        "window_trailing_bytes": ("window", w + b"\0\0\0\0"),
        "window_implausible": ("window", bad_hdr),
        "verdict_for_window": ("window", v),
        "verdict_bad_magic": ("verdict", b"DSDX" + v[4:]),
        "verdict_truncated_header": ("verdict", v[:10]),
        "verdict_length_mismatch": ("verdict", v[:-1]),
        "verdict_implausible": ("verdict", struct.pack(
            "<4sqiiii", b"DSDV", 0, 1, 1, 0, 0)),
    }


@pytest.mark.parametrize("case", sorted(_corruptions()))
def test_decode_errors_match_reference(case):
    """Hardened decoding: the same corrupt blob raises ValueError in both
    packages, with the same message."""
    kind, blob = _corruptions()[case]
    errs = []
    for wire in (j_wire, t_wire):
        dec = wire.decode_window if kind == "window" else wire.decode_verdict
        with pytest.raises(ValueError) as exc:
            dec(blob)
        errs.append(str(exc.value))
    assert errs[0] == errs[1]


def test_q_probs_window_is_refused_like_reference():
    """A window carrying draft distributions does not cross the byte seam:
    both codecs raise, and the port's socket transport turns that into a
    protocol error instead of dropping them."""
    q = torch.zeros((1, 2, 128))
    for wire in (j_wire, t_wire):
        msg = wire.WindowMsg(tokens=np.zeros((1, 2), np.int32), gamma=2,
                             n_active=1, q_probs=q)
        with pytest.raises(ValueError, match="q_probs"):
            wire.encode_window(msg)
    tr = t_sock.SocketTransport.loopback(timeout_s=5.0)
    try:
        with pytest.raises(t_wire.TransportProtocolError, match="q_probs"):
            tr.post_window(t_wire.WindowMsg(
                tokens=np.zeros((1, 2), np.int32), gamma=2, n_active=1,
                q_probs=q))
    finally:
        tr.close()


# ------------------------------------------------------------- frames

@pytest.mark.parametrize("direction", ["port_to_reference",
                                       "reference_to_port"])
def test_frames_cross_packages(direction):
    """Window, verdict and control frames written by one package's
    ``send_frame`` are read by the other's ``recv_frame`` over a real TCP
    socket pair, and decode to the same messages."""
    send_mod, recv_mod = ((t_sock, j_sock) if direction == "port_to_reference"
                          else (j_sock, t_sock))
    send_wire = t_wire if send_mod is t_sock else j_wire
    recv_wire = j_wire if send_mod is t_sock else t_wire
    win = _windows(send_wire)["tree"]
    ver = _verdicts(send_wire)["tree"]
    frames = [(send_mod.FRAME_WINDOW, send_wire.encode_window(win)),
              (send_mod.FRAME_VERDICT, send_wire.encode_verdict(ver)),
              (send_mod.FRAME_CONTROL,
               send_mod.FRAME_ENCODERS[send_mod.FRAME_CONTROL](
                   {"cmd": "flush", "n": 8})),
              (send_mod.FRAME_CONTROL, b"")]
    tx, rx = t_sock._tcp_pair(5.0)
    try:
        for i, (kind, payload) in enumerate(frames):
            n = send_mod.send_frame(tx, kind, payload, ready_s=1.5 + i,
                                    delay_ms=0.25 * i)
            assert n == 25 + len(payload)
        for i, (kind, payload) in enumerate(frames):
            got = recv_mod.recv_frame(rx)
            assert got == (kind, payload, 1.5 + i, 0.25 * i)
    finally:
        tx.close()
        rx.close()
    _assert_same_msg(recv_wire.decode_window(frames[0][1]),
                     _windows(recv_wire)["tree"])
    _assert_same_msg(recv_wire.decode_verdict(frames[1][1]),
                     _verdicts(recv_wire)["tree"])
    assert recv_mod.FRAME_DECODERS[recv_mod.FRAME_CONTROL](frames[2][1]) \
        == {"cmd": "flush", "n": 8}


def test_frame_errors_raise_protocol_error():
    """Bad frame magic and an unknown kind are protocol errors, as in the
    reference."""
    tx, rx = t_sock._tcp_pair(5.0)
    try:
        tx.sendall(struct.pack("<4sBddI", b"NOPE", 1, 0.0, 0.0, 0))
        with pytest.raises(t_wire.TransportProtocolError, match="magic"):
            t_sock.recv_frame(rx)
        tx.sendall(struct.pack("<4sBddI", b"DSDF", 9, 0.0, 0.0, 0))
        with pytest.raises(t_wire.TransportProtocolError, match="kind"):
            t_sock.recv_frame(rx)
        with pytest.raises(t_wire.TransportProtocolError, match="kind"):
            t_sock.send_frame(tx, 9, b"")
    finally:
        tx.close()
        rx.close()


# --------------------------------------------------------- link model

@pytest.mark.parametrize("spec_kw", [
    dict(rtt_ms=20.0, jitter_ms=1.0, bandwidth_gbps=1.0),
    dict(rtt_ms=15.0, jitter_ms=1.0, bandwidth_gbps=0.01),
    dict(rtt_ms=2.0, jitter_ms=5.0, bandwidth_gbps=10.0)])
def test_link_model_matches_reference(spec_kw):
    """Seeded one-way delay streams, the RTT tracker, the analytic RTT and
    the payload prices equal the reference's."""
    js, ts = j_net.LinkSpec(**spec_kw), t_net.LinkSpec(**spec_kw)
    jr, tr = random.Random(7), random.Random(7)
    payloads = [64, 80, 320, 1000, 48 + 12 * 25]
    jd = [j_net.sample_one_way_ms(js, jr, p) for p in payloads * 20]
    td = [t_net.sample_one_way_ms(ts, tr, p) for p in payloads * 20]
    assert td == jd
    jt, tt = j_net.RttTracker(), t_net.RttTracker()
    assert tt.mean_recent_ms(3.5) == jt.mean_recent_ms(3.5)
    for i in range(0, 300, 2):
        jt.record_rtt(jd[i % len(jd)] + jd[(i + 1) % len(jd)])
        tt.record_rtt(td[i % len(td)] + td[(i + 1) % len(td)])
        assert tt.mean_recent_ms(0.0) == jt.mean_recent_ms(0.0)
    for out_b, back_b in ((64, 64), (320, 288), (10_000, 56)):
        assert t_net.expected_rtt_ms(ts, out_b, back_b) == \
            j_net.expected_rtt_ms(js, out_b, back_b)
    assert t_net.expected_one_way_ms(ts, 100) == \
        j_net.expected_one_way_ms(js, 100)
    for g in range(0, 13):
        assert t_net.window_payload_bytes(g) == j_net.window_payload_bytes(g)
        assert t_net.window_payload_bytes(g, n_nodes=1 + 3 * g) == \
            j_net.window_payload_bytes(g, n_nodes=1 + 3 * g)
        assert t_net.verdict_payload_bytes(g) == \
            j_net.verdict_payload_bytes(g)
    assert t_net.DEFAULT_FUSED_CHUNK == j_net.DEFAULT_FUSED_CHUNK


# ---------------------------------------------------------- transports

def _pair_msgs(wire, rid, gamma=4, n_active=1, speculative=False):
    w = wire.WindowMsg(tokens=np.zeros((n_active, gamma), np.int32),
                       gamma=gamma, n_active=n_active, round_id=rid,
                       speculative=speculative)
    v = wire.VerdictMsg(n_accepted=np.zeros(n_active, np.int32),
                        num_new=np.ones(n_active, np.int32),
                        next_token=np.zeros(n_active, np.int32),
                        last_token=np.zeros(n_active, np.int32),
                        done=np.zeros(n_active, bool), gamma=gamma,
                        n_active=n_active, round_id=rid)
    return w, v


@pytest.mark.parametrize("op", ["recv_window", "recv_verdict",
                                "discard_window"])
def test_empty_stream_is_a_protocol_error(op):
    """recv or discard with nothing in flight raises, in both packages."""
    for tr_mod, wire in ((j_tr, j_wire), (t_tr, t_wire)):
        tr = tr_mod.InProcessTransport()
        with pytest.raises(wire.TransportProtocolError, match="empty"):
            getattr(tr, op)()
        w, _ = _pair_msgs(wire, 0)
        tr.post_window(w)
        tr.recv_window()
        with pytest.raises(wire.TransportProtocolError, match="empty"):
            getattr(tr, op)()


def _drive(tr_mod, wire):
    """One message sequence: half-duplex rounds at two batch widths, a
    control round trip, then the reference's out-of-order pairing case (a
    speculative window posted before the previous verdict, a discarded
    window)."""
    tr = tr_mod.EmulatedLinkTransport(
        (j_net if tr_mod is j_tr else t_net).LinkSpec(
            rtt_ms=10.0, jitter_ms=0.5), seed=3, sleep=False)
    for rid, n_active in ((0, 4), (1, 3)):
        w, v = _pair_msgs(wire, rid, n_active=n_active)
        tr.send_window(w)
        tr.send_verdict(v)
    tr.control_roundtrip()
    w1, v1 = _pair_msgs(wire, 11)
    w2, v2 = _pair_msgs(wire, 12, speculative=True)
    tr.post_window(w1)
    tr.post_window(w2)
    tr.recv_window()
    tr.post_verdict(v1)
    tr.recv_verdict()
    tr.post_verdict(v2)
    tr.recv_window()
    tr.recv_verdict()
    w3, _ = _pair_msgs(wire, 13, speculative=True)
    tr.post_window(w3)
    dropped = tr.discard_window()
    w4, v4 = _pair_msgs(wire, 14)
    tr.post_window(w4)
    tr.recv_window()
    tr.post_verdict(v4)
    tr.recv_verdict()
    return tr, dropped


def test_emulated_link_matches_reference_out_of_order():
    """One message sequence through the reference's and the port's seeded
    emulated link (virtual clock): the same sampled delays per direction,
    bytes, messages, discards, and the RTT paired by round id (the
    speculative window's pair matched out of delivery order, the discarded
    window never paired)."""
    jt, jdrop = _drive(j_tr, j_wire)
    tt, tdrop = _drive(t_tr, t_wire)
    assert tt.delay_log == jt.delay_log
    assert (tt.bytes_sent, tt.messages_sent, tt.discarded_messages,
            tt.in_flight) == (jt.bytes_sent, jt.messages_sent,
                              jt.discarded_messages, jt.in_flight)
    assert tt.recent_rtt_ms == jt.recent_rtt_ms
    assert tdrop.round_id == jdrop.round_id == 13
    d = tt.delay_log
    pairs = [d["window"][0] + d["verdict"][0],
             d["window"][1] + d["verdict"][1],
             d["window"][2] + d["verdict"][2],       # the control trip
             d["window"][3] + d["verdict"][3],
             d["window"][4] + d["verdict"][4],
             d["window"][6] + d["verdict"][5]]       # window 5 discarded
    assert tt.recent_rtt_ms == pytest.approx(sum(pairs) / len(pairs))
    assert tt.describe() == jt.describe()


def test_make_transport_rule_matches_reference():
    for link in (None, (0.0, 1.0, 1.0), (15.0, 1.0, 1.0)):
        got = [mod.make_transport(None if link is None else net.LinkSpec(
                   *link), seed=1, sleep=False)
               for mod, net in ((j_tr, j_net), (t_tr, t_net))]
        if link is None:
            assert got == [None, None]
        else:
            assert got[1].describe() == got[0].describe()
            assert got[1].recent_rtt_ms == got[0].recent_rtt_ms


def test_socket_loopback_transport_roundtrip():
    """The port's loopback socket transport: a window and its verdict cross
    two real TCP streams as decoded copies, the framed bytes are counted
    apart from the paper's priced bytes, and the RTT pairs by round id."""
    tr = t_sock.SocketTransport.loopback(
        link=t_net.LinkSpec(rtt_ms=2.0, jitter_ms=0.1), seed=0,
        timeout_s=5.0)
    try:
        w, v = _pair_msgs(t_wire, 3, n_active=2)
        tr.post_window(w)
        got, waited = tr.recv_window()
        assert got is not w and waited >= 0.0
        _assert_same_msg(got, w)
        tr.post_verdict(v)
        gv, _ = tr.recv_verdict()
        _assert_same_msg(gv, v)
        assert tr.in_flight == 0
        assert tr.bytes_sent == w.payload_bytes + v.payload_bytes
        assert tr.wire_bytes == (2 * 25 + len(t_wire.encode_window(w))
                                 + len(t_wire.encode_verdict(v)))
        assert tr.recent_rtt_ms == pytest.approx(
            tr.delay_log["window"][0] + tr.delay_log["verdict"][0])
        tr.control_roundtrip()
        assert tr.messages_sent == 4
    finally:
        tr.close()
