"""Distributed draft–target execution on the port's models (paper Fig. 1b;
the port of the reference ``repro/distributed``).

The speculative-decoding step split at the network boundary: an edge-side
:class:`DraftWorker` proposes speculation windows, a cloud-side
:class:`TargetWorker` verifies and commits them, and a :class:`Transport`
carries the :class:`WindowMsg`/:class:`VerdictMsg` wire messages between
them — zero-delay in process (the exactness anchor), over an emulated
edge–cloud link whose measured delays feed the AWC window policy's
``rtt_recent_ms`` feature, or over framed TCP streams. The wire codecs
and frames are the reference's byte for byte. A ``DecodeSession`` given a
transport runs its rounds over it, half-duplex or pipelined
(``mode_policy="pipeline"``); :mod:`.host` runs each side of a pair in a
worker process of its own (``python -m repro_torch.distributed.host``).
"""

from .socket_transport import (FRAME_CONTROL, FRAME_VERDICT, FRAME_WINDOW,
                               SocketTransport, recv_frame, send_frame)
from .transport import (CONTROL_PAYLOAD_BYTES, EmulatedLinkTransport,
                        InProcessTransport, Transport, make_transport)
from .wire import (TransportProtocolError, VerdictMsg, WindowMsg,
                   decode_verdict, decode_window, encode_verdict,
                   encode_window)
from .workers import DraftWorker, TargetWorker

__all__ = [
    "CONTROL_PAYLOAD_BYTES", "EmulatedLinkTransport", "FRAME_CONTROL",
    "FRAME_VERDICT", "FRAME_WINDOW", "InProcessTransport", "SocketTransport",
    "Transport", "TransportProtocolError", "VerdictMsg", "WindowMsg",
    "DraftWorker", "TargetWorker", "decode_verdict", "decode_window",
    "encode_verdict", "encode_window", "make_transport", "recv_frame",
    "send_frame",
]
