"""Repo-invariant static analysis and runtime sanitizers of the port (the
port of the reference's ``repro/analysis``, retargeted to the hazards of
PyTorch on the card).

The port's performance claims hang on invariants its design forces:

- captured steps are host-sync free: a CUDA graph replays device work
  only, so a step body that reads the device from the host (``.item()``,
  ``int()`` of a tensor, a Python ``if`` on one) breaks capture or
  stalls the eager path;
- a captured step's outputs live in static buffers that its next replay
  overwrites;
- byte-exact ``WindowMsg``/``VerdictMsg`` codecs across the process seam;
- every kernel wrapper routes devices one way: CPU → its plain version,
  CUDA → its kernel (counted), meta → the plain version's shapes, any
  other device → raise, never a fallback from the card;
- full-duplex post/recv/discard ordering in pipelined speculation.

Two layers enforce them:

- :mod:`repro_torch.analysis.lint` — an AST lint engine
  (``python -m repro_torch.analysis.lint src/repro_torch chip_smoke.py``)
  with ``DSD0xx`` rules (:mod:`.rules`);
- :mod:`repro_torch.analysis.sanitize` / :mod:`repro_torch.analysis.
  protocol` — runtime sanitizers: :func:`capture_guard` (counts CUDA
  graphs captured and steps built) and :class:`CheckedTransport`
  (validates the full-duplex protocol state machine per round id).

Imports here are lazy, so the lint CLI imports neither torch nor numpy.
"""

from __future__ import annotations

_SANITIZE = ("CaptureGuard", "RecaptureError", "capture_guard",
             "total_graphs_captured")
_PROTOCOL = ("CheckedTransport", "ProtocolViolation")

__all__ = list(_SANITIZE + _PROTOCOL)


def __getattr__(name: str):
    if name in _SANITIZE:
        from . import sanitize
        return getattr(sanitize, name)
    if name in _PROTOCOL:
        from . import protocol
        return getattr(protocol, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
