"""session.round_ms.rate: Wall time of the window's chunks over their
rounds (each chunk ends in the session's sync)."""
from layers import round_ms as read  # noqa: F401
