"""server.queue_ms_p50: Median wait from due time to the start of admission
over every request due in the window (still waiting at its end: the wait
so far)."""
from layers import queue_ms_p50 as read  # noqa: F401
