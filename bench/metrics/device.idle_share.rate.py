"""device.idle_share.rate: Share of the traced window in which no device
operation ran, %."""
from layers import idle_share as read  # noqa: F401
