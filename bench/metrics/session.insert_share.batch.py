"""session.insert_share.batch: Summed prefill-insert spans in the window
over the window, %."""
from layers import insert_share as read  # noqa: F401
