"""step.mfu.rate: Model FLOPs of the window's useful work over the window
at the bf16 peak, %: the target's gamma_r + 1 and the draft's gamma_r
tokens per active slot-round, and each admission's prompt at its own
length."""
from layers import step_mfu as read  # noqa: F401
