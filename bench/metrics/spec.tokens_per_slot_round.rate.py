"""spec.tokens_per_slot_round.rate: Tokens committed over active
slot-rounds in the window."""
from layers import tokens_per_slot_round as read  # noqa: F401
