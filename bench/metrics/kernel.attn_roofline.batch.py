"""kernel.attn_roofline.batch: B1/B2 (``attend_kernel`` and
``combine_kernel``) in the traced chunks: the least time their needed
bytes and FLOPs take at the peaks, over their device time, %."""
from layers import attn_roofline as read  # noqa: F401
