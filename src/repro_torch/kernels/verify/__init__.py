"""Greedy tree verify (kernels B4a/B4b, ``csrc/tree_verify.cu``), the port of
the Pallas pair ``repro/kernels/verify/tree.py`` with its glue ``ops.py``.
The sampled-verify pair (B3) comes with ROADMAP item A8."""

from .ops import tree_verify_fused
from .ref import accept_rule, tree_accept_plain, tree_argmax_plain
from .tree import MAX_ENTRIES, tree_accept, tree_argmax
