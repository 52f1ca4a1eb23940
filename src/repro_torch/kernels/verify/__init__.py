"""Verify kernels of the port:

- sampled verify (B3a/B3b, ``csrc/sampled_verify.cu``), the port of the
  Pallas pair ``repro/kernels/verify/verify.py`` with its glue ``ops.py``;
- greedy tree verify (B4a/B4b, ``csrc/tree_verify.cu``), the port of
  ``repro/kernels/verify/tree.py``."""

from .ops import tree_verify_fused, verify_window_fused
from .ref import (VerifyOut, accept_rule, cdf_sample_plain,
                  gather_reduce_plain, tree_accept_plain, tree_argmax_plain,
                  verify_reference)
from .tree import MAX_ENTRIES, tree_accept, tree_argmax
from .verify import cdf_sample, gather_reduce
