"""The SSD chunked scan (B5, ``csrc/ssd_scan.cu``), the port of the Pallas
kernel ``repro/kernels/ssd``, and its gradient (``csrc/ssd_scan_bwd.cu``)."""

from .ops import SSDScanFn, ssd_chunked_kernel
from .ref import (KERNEL_CHUNK, ssd_chunked_bwd_plain, ssd_chunked_plain,
                  ssd_chunked_plain_bwd,
                  ssd_recurrent_reference, ssd_reverse_recurrence_bwd,
                  ssd_state_passing_plain)
from .ssd import ssd_bwd_call, ssd_bwd_states, ssd_call
