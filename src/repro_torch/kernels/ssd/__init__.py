"""The SSD chunked scan (B5, ``csrc/ssd_scan.cu``), the port of the Pallas
kernel ``repro/kernels/ssd``."""

from .ops import ssd_chunked_kernel
from .ref import (KERNEL_CHUNK, ssd_chunked_plain, ssd_recurrent_reference,
                  ssd_state_passing_plain)
from .ssd import ssd_call
