"""Glue of kernel B5, the port of the reference glue
``repro/kernels/ssd/ops.py``: the chunked scan with the device rule."""

from __future__ import annotations

from .ref import ssd_chunked_plain
from .ssd import ssd_call


def ssd_chunked_kernel(x, Bm, Cm, dt, A, h_in, chunk: int):
    """The reference's contract (``repro/kernels/ssd/ops.py:12``): padded
    dt rows are zero (identity steps), y comes back f32 (B, S, nh, hd) and
    h_out f32 (B, nh, hd, N). CPU tensors run :func:`ssd_chunked_plain`
    over ``chunk``-token chunks; CUDA tensors launch B5 (its own 64-token
    chunks: chunking changes only the float order) or raise."""
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if x.device.type == "cpu":
        return ssd_chunked_plain(x, Bm, Cm, dt, A, h_in, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunked_kernel runs on cuda or cpu, not "
                         f"{x.device}")
    return ssd_call(x, Bm, Cm, dt, A, h_in)
