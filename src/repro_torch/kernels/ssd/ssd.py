"""Wrapper of the hand-written CUDA SSD chunked-scan kernel (B5,
``csrc/ssd_scan.cu``), the port of the Pallas kernel
``repro/kernels/ssd/ssd.py`` (``_ssd_kernel`` via ``ssd_call``).

:func:`ssd_call` takes CUDA tensors only and launches the kernel; the
device rule lives in :func:`.ops.ssd_chunked_kernel`."""

from __future__ import annotations

import torch

from .. import check_launch, count_launch, dtype_code, library, stream_ptr

DIMS = (16, 32, 64, 128)        # head dims and state sizes the kernel takes


def ssd_call(x: torch.Tensor,      # (B, S, nh, hd) f32 / bf16
             Bm: torch.Tensor,     # (B, S, N), x's type
             Cm: torch.Tensor,     # (B, S, N), x's type
             dt: torch.Tensor,     # (B, S, nh) f32
             A: torch.Tensor,      # (nh,) f32
             h_in: torch.Tensor    # (B, nh, hd, N) f32
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch B5: (y (B, S, nh, hd) f32, h_out (B, nh, hd, N) f32). The
    kernel walks its own 32-token tiles and takes any S (no padding)."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd_call launches on cuda, not {x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, nh, hd), got {tuple(x.shape)}")
    B, S, nh, hd = x.shape
    N = Bm.shape[-1]
    if hd not in DIMS or N not in DIMS:
        raise ValueError(f"B5 takes head dim and state size in {DIMS}, got "
                         f"hd {hd}, N {N}")
    code = dtype_code(x.dtype)
    for name, t, dt_, shape in (
            ("Bm", Bm, x.dtype, (B, S, N)), ("Cm", Cm, x.dtype, (B, S, N)),
            ("dt", dt, torch.float32, (B, S, nh)),
            ("A", A, torch.float32, (nh,)),
            ("h_in", h_in, torch.float32, (B, nh, hd, N))):
        if t.dtype != dt_ or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dt_} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm), ("dt", dt), ("A", A),
                    ("h_in", h_in)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    y = torch.empty((B, S, nh, hd), dtype=torch.float32, device=x.device)
    h_out = torch.empty((B, nh, hd, N), dtype=torch.float32, device=x.device)
    err = library().ssd_scan_launch(
        x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dt.data_ptr(),
        A.data_ptr(), h_in.data_ptr(), y.data_ptr(), h_out.data_ptr(), B, S,
        nh, hd, N, code, stream_ptr(x))
    check_launch("ssd_scan", err)
    count_launch("ssd_scan")
    return y, h_out
