"""Wrapper of the hand-written CUDA SSD chunked-scan kernel (B5,
``csrc/ssd_scan.cu``), the port of the Pallas kernel
``repro/kernels/ssd/ssd.py`` (``_ssd_kernel`` via ``ssd_call``).

:func:`ssd_call` takes CUDA tensors only and launches the kernel; the
device rule lives in :func:`.ops.ssd_chunked_kernel`."""

from __future__ import annotations

import torch

from .. import check_launch, count_launch, dtype_code, library, stream_ptr

DIMS = (16, 32, 64, 128)        # head dims and state sizes the kernel takes
MIN_BLOCKS = 128                # blocks a call should fill (132 SMs)


def heads_per_block(B: int, n_chunks: int, nh: int) -> int:
    """Heads one block covers (it computes C·Bᵀ once for them, then runs
    them one after another). One for a call of one chunk: there a block's
    chain of dependent steps sets the time, and a second head in series
    costs more than the shared C·Bᵀ saves. Else the largest of 8, 4, 2
    dividing nh that still leaves ``MIN_BLOCKS`` blocks, else 1. The result
    does not depend on it: each head runs the same code on the same C·Bᵀ."""
    if n_chunks <= 1:
        return 1
    for hg in (8, 4, 2):
        if nh % hg == 0 and B * max(n_chunks, 1) * nh // hg >= MIN_BLOCKS:
            return hg
    return 1


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """The kernel loads 16 bytes at a time: a view off a 16-byte boundary
    is copied."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ssd_call(x: torch.Tensor,      # (B, S, nh, hd) f32 / bf16
             Bm: torch.Tensor,     # (B, S, N), x's type
             Cm: torch.Tensor,     # (B, S, N), x's type
             dt: torch.Tensor,     # (B, S, nh) f32
             A: torch.Tensor,      # (nh,) f32
             h_in: torch.Tensor    # (B, nh, hd, N) f32
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch B5: (y (B, S, nh, hd) f32, h_out (B, nh, hd, N) f32). The
    kernel cuts S into its own 64-token chunks (no padding): one launch for
    S ≤ 64, else the chunk-state, state-passing and output kernels over
    scratch allocated here."""
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
    lib = library()
    n_chunks = -(-S // lib.ssd_scan_chunk())
    hg = heads_per_block(B, n_chunks, nh)
    x, Bm, Cm, h_in = map(_aligned, (x, Bm, Cm, h_in))
    dev = x.device
    y = torch.empty((B, S, nh, hd), dtype=torch.float32, device=dev)
    h_out = torch.empty((B, nh, hd, N), dtype=torch.float32, device=dev)
    states = decay = None
    if n_chunks > 1:    # chunk contributions, then their starting states
        states = torch.empty((B, n_chunks, nh, hd, N), dtype=torch.float32,
                             device=dev)
        decay = torch.empty((B, n_chunks, nh), dtype=torch.float32,
                            device=dev)
    err = lib.ssd_scan_launch(
        x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dt.data_ptr(),
        A.data_ptr(), h_in.data_ptr(), y.data_ptr(), h_out.data_ptr(),
        None if states is None else states.data_ptr(),
        None if decay is None else decay.data_ptr(), B, S, nh, hd, N, hg,
        code, stream_ptr(x))
    check_launch("ssd_scan", err)
    count_launch("ssd_scan")
    return y, h_out
