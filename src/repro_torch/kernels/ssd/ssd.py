"""Wrappers of the hand-written CUDA SSD chunked-scan kernel (B5,
``csrc/ssd_scan.cu``), the port of the Pallas kernel
``repro/kernels/ssd/ssd.py`` (``_ssd_kernel`` via ``ssd_call``), and of
its gradient (``csrc/ssd_scan_bwd.cu``, B5's chunks in reverse), which the
reference has no kernel for.

:func:`ssd_call` and :func:`ssd_bwd_call` launch their kernels on CUDA
tensors and refuse CPU ones (the CPU's plain scan is chosen above them, in
:func:`.ops.ssd_chunked_kernel`). Meta tensors (the dry-run) are a named
case: each runs its kernel's plain version over the kernel's 64-token
chunks (:func:`.ref.ssd_chunked_plain`, :func:`.ref.ssd_chunked_plain_bwd`,
what ``chip_smoke.py`` holds the kernels to), which gives the shapes and
the FLOPs and computes nothing."""

from __future__ import annotations

import torch

from .. import check_launch, count_launch, dtype_code, library, stream_ptr
from .ref import KERNEL_CHUNK, ssd_chunked_plain, ssd_chunked_plain_bwd

DIMS = (16, 32, 64, 128)        # head dims and state sizes the kernel takes
MIN_BLOCKS = 128                # blocks a call should fill (132 SMs)


def heads_per_block(B: int, n_chunks: int, nh: int) -> int:
    """Heads one block covers (it computes C·Bᵀ once for them, then runs
    them one after another). One for a call of one chunk: there a block's
    chain of dependent steps sets the time, and a second head in series
    costs more than the shared C·Bᵀ saves. Else the largest of 8, 4, 2
    dividing nh that still leaves ``MIN_BLOCKS`` blocks, else 1. The result
    does not depend on it: each head runs the same code on the same C·Bᵀ."""
    return 1 if n_chunks <= 1 else _head_group(B * n_chunks, nh)


def bwd_heads_per_block(B: int, n_chunks: int, nh: int) -> int:
    """Heads one block of ``ssd_scan_bwd`` covers: as
    :func:`heads_per_block`, for one chunk too: the backward's block is one
    per SM, so a one-chunk call of B·nh blocks fills the card in one wave
    with two heads a block where it took two waves with one."""
    return _head_group(B * max(n_chunks, 1), nh)


def _head_group(rows: int, nh: int) -> int:
    """The largest of 8, 4, 2 dividing nh that still leaves ``MIN_BLOCKS``
    blocks over ``rows`` (b, chunk) rows, else 1."""
    for hg in (8, 4, 2):
        if nh % hg == 0 and rows * nh // hg >= MIN_BLOCKS:
            return hg
    return 1


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """The kernel loads 16 bytes at a time: a view off a 16-byte boundary
    is copied."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_inputs(x, Bm, Cm, dt, A, h_in, **grads) -> None:
    """Type, shape, device and contiguity of the scan's inputs (x already
    4-d on the card) and of the gradients ``grads`` (dy, dh_out) the
    backward takes: raises ValueError."""
    B, S, nh, hd = x.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    want = {"x": (x, x.dtype, (B, S, nh, hd)),
            "Bm": (Bm, x.dtype, (B, S, N)), "Cm": (Cm, x.dtype, (B, S, N)),
            "dt": (dt, f32, (B, S, nh)), "A": (A, f32, (nh,)),
            "h_in": (h_in, f32, (B, nh, hd, N)),
            "dy": (grads.get("dy"), f32, (B, S, nh, hd)),
            "dh_out": (grads.get("dh_out"), f32, (B, nh, hd, N))}
    for name, (t, dtype, shape) in want.items():
        if t is None:
            continue
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


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
    if x.device.type == "meta":     # the dry-run: shapes and FLOPs only
        return ssd_chunked_plain(x, Bm, Cm, dt, A, h_in, KERNEL_CHUNK)
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
    _check_inputs(x, Bm, Cm, dt, A, h_in)
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


def ssd_bwd_states(x, Bm, Cm, dt, A, h_in, h_out=None):
    """B5's phases 1–2 alone for a scan of more than one chunk (the
    backward's phase 0, ``ssd_scan_states_launch``): (states (B, nch, nh,
    hd, N), decay (B, nch, nh)), each chunk's starting state and its decay
    exp(Σ A·dt), float32. ``h_out`` takes the last state (scratch here when
    None). Counts no launch: it is a part of ``ssd_scan_bwd``. Takes what
    :func:`ssd_call` takes, and raises ValueError as it does."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd_bwd_states launches on cuda, not {x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, nh, hd), got {tuple(x.shape)}")
    B, S, nh, hd = x.shape
    N = Bm.shape[-1]
    if hd not in DIMS or N not in DIMS:
        raise ValueError(f"B5 takes head dim and state size in {DIMS}, got "
                         f"hd {hd}, N {N}")
    _check_inputs(x, Bm, Cm, dt, A, h_in)
    if h_out is not None and (
            h_out.dtype != torch.float32 or h_out.device != x.device
            or tuple(h_out.shape) != (B, nh, hd, N)
            or not h_out.is_contiguous() or h_out.data_ptr() % 16):
        raise ValueError(f"h_out must be float32 {(B, nh, hd, N)}, "
                         "contiguous, 16-byte aligned, on x's device")
    x, Bm, Cm, h_in = map(_aligned, (x, Bm, Cm, h_in))
    # a phase of ssd_scan_bwd's launch, counted there, and reached only from
    # ssd_bwd_call's CUDA branch (its meta branch takes the plain backward
    # whole): no launch count or meta branch of its own
    lib = library()  # noqa: DSD004
    n_chunks = -(-S // lib.ssd_scan_chunk())
    if n_chunks < 2:
        raise ValueError(f"a scan of {S} tokens has one chunk or none: no "
                         "states to recompute")
    dev, f32 = x.device, torch.float32
    states = torch.empty((B, n_chunks, nh, hd, N), dtype=f32, device=dev)
    decay = torch.empty((B, n_chunks, nh), dtype=f32, device=dev)
    if h_out is None:
        h_out = torch.empty((B, nh, hd, N), dtype=f32, device=dev)
    err = lib.ssd_scan_states_launch(
        x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dt.data_ptr(),
        A.data_ptr(), h_in.data_ptr(), h_out.data_ptr(), states.data_ptr(),
        decay.data_ptr(), B, S, nh, hd, N, heads_per_block(B, n_chunks, nh),
        dtype_code(x.dtype), stream_ptr(x))
    check_launch("ssd_scan_bwd", err)
    return states, decay


def ssd_bwd_call(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                 dt: torch.Tensor, A: torch.Tensor, h_in: torch.Tensor,
                 dy: torch.Tensor, dh_out: torch.Tensor):
    """Launch ``ssd_scan_bwd``: the gradients of (y, h_out) = the scan of
    :func:`ssd_call` with respect to its six inputs, given dy (B, S, nh, hd)
    and dh_out (B, nh, hd, N) float32. Returns (dx, dBm, dCm in x's type;
    ddt (B, S, nh), dA (nh,), dh_in float32). Bm and Cm are shared across
    heads, so their gradients sum over heads; dA sums over batch and time.
    B5's chunks in reverse: for more than one chunk the chunks' starting
    states are recomputed first (:func:`ssd_bwd_states`), then the kernel
    forms dstates, passes over the chunks from the last, and takes each
    chunk's gradients on the tensor cores, summing head groups' partials in
    a fixed order; one chunk is one launch. Scratch is allocated here."""
    if x.device.type == "meta":     # the dry-run: shapes and FLOPs only
        return ssd_chunked_plain_bwd(x, Bm, Cm, dt, A, h_in, dy, dh_out,
                                     KERNEL_CHUNK)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_bwd_call launches on cuda, not {x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, S, nh, hd), got {tuple(x.shape)}")
    B, S, nh, hd = x.shape
    N = Bm.shape[-1]
    if hd not in DIMS or N not in DIMS:
        raise ValueError(f"ssd_scan_bwd takes head dim and state size in "
                         f"{DIMS}, got hd {hd}, N {N}")
    code = dtype_code(x.dtype)
    _check_inputs(x, Bm, Cm, dt, A, h_in, dy=dy, dh_out=dh_out)
    x, Bm, Cm, h_in, dy, dh_out = map(_aligned,
                                      (x, Bm, Cm, h_in, dy, dh_out))
    dev, f32 = x.device, torch.float32
    lib = library()
    n_chunks = -(-S // lib.ssd_scan_chunk())
    hg = lib.ssd_scan_bwd_heads(hd, N, code,
                                bwd_heads_per_block(B, n_chunks, nh))
    assert nh % hg == 0, (nh, hg)   # the head groups' partial rows

    def new(*shape, dtype=f32):
        return torch.empty(shape, dtype=dtype, device=dev)
    dx, dB, dC = new(B, S, nh, hd, dtype=x.dtype), \
        new(B, S, N, dtype=x.dtype), new(B, S, N, dtype=x.dtype)
    ddt, dA, dh_in = new(B, S, nh), new(nh), new(B, nh, hd, N)
    dBp, dCp = new(B, S, nh // hg, N), new(B, S, nh // hg, N)
    dAp = new(B, max(n_chunks, 1), nh)
    states = decay = gst = None
    if n_chunks > 1:    # dh_in is the scratch of the recompute's h_out
        states, decay = ssd_bwd_states(x, Bm, Cm, dt, A, h_in, h_out=dh_in)
        gst = new(B, n_chunks, nh, hd, N)
    err = lib.ssd_scan_bwd_launch(
        *(None if t is None else t.data_ptr()
          for t in (x, Bm, Cm, dt, A, h_in, dy, dh_out, dx, dB, dC, ddt, dA,
                    dh_in, states, decay, gst, dBp, dCp, dAp)),
        B, S, nh, hd, N, hg, code, stream_ptr(x))
    check_launch("ssd_scan_bwd", err)
    count_launch("ssd_scan_bwd")
    return dx, dB, dC, ddt, dA, dh_in
