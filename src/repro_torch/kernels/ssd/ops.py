"""Glue of kernel B5, the port of the reference glue
``repro/kernels/ssd/ops.py``: the chunked scan with the device rule, and
its gradient on the card (:class:`SSDScanFn`)."""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from .ref import ssd_chunked_plain
from .ssd import ssd_bwd_call, ssd_call


class SSDScanFn(torch.autograd.Function):
    """B5 with its gradient: forward launches B5 (:func:`ssd_call`),
    backward launches ``ssd_scan_bwd`` (:func:`ssd_bwd_call`) on dy and
    dh_out. The saved tensors are the six inputs: the backward recomputes
    B5's chunk states from them (its phases 1–2, a small share of the
    backward) rather than keeping the forward's (a one-chunk launch computes
    none, and under ``cfg.remat`` the forward is re-run anyway), so a layer
    holds no scan state between its forward and backward."""

    @staticmethod
    def forward(ctx, x, Bm, Cm, dt, A, h_in):
        ctx.save_for_backward(x, Bm, Cm, dt, A, h_in)
        return ssd_call(x, Bm, Cm, dt, A, h_in)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, dh_out):
        return ssd_bwd_call(*ctx.saved_tensors, dy.float().contiguous(),
                            dh_out.float().contiguous())


def ssd_chunked_kernel(x, Bm, Cm, dt, A, h_in, chunk: int):
    """The reference's contract (``repro/kernels/ssd/ops.py:12``): padded
    dt rows are zero (identity steps), y comes back f32 (B, S, nh, hd) and
    h_out f32 (B, nh, hd, N). CPU tensors run :func:`ssd_chunked_plain`
    over ``chunk``-token chunks (autograd differentiates its einsums); CUDA
    tensors launch B5 (its own 64-token chunks: chunking changes only the
    float order) or raise, through :class:`SSDScanFn` when a gradient is
    being recorded, so the backward launches ``ssd_scan_bwd``. Meta tensors
    (the dry-run) take the CUDA path's structure, each wrapper running its
    kernel's plain twin for the shapes: a layer keeps what the card's keeps
    between its forward and backward (the six inputs)."""
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    if x.device.type == "cpu":
        return ssd_chunked_plain(x, Bm, Cm, dt, A, h_in, chunk)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssd_chunked_kernel runs on cuda or cpu (meta: "
                         f"shapes only), not {x.device}")
    args = (x, Bm, Cm, dt, A, h_in)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return SSDScanFn.apply(*args)
    return ssd_call(*args)
