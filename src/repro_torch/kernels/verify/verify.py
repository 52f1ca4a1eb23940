"""Wrappers of the hand-written CUDA sampled-verify kernels
(``csrc/sampled_verify.cu``), the port of the Pallas pair
``repro/kernels/verify/verify.py``:

- :func:`gather_reduce` (B3a) — p and q at each window position's draft
  token and the residual mass Σ_v max(p_i − q_i, 0);
- :func:`cdf_sample` (B3b) — the inverse CDF over one selected row per
  sequence (the corrected or bonus token).

CPU tensors run the plain versions (:mod:`.ref`); CUDA tensors launch the
kernel or raise. Both take float32 or bfloat16 probabilities and any V."""

from __future__ import annotations

import torch

from .. import check_launch, count_launch, dtype_code, library, stream_ptr
from .ref import cdf_sample_plain, gather_reduce_plain
from .tree import _same_device


def _check_probs(p: torch.Tensor, q: torch.Tensor, B: int, gamma: int):
    V = p.shape[-1]
    if gamma < 1:
        raise ValueError("the window needs at least one position")
    if tuple(p.shape) != (B, gamma + 1, V) or tuple(q.shape) != (B, gamma, V):
        raise ValueError(f"p must be (B, Γ+1, V) and q (B, Γ, V); got "
                         f"{tuple(p.shape)} and {tuple(q.shape)}")
    if p.dtype != q.dtype:
        raise ValueError(f"p and q must share a type, got {p.dtype} and "
                         f"{q.dtype}")
    return dtype_code(p.dtype)


def _device(t: torch.Tensor, name: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {t.device}")
    return t.device.type


def gather_reduce(tokens: torch.Tensor,   # (B, Γ) int32
                  p: torch.Tensor,        # (B, Γ+1, V) f32 or bf16
                  q: torch.Tensor):       # (B, Γ, V)
    """Pass A of the sampled verify → (p_at, q_at, mass), each (B, Γ)
    float32."""
    if _device(tokens, "gather_reduce") == "cpu":
        return gather_reduce_plain(tokens, p, q)
    B, gamma = tokens.shape
    code = _check_probs(p, q, B, gamma)
    if tokens.dtype != torch.int32:
        raise ValueError("tokens must be int32")
    _same_device(tokens, tokens=tokens, p=p, q=q)
    V = p.shape[-1]
    lib = library()
    splits = -(-V // lib.gather_reduce_chunk())
    dev = tokens.device
    partial = torch.empty((B * gamma, splits), dtype=torch.float32,
                          device=dev)
    out = torch.empty((3, B, gamma), dtype=torch.float32, device=dev)
    err = lib.gather_reduce_launch(
        tokens.data_ptr(), p.data_ptr(), q.data_ptr(), partial.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), B, gamma,
        V, splits, code, stream_ptr(tokens))
    check_launch("gather_reduce", err)
    count_launch("gather_reduce")
    return out[0], out[1], out[2]


def cdf_sample(jrow: torch.Tensor,     # (B,) int32 p row in [0, Γ]
               qrow: torch.Tensor,     # (B,) int32 q row in [0, Γ)
               use_p: torch.Tensor,    # (B,) int32, > 0: sample p itself
               p: torch.Tensor,        # (B, Γ+1, V) f32 or bf16
               q: torch.Tensor,        # (B, Γ, V)
               thresh: torch.Tensor    # (B,) float32
               ) -> torch.Tensor:
    """Pass B of the sampled verify → (B,) int32: the first v whose running
    sum of the selected distribution crosses ``thresh``; V − 1 when none
    does. The kernel sums fixed 4096-entry vocab splits over many blocks,
    then searches the split that holds the crossing
    (:func:`.ref.cdf_sample_split_plain` is that order in PyTorch)."""
    if _device(jrow, "cdf_sample") == "cpu":
        return cdf_sample_plain(jrow, qrow, use_p, p, q, thresh)
    B = jrow.shape[0]
    code = _check_probs(p, q, B, q.shape[1])
    for name, t, dt in (("jrow", jrow, torch.int32),
                        ("qrow", qrow, torch.int32),
                        ("use_p", use_p, torch.int32),
                        ("thresh", thresh, torch.float32)):
        if t.dtype != dt or tuple(t.shape) != (B,):
            raise ValueError(f"{name} must be {dt} (B,)")
    _same_device(jrow, jrow=jrow, qrow=qrow, use_p=use_p, p=p, q=q,
                 thresh=thresh)
    V = p.shape[-1]
    lib = library()
    splits = -(-V // lib.cdf_sample_split())
    totals = torch.empty((B, splits), dtype=torch.float64,
                         device=jrow.device)
    token = torch.empty((B,), dtype=torch.int32, device=jrow.device)
    err = lib.cdf_sample_launch(
        jrow.data_ptr(), qrow.data_ptr(), use_p.data_ptr(), p.data_ptr(),
        q.data_ptr(), thresh.data_ptr(), totals.data_ptr(), token.data_ptr(),
        B, q.shape[1], V, splits, code, stream_ptr(jrow))
    check_launch("cdf_sample", err)
    count_launch("cdf_sample")
    return token
