"""Wrapper of the hand-written CUDA decode-attention kernel (B1,
``csrc/decode_attn.cu``), the port of the Pallas kernel
``repro/kernels/decode_attn/decode_attn.py``.

CPU tensors run the plain version (:mod:`.ref`); CUDA tensors launch the
kernel or raise."""

from __future__ import annotations

from typing import Optional

import torch

from .. import (check_launch, count_launch, dtype_code, library,
                stream_ptr)
from .ref import decode_attention_grouped

HEAD_DIMS = (64, 128)


def check_attention_args(q: torch.Tensor, q_pos: torch.Tensor,
                         tensors: dict) -> None:
    """Device, dtype, layout and head-dim checks shared by B1 and B2."""
    if q.dim() != 5:
        raise ValueError(f"q must be (B, T, Hkv, G, hd), got {tuple(q.shape)}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"kernel head_dim must be one of {HEAD_DIMS}, got "
                         f"{q.shape[-1]}")
    dtype_code(q.dtype)
    for name, t in {"q": q, "q_pos": q_pos, **tensors}.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q_pos.dtype != torch.int32 or tuple(q_pos.shape) != tuple(q.shape[:2]):
        raise ValueError("q_pos must be int32 (B, T)")


def decode_attn_call(q: torch.Tensor,        # (B, T, Hkv, G, hd)
                     k: torch.Tensor,        # (B, S, Hkv, hd)
                     v: torch.Tensor,
                     pos_map: torch.Tensor,  # (B, S) int32
                     q_pos: torch.Tensor,    # (B, T) int32
                     window: int = 0,
                     win_mask: Optional[torch.Tensor] = None,  # (T, Wn)
                     win_base: Optional[torch.Tensor] = None,  # (B,) int32
                     ) -> torch.Tensor:
    """GQA flash-decode over a dense cache → (B, T, Hkv, G, hd) in q.dtype.
    With a tree window, key slot ``win_base[b] + j`` (0 ≤ j < Wn) obeys the
    ancestor bitmap ``win_mask[t, j]`` instead of the position rule."""
    if (win_mask is None) != (win_base is None):
        raise ValueError("win_mask and win_base come together")
    if q.device.type == "cpu":
        return decode_attention_grouped(q, k, v, pos_map, q_pos, window,
                                        win_mask, win_base)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attn runs on cuda or cpu, not {q.device}")
    B, T, Hkv, G, hd = q.shape
    S = k.shape[1]
    tensors = {"k": k, "v": v, "pos_map": pos_map}
    if win_mask is not None:
        tensors.update(win_mask=win_mask, win_base=win_base)
    check_attention_args(q, q_pos, tensors)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("k and v must share q's dtype")
    if tuple(k.shape) != (B, S, Hkv, hd) or k.shape != v.shape:
        raise ValueError(f"k/v must be (B, S, Hkv, hd) = {(B, S, Hkv, hd)}")
    if pos_map.dtype != torch.int32 or tuple(pos_map.shape) != (B, S):
        raise ValueError("pos_map must be int32 (B, S)")
    Wn = 0
    if win_mask is not None:
        Wn = win_mask.shape[-1]
        if win_mask.dtype != torch.bool or tuple(win_mask.shape) != (T, Wn):
            raise ValueError(f"win_mask must be bool (T, Wn) with T = {T}")
        if win_base.dtype != torch.int32 or tuple(win_base.shape) != (B,):
            raise ValueError("win_base must be int32 (B,)")
    out = torch.empty_like(q)
    err = library().decode_attn_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos_map.data_ptr(),
        q_pos.data_ptr(),
        None if win_mask is None else win_mask.data_ptr(),
        None if win_base is None else win_base.data_ptr(),
        out.data_ptr(), B, T, Hkv, G, hd, S, int(window), Wn,
        dtype_code(q.dtype), stream_ptr(q))
    check_launch("decode_attn", err)
    count_launch("decode_attn")
    return out
