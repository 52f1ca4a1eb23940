"""Wrapper of the hand-written CUDA decode-attention kernel (B1,
``csrc/decode_attn.cu``), the port of the Pallas kernel
``repro/kernels/decode_attn/decode_attn.py``, and the split plan it shares
with B2.

The kernel splits the keys across blocks (flash-decoding): a split is a
fixed number of keys per cache layout (head dim, K/V dtype, kv heads), a
multiple of the pool's block size for B2, so split boundaries depend on
the key index alone and a row's output does not depend on the batch or
window it is computed in.
With more than one split the wrapper allocates the f32 partials (m, l,
acc) the kernel's combine pass reads.

CPU tensors run the plain version (:mod:`.ref`); CUDA tensors launch the
kernel or raise."""

from __future__ import annotations

from typing import Optional

import torch

from .. import (check_launch, count_launch, dtype_code, library,
                stream_ptr)
from .ref import decode_attention_grouped

HEAD_DIMS = (64, 128)

# keys per split by (head dim, K/V dtype): 64 KiB of K per split in bf16
# and f32; int8 pools split as bf16 does (csrc: at most 1024 keys). A cache
# with WIDE_KV or more kv heads splits twice as long: its grid already has
# Hkv blocks per split and batch row, and longer splits halve the partials
# the combine pass moves (measured on an H100, PERF.md).
SPLIT_KEYS = {(64, torch.bfloat16): 512, (128, torch.bfloat16): 256,
              (64, torch.int8): 512, (128, torch.int8): 256,
              (64, torch.float32): 256, (128, torch.float32): 128}
WIDE_KV = 8


def split_plan(n_keys: int, hd: int, kv_dtype: torch.dtype, n_kv: int,
               block_size: Optional[int] = None) -> tuple[int, int]:
    """(keys per split, number of splits) of a call over ``n_keys`` keys of
    a cache with ``n_kv`` kv heads. The split size depends only on the
    cache's layout (hd, K/V dtype, kv heads) — and, paged, is rounded up to
    a multiple of ``block_size`` — never on B, T or G, so split boundaries
    depend on the key index alone; a call over at most one split's keys has
    one split (no combine pass)."""
    split = min(1024, SPLIT_KEYS[(hd, kv_dtype)] * (2 if n_kv >= WIDE_KV
                                                    else 1))
    if block_size is not None:
        split = -(-split // block_size) * block_size
    return split, max(1, -(-n_keys // split))


def split_bounds(n_keys: int, split: int) -> list[tuple[int, int]]:
    """The [start, end) key ranges of the splits, in combine order."""
    return [(s, min(s + split, n_keys))
            for s in range(0, max(n_keys, 1), split)]


def partials(q: torch.Tensor, n_split: int) -> Optional[torch.Tensor]:
    """The kernels' f32 scratch for ``n_split`` splits (acc, m, l of every
    row), or None with one split. ``torch.empty``: every entry is written
    before it is read, and it allocates from the graph pool under capture."""
    if n_split == 1:
        return None
    rows = q.numel() // q.shape[-1]
    return torch.empty(n_split * rows * (q.shape[-1] + 2),
                       dtype=torch.float32, device=q.device)


def check_aligned(tensors: dict) -> None:
    """The kernels copy K/V rows with 16-byte ``cp.async``."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


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
    if q.device.type == "meta":     # the dry-run: shapes and FLOPs only
        return decode_attention_grouped(q, k, v, pos_map, q_pos, window,
                                        win_mask, win_base)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attn runs on cuda or cpu (meta: shapes "
                         f"only), not {q.device}")
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
    check_aligned({"k": k, "v": v})
    split, n_split = split_plan(S, hd, k.dtype, Hkv)
    part = partials(q, n_split)
    out = torch.empty_like(q)
    err = library().decode_attn_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos_map.data_ptr(),
        q_pos.data_ptr(),
        None if win_mask is None else win_mask.data_ptr(),
        None if win_base is None else win_base.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(),
        B, T, Hkv, G, hd, S, int(window), Wn, split, n_split,
        dtype_code(q.dtype), stream_ptr(q))
    check_launch("decode_attn", err)
    count_launch("decode_attn")
    return out
