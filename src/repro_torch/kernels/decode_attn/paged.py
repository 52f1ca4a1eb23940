"""Wrapper of the hand-written CUDA paged decode-attention kernel (B2,
``csrc/paged_decode_attn.cu``), the port of the Pallas kernel
``repro/kernels/decode_attn/paged.py``: B1's arithmetic over a shared
block pool read through per-slot block tables, with optional int8 K/V
dequantized in the kernel.

The plain version is a position-ordered gather of each slot's blocks
(:func:`gather_layer_paged`, dequantized to f32) followed by B1's plain
version. CPU tensors run it; CUDA tensors launch the kernel or raise."""

from __future__ import annotations

from typing import Optional

import torch

from .. import (check_launch, count_launch, dtype_code, library,
                stream_ptr)
from .decode_attn import (check_aligned, check_attention_args, partials,
                          split_plan)
from .ref import decode_attention_grouped, decode_attention_split


def _gather_raw(k_pool, v_pool, k_scale, v_scale, pos_map, block_table,
                length: int):
    """One layer's logical view in the pool's own dtype: k/v (B, length,
    Hkv, hd), scales (B, length, Hkv) or None, pos (B, length). Unmapped
    positions read block 0 but surface pos −1."""
    bs = k_pool.shape[1]
    dev = block_table.device
    j = torch.arange(length, device=dev)
    phys = block_table[:, j // bs].long()                      # (B, length)
    flat = phys.clamp(min=0) * bs + (j % bs)[None, :]
    k_d = k_pool.reshape(-1, *k_pool.shape[2:])[flat]
    v_d = v_pool.reshape(-1, *v_pool.shape[2:])[flat]
    ks = vs = None
    if k_scale is not None:
        ks = k_scale.reshape(-1, k_scale.shape[-1])[flat]      # (B, len, Hkv)
        vs = v_scale.reshape(-1, v_scale.shape[-1])[flat]
    pm_d = torch.where(phys >= 0, pos_map.reshape(-1)[flat],
                       torch.full_like(phys, -1)).to(torch.int32)
    return k_d, v_d, ks, vs, pm_d


def gather_layer_paged(k_pool: torch.Tensor, v_pool: torch.Tensor,
                       k_scale: Optional[torch.Tensor],
                       v_scale: Optional[torch.Tensor],
                       pos_map: torch.Tensor, block_table: torch.Tensor,
                       length: int, out_dtype: torch.dtype):
    """Materialize ONE layer's logical dense view from the pool:
    k/v (B, length, Hkv, hd) in ``out_dtype`` plus pos (B, length).

    Unmapped positions read block 0 but surface pos −1 and are masked
    exactly like a dense empty slot."""
    k_d, v_d, ks, vs, pm_d = _gather_raw(k_pool, v_pool, k_scale, v_scale,
                                         pos_map, block_table, length)
    if ks is not None:
        k_d = (k_d.float() * ks[..., None]).to(out_dtype)
        v_d = (v_d.float() * vs[..., None]).to(out_dtype)
    else:
        k_d, v_d = k_d.to(out_dtype), v_d.to(out_dtype)
    return k_d, v_d, pm_d


def paged_decode_attention_plain(q, k_pool, v_pool, k_scale, v_scale,
                                 pos_map, block_table, q_pos, length: int,
                                 window: int = 0) -> torch.Tensor:
    k_d, v_d, pm_d = gather_layer_paged(k_pool, v_pool, k_scale, v_scale,
                                        pos_map, block_table, length,
                                        torch.float32)
    return decode_attention_grouped(q, k_d, v_d, pm_d, q_pos, window)


def paged_decode_attention_split(q, k_pool, v_pool, k_scale, v_scale,
                                 pos_map, block_table, q_pos, length: int,
                                 window: int = 0,
                                 split: Optional[int] = None
                                 ) -> torch.Tensor:
    """B2 computed the kernel's way (:func:`.ref.decode_attention_split`):
    the kernel's split plan unless ``split`` is given, int8 values with the
    K scale on the score and the V scale folded into P. For the tests and
    ``chip_smoke.py``."""
    bs, n_log = k_pool.shape[1], block_table.shape[1]
    n_keys = max(0, min(int(length), n_log * bs))
    if split is None:
        split, _ = split_plan(n_keys, q.shape[-1], k_pool.dtype,
                              k_pool.shape[2], bs)
    k_d, v_d, ks, vs, pm_d = _gather_raw(k_pool, v_pool, k_scale, v_scale,
                                         pos_map, block_table, n_keys)
    return decode_attention_split(q, k_d, v_d, pm_d, q_pos, split, window,
                                  ks, vs)


def paged_decode_attention(q: torch.Tensor,            # (B, T, Hkv, G, hd)
                           k_pool: torch.Tensor,       # (NB, bs, Hkv, hd)
                           v_pool: torch.Tensor,
                           k_scale: Optional[torch.Tensor],  # (NB, bs, Hkv)
                           v_scale: Optional[torch.Tensor],
                           pos_map: torch.Tensor,      # (NB, bs) int32
                           block_table: torch.Tensor,  # (B, n_log) int32
                           q_pos: torch.Tensor,        # (B, T) int32
                           length: int,
                           window: int = 0) -> torch.Tensor:
    """Paged GQA flash-decode over ONE layer's pool view. Returns the
    attention context (B, T, Hkv, G, hd) in ``q.dtype`` (the wo projection
    stays outside, in models/attention.py)."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, k_scale,
                                            v_scale, pos_map, block_table,
                                            q_pos, length, window)
    if q.device.type == "meta":     # the dry-run: shapes and FLOPs only
        return paged_decode_attention_plain(q, k_pool, v_pool, k_scale,
                                            v_scale, pos_map, block_table,
                                            q_pos, length, window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attn runs on cuda or cpu (meta: "
                         f"shapes only), not {q.device}")
    B, T, Hkv, G, hd = q.shape
    NB, bs = k_pool.shape[0], k_pool.shape[1]
    n_log = block_table.shape[1]
    quant = k_scale is not None
    tensors = {"k_pool": k_pool, "v_pool": v_pool, "pos_map": pos_map,
               "block_table": block_table}
    if quant:
        tensors.update(k_scale=k_scale, v_scale=v_scale)
    check_attention_args(q, q_pos, tensors)
    if tuple(k_pool.shape) != (NB, bs, Hkv, hd) or k_pool.shape != v_pool.shape:
        raise ValueError(f"pools must be (NB, bs, Hkv, hd) = "
                         f"{(NB, bs, Hkv, hd)}")
    if quant:
        if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
            raise TypeError("scaled pools must hold int8")
        for s in (k_scale, v_scale):
            if s.dtype != torch.float32 or tuple(s.shape) != (NB, bs, Hkv):
                raise ValueError("scales must be float32 (NB, bs, Hkv)")
    elif k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError("an unscaled pool must share q's dtype")
    if pos_map.dtype != torch.int32 or tuple(pos_map.shape) != (NB, bs):
        raise ValueError("pos_map must be int32 (NB, bs)")
    if block_table.dtype != torch.int32 or block_table.shape[0] != B:
        raise ValueError("block_table must be int32 (B, n_log)")
    check_aligned({"k_pool": k_pool, "v_pool": v_pool})
    n_keys = max(0, min(int(length), n_log * bs))
    split, n_split = split_plan(n_keys, hd, k_pool.dtype, Hkv, bs)
    part = partials(q, n_split)
    out = torch.empty_like(q)
    err = library().paged_decode_attn_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None,
        pos_map.data_ptr(), block_table.data_ptr(), q_pos.data_ptr(),
        out.data_ptr(), None if part is None else part.data_ptr(),
        B, T, Hkv, G, hd, bs, n_log, int(length), int(window), split,
        n_split, dtype_code(q.dtype), int(quant), stream_ptr(q))
    check_launch("paged_decode_attn", err)
    count_launch("paged_decode_attn")
    return out
