"""Layout wrapper: (B, T, H, hd) queries ↔ the kernel's grouped
(B, T, Hkv, G, hd) layout. The CUDA kernel walks any S, so unlike the
Pallas wrapper no cache padding to a sequence tile is needed."""

from __future__ import annotations

import torch

from .decode_attn import decode_attn_call


def decode_attention(q: torch.Tensor,        # (B, T, H, hd)
                     k: torch.Tensor,        # (B, S, Hkv, hd)
                     v: torch.Tensor,
                     pos_map: torch.Tensor,  # (B, S) int32
                     q_pos: torch.Tensor,    # (B, T) int32
                     window: int = 0) -> torch.Tensor:
    B, T, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, T, Hkv, H // Hkv, hd)
    out = decode_attn_call(qg, k, v, pos_map, q_pos, window=window)
    return out.reshape(B, T, H, hd)
