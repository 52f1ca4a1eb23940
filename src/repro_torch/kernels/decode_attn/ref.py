"""Plain PyTorch version of the decode-attention kernel (B1): pos_map-masked
GQA attention of a small query window over a (possibly ring-buffer) KV
cache, with optional sliding window.

It computes what the kernel computes: f32 scores scaled by 1/sqrt(hd),
softmax over the valid slots, P·V in f32 and one cast to q's dtype at the
end; a row with no valid slot is 0. (The reference ``_attend_cached``
rounds the softmax weights to the model dtype before P·V; the Pallas kernel
and this port keep them in f32. In float32 the two agree.)"""

from __future__ import annotations

import math
from typing import Optional

import torch


def decode_attention_reference(q: torch.Tensor,        # (B, T, H, hd)
                               k: torch.Tensor,        # (B, S, Hkv, hd)
                               v: torch.Tensor,        # (B, S, Hkv, hd)
                               pos_map: torch.Tensor,  # (B, S) int, -1=empty
                               q_pos: torch.Tensor,    # (B, T) absolute pos
                               window: int = 0) -> torch.Tensor:
    B, T, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, T, Hkv, H // Hkv, hd)
    return decode_attention_grouped(qg, k, v, pos_map, q_pos,
                                    window).reshape(B, T, H, hd)


def decode_attention_grouped(qg: torch.Tensor,   # (B, T, Hkv, G, hd)
                             k: torch.Tensor, v: torch.Tensor,
                             pos_map: torch.Tensor, q_pos: torch.Tensor,
                             window: int = 0,
                             win_mask: Optional[torch.Tensor] = None,
                             win_base: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """The plain version in the kernel's grouped layout. A tree window
    (``win_mask`` (T, Wn) bool, ``win_base`` (B,)) replaces the position
    rule of slots ``win_base[b] + j``, 0 ≤ j < Wn, by ``win_mask[t, j]``,
    as the reference's ``_attend_cached(win_mask=...)`` does."""
    hd = qg.shape[-1]
    scores = torch.einsum("btkgh,bskh->bkgts", qg.float(),
                          k.float()) / math.sqrt(hd)
    slot = pos_map[:, None, None, None, :]
    qp = q_pos[:, None, None, :, None]
    valid = (slot >= 0) & (slot <= qp)
    if window > 0:
        valid = valid & (slot > qp - window)
    if win_mask is not None:
        Wn = win_mask.shape[1]
        rel = (torch.arange(pos_map.shape[1], device=pos_map.device)[None, :]
               - win_base[:, None].long())                       # (B, S)
        in_region = (rel >= 0) & (rel < Wn)
        ov = win_mask[:, rel.clamp(0, Wn - 1)]                   # (T, B, S)
        valid = torch.where(in_region[:, None, None, None, :],
                            ov.transpose(0, 1)[:, None, None], valid)
    scores = scores.masked_fill(~valid, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    w = torch.nan_to_num(w, nan=0.0)       # rows with no valid slot → 0
    out = torch.einsum("bkgts,bskh->btkgh", w, v.float())
    return out.to(qg.dtype)
