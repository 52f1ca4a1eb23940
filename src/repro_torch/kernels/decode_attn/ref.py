"""Plain PyTorch versions of the decode-attention kernels (B1, B2):
pos_map-masked GQA attention of a small query window over a (possibly
ring-buffer) KV cache, with optional sliding window.

:func:`decode_attention_grouped` is what the wrappers run for CPU tensors:
f32 scores scaled by 1/sqrt(hd), softmax over the valid slots, P·V in f32
and one cast to q's dtype at the end; a row with no valid slot is 0.

:func:`decode_attention_split` computes the same function the way the CUDA
kernels do, for the tests and ``chip_smoke.py``: per split of the keys an
(m, l, acc) triple, the K scale on the score after the dot product and the
V scale folded into P, P rounded to q's dtype before P·V (as the reference
``_attend_cached`` rounds its softmax weights to the model dtype), then the
fixed-order combine. In float32 the rounding is the identity and the two
versions agree to float32 summation order."""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30   # the kernels' (and the Pallas kernels') masked score


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


def _validity(pos_map, q_pos, window, win_mask, win_base):
    """(B, 1, 1, T, S) bool: the position rule, replaced by the ancestor
    bitmap inside each row's tree region."""
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
    return valid


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
    # in place where the op allows: a (B, Hkv, G, T, S) score tensor and
    # its softmax are the most this holds at once
    scores = torch.einsum("btkgh,bskh->bkgts", qg.float(), k.float())
    scores.div_(math.sqrt(hd))
    valid = _validity(pos_map, q_pos, window, win_mask, win_base)
    scores.masked_fill_(~valid, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    del scores
    w.nan_to_num_(nan=0.0)                 # rows with no valid slot → 0
    out = torch.einsum("bkgts,bskh->btkgh", w, v.float())
    return out.to(qg.dtype)


def decode_attention_split(qg: torch.Tensor,    # (B, T, Hkv, G, hd)
                           k: torch.Tensor,     # (B, S, Hkv, hd)
                           v: torch.Tensor,
                           pos_map: torch.Tensor, q_pos: torch.Tensor,
                           split: int, window: int = 0,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           win_mask: Optional[torch.Tensor] = None,
                           win_base: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Split-and-combine version of :func:`decode_attention_grouped` over
    splits of ``split`` keys. With ``k_scale``/``v_scale`` (B, S, Hkv) the
    cache holds int8 values: s_j = (q·k_j)·ks_j / sqrt(hd) and P_j·vs_j
    enters P·V. Returns q's dtype."""
    B, T, Hkv, G, hd = qg.shape
    S = k.shape[1]
    valid = _validity(pos_map, q_pos, window, win_mask, win_base)
    qf = qg.float()
    ms, ls, accs = [], [], []
    for s0 in range(0, max(S, 1), split):
        s1 = min(s0 + split, S)
        sc = torch.einsum("btkgh,bskh->bkgts", qf, k[:, s0:s1].float())
        if k_scale is not None:
            sc = sc * k_scale[:, s0:s1].permute(0, 2, 1)[:, :, None, None]
        sc = sc / math.sqrt(hd)
        ok = valid[..., s0:s1].expand_as(sc)
        sc = torch.where(ok, sc, torch.full_like(sc, NEG_INF))
        m = sc.amax(-1, keepdim=True) if s1 > s0 else torch.full(
            (B, Hkv, G, T, 1), NEG_INF, device=qg.device)
        e = torch.where(ok, torch.exp(sc - m), torch.zeros_like(sc))
        p = e if v_scale is None else \
            e * v_scale[:, s0:s1].permute(0, 2, 1)[:, :, None, None]
        p = p.to(qg.dtype).float()
        ms.append(m[..., 0])
        ls.append(e.sum(-1))
        accs.append(torch.einsum("bkgts,bskh->bkgth", p,
                                 v[:, s0:s1].float()))
    m_all = torch.stack(ms)                        # (n_split, B, Hkv, G, T)
    mx = m_all.amax(0)
    den = torch.zeros_like(mx)
    acc = torch.zeros_like(accs[0])
    for m, l, a in zip(ms, ls, accs):             # fixed split order
        w = torch.exp(m - mx)
        den = den + w * l
        acc = acc + w[..., None] * a
    inv = torch.where(den > 0, 1.0 / den.clamp(min=1e-20),
                      torch.zeros_like(den))
    out = acc * inv[..., None]                     # (B, Hkv, G, T, hd)
    return out.permute(0, 3, 1, 2, 4).to(qg.dtype)
