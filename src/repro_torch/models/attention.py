"""Grouped-query attention for the decode/verify path: qk_norm (qwen3),
qkv bias (qwen2.5), sliding window, ring-buffer KV caches and
pos_map-masked decode (speculative rollback; see models/kvcache.py), the
whisper encoder's bidirectional and the decoder's cross-attention, and the
full-sequence causal attention of training (:func:`attention_train`).

Functions are per-layer; model.py loops over the layer-stacked params. The
attention over the cache runs in the decode-attention kernels (B1 dense,
B2 paged); the projections stay ``torch.matmul``. The encoder's and the
cross-attention's and training's softmax over a whole (T, S) score matrix
is plain PyTorch, as the reference computes it in plain jnp."""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..configs.base import ModelConfig
from ..kernels.decode_attn import decode_attn_call, paged_decode_attention
from .kvcache import paged_update_layer, update_layer_cache
from ..sharding.runtime import constrain_qkv
from .layers import apply_rope, dense_init, rms_norm


def init_attn_params(gen: torch.Generator, cfg: ModelConfig, dtype,
                     device, n_layers: int, cross: bool = False) -> dict:
    """Layer-stacked (L, ...) attention weights, reference layout:
    wq (L, D, H, hd), wk/wv (L, D, Hkv, hd), wo (L, H, hd, D).
    Cross-attention (``cross``) takes no qkv bias, as in the reference."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    L = n_layers
    p = {
        "wq": dense_init(gen, (L, d, h, hd), dtype, device, fan_in=d),
        "wk": dense_init(gen, (L, d, kv, hd), dtype, device, fan_in=d),
        "wv": dense_init(gen, (L, d, kv, hd), dtype, device, fan_in=d),
        "wo": dense_init(gen, (L, h, hd, d), dtype, device, fan_in=h * hd),
    }
    zeros = lambda *s: torch.zeros((L, *s), dtype=dtype, device=device)
    if cfg.qkv_bias and not cross:
        p["bq"], p["bk"], p["bv"] = zeros(h, hd), zeros(kv, hd), zeros(kv, hd)
    if cfg.qk_norm:
        p["q_norm"], p["k_norm"] = zeros(hd), zeros(hd)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, T, D) · (D, H, hd) → (B, T, H, hd)."""
    B, T, D = x.shape
    return (x @ w.reshape(D, -1)).view(B, T, *w.shape[1:])


def _project_q(x, p, cfg):
    q = _proj(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    return constrain_qkv(q)


def _project_kv(x, p, cfg):
    k, v = _proj(x, p["wk"]), _proj(x, p["wv"])
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return constrain_qkv(k), constrain_qkv(v)


def _qkv(x_new, p, cfg, abs_pos, angles):
    q = apply_rope(_project_q(x_new, p, cfg), abs_pos, cfg.rope_theta,
                   angles)
    k_new, v_new = _project_kv(x_new, p, cfg)
    k_new = apply_rope(k_new, abs_pos, cfg.rope_theta, angles)
    return q, k_new, v_new


def _out_proj(ctx: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """ctx (B, T, Hkv, G, hd) → (B, T, D) through wo (H, hd, D)."""
    B, T = ctx.shape[:2]
    return ctx.reshape(B, T, -1) @ wo.reshape(-1, wo.shape[-1])


def _repeat_kv(kv: torch.Tensor, H: int) -> torch.Tensor:
    """(B, S, Hkv, hd) → (B, S, H, hd), each kv head repeated for its
    group (``jnp.repeat`` on the head axis)."""
    Hkv = kv.shape[2]
    return kv if Hkv == H else kv.repeat_interleave(H // Hkv, dim=2)


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q (B, T, H, hd), k (B, S, Hkv, hd) → (B, H, T, S) in q's dtype."""
    k = _repeat_kv(k, q.shape[2])
    return torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(q.shape[-1])


def _gqa_out(weights: torch.Tensor, v: torch.Tensor,
             wo: torch.Tensor) -> torch.Tensor:
    """weights (B, H, T, S), v (B, S, Hkv, hd) → (B, T, D)."""
    v = _repeat_kv(v, weights.shape[1])
    ctx = torch.einsum("bhts,bshd->bthd", weights, v)
    return torch.einsum("bthk,hkd->btd", ctx, wo)


def _softmax_in(scores: torch.Tensor, dtype) -> torch.Tensor:
    """float32 softmax over the last axis, the weights cast to ``dtype``."""
    return torch.softmax(scores.float(), dim=-1).to(dtype)


def attention_bidir(x: torch.Tensor, p: dict, cfg: ModelConfig
                    ) -> torch.Tensor:
    """Bidirectional self-attention over a whole (B, T, D) sequence (the
    whisper encoder): RoPE over the frame index on q and k, as the
    reference applies it."""
    T = x.shape[1]
    positions = torch.arange(T, device=x.device, dtype=torch.int32)[None]
    q = apply_rope(_project_q(x, p, cfg), positions, cfg.rope_theta)
    k, v = _project_kv(x, p, cfg)
    k = apply_rope(k, positions, cfg.rope_theta)
    return _gqa_out(_softmax_in(_gqa_scores(q, k), x.dtype), v, p["wo"])


def attention_train(x: torch.Tensor, p: dict, cfg: ModelConfig,
                    window: Optional[int] = None, prefix_len: int = 0,
                    q_chunk: int = 1024) -> torch.Tensor:
    """Full-sequence causal GQA self-attention of training (the reference's
    ``attention_train``): RoPE over positions 0..T−1 on q and k, a sliding
    window (``window``, else ``cfg.sliding_window``; 0 is full), and a
    bidirectional prefix of ``prefix_len`` tokens (the vlm's image tokens
    attend freely within it).
    A sequence longer than ``q_chunk`` and a multiple of it runs its
    queries in chunks of ``q_chunk`` against the whole masked K, so the
    (T, T) score matrix never exists at once. Scores in the model dtype,
    softmax in float32, weights cast back. x (B, T, D) → (B, T, D)."""
    T = x.shape[1]
    positions = torch.arange(T, device=x.device, dtype=torch.int32)[None]
    q = apply_rope(_project_q(x, p, cfg), positions, cfg.rope_theta)
    k, v = _project_kv(x, p, cfg)
    k = apply_rope(k, positions, cfg.rope_theta)
    w = window if window is not None else cfg.sliding_window
    k_pos = torch.arange(T, device=x.device)[None, :]

    def masked_attend(q_blk: torch.Tensor, offset: int) -> torch.Tensor:
        q_pos = torch.arange(q_blk.shape[1], device=x.device)[:, None] \
            + offset
        mask = k_pos <= q_pos
        if w > 0:
            mask = mask & (k_pos > q_pos - w)
        if prefix_len > 0:
            mask = mask | ((q_pos < prefix_len) & (k_pos < prefix_len))
        scores = torch.where(mask[None, None],
                             _gqa_scores(q_blk, k).float(),
                             torch.tensor(float("-inf"), device=x.device))
        return _gqa_out(_softmax_in(scores, x.dtype), v, p["wo"])

    if T <= q_chunk or T % q_chunk != 0:
        return masked_attend(q, 0)
    return torch.cat([masked_attend(q[:, c:c + q_chunk], c)
                      for c in range(0, T, q_chunk)], dim=1)


def attention_cross(x: torch.Tensor, p: dict, cfg: ModelConfig,
                    enc_k: torch.Tensor, enc_v: torch.Tensor
                    ) -> torch.Tensor:
    """Cross-attention of the (B, T, D) decoder window over precomputed
    encoder K/V (B, F, Hkv, hd): no RoPE on the query."""
    q = _project_q(x, p, cfg)
    return _gqa_out(_softmax_in(_gqa_scores(q, enc_k), x.dtype), enc_v,
                    p["wo"])


def cross_kv(p: dict, cfg: ModelConfig, enc_out: torch.Tensor):
    """The encoder output's K/V for one decoder layer, computed once per
    request at prefill (no RoPE)."""
    return _project_kv(enc_out, p, cfg)


def attention_decode(x_new: torch.Tensor, p: dict, cfg: ModelConfig,
                     k_buf: torch.Tensor, v_buf: torch.Tensor,
                     pm_buf: torch.Tensor, pos: torch.Tensor, ring: bool,
                     window: int = 0,
                     angles: Optional[tuple] = None,
                     slot_off: Optional[torch.Tensor] = None,
                     pos_off: Optional[torch.Tensor] = None,
                     win_mask: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Decode/verify step over a dense layer cache: write the (B, T)
    window into the cache (in place; buffers carry the sink row B) and
    attend over the valid slots through kernel B1.

    x_new: (B, T, D); pos: (B,) absolute position of x_new[:, 0].
    Validity per slot s for query t: 0 ≤ pos_map[s] ≤ pos+t, and
    pos_map[s] > pos+t − window when sliding. Stale speculative entries
    (pos_map beyond the committed position) are excluded automatically.

    Tree speculation (``slot_off``/``pos_off``/``win_mask``): token t
    writes slot ``pos + slot_off[t]`` at position ``pos + pos_off[t]``
    (RoPE phase and pos_map value), and inside the region ``[pos, pos +
    win_mask.shape[1])`` the validity of slot ``pos + j`` for query t is
    ``win_mask[t, j]`` instead of the position rule (siblings tie on
    position; the ancestor bitmap separates them).
    Returns the attention output (B, T, D)."""
    B, T, _ = x_new.shape
    off = (torch.arange(T, device=pos.device, dtype=pos.dtype)
           if pos_off is None else pos_off)
    abs_pos = pos[:, None] + off[None, :]
    q, k_new, v_new = _qkv(x_new, p, cfg, abs_pos, angles)
    update_layer_cache(k_buf, v_buf, pm_buf, k_new, v_new, pos, ring,
                       slot_off=slot_off, pos_off=pos_off)
    Hkv, hd = k_buf.shape[2], k_buf.shape[3]
    qg = q.reshape(B, T, Hkv, -1, hd)
    ctx = decode_attn_call(qg, k_buf[:B], v_buf[:B], pm_buf[:B],
                           abs_pos.to(torch.int32), window,
                           win_mask=win_mask,
                           win_base=None if win_mask is None
                           else pos.to(torch.int32))
    return _out_proj(ctx, p["wo"])


def attention_decode_paged(x_new: torch.Tensor, p: dict, cfg: ModelConfig,
                           k_pool, v_pool, k_scale, v_scale,
                           pos_map: torch.Tensor,
                           block_table: torch.Tensor, pos: torch.Tensor,
                           ring: bool, length: int, window: int = 0,
                           angles: Optional[tuple] = None) -> torch.Tensor:
    """Paged decode/verify step: write the (B, T) window into the block pool
    through the slot block tables (in place; pools carry the sink block),
    then attend over each slot's mapped blocks through kernel B2. Single-
    layer pool views; ``block_table`` (B, n_log) is shared across layers
    and not updated here. Same masking as :func:`attention_decode`."""
    B, T, _ = x_new.shape
    abs_pos = pos[:, None] + torch.arange(T, device=pos.device,
                                          dtype=pos.dtype)[None, :]
    q, k_new, v_new = _qkv(x_new, p, cfg, abs_pos, angles)
    paged_update_layer(k_pool, v_pool, k_scale, v_scale, pos_map,
                       block_table, k_new, v_new, pos, ring, length)
    Hkv, hd = k_pool.shape[2], k_pool.shape[3]
    qg = q.reshape(B, T, Hkv, -1, hd)
    ctx = paged_decode_attention(qg, k_pool, v_pool, k_scale, v_scale,
                                 pos_map, block_table,
                                 abs_pos.to(torch.int32), length, window)
    return _out_proj(ctx.to(x_new.dtype), p["wo"])
