"""Grouped-query attention for the decode/verify path: qk_norm (qwen3),
qkv bias (qwen2.5), sliding window, ring-buffer KV caches and
pos_map-masked decode (speculative rollback; see models/kvcache.py).

Functions are per-layer; model.py loops over the layer-stacked params. The
attention over the cache runs in the decode-attention kernels (B1 dense,
B2 paged); the projections stay ``torch.matmul``."""

from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelConfig
from ..kernels.decode_attn import decode_attn_call, paged_decode_attention
from .kvcache import paged_update_layer, update_layer_cache
from .layers import apply_rope, dense_init, rms_norm


def init_attn_params(gen: torch.Generator, cfg: ModelConfig, dtype,
                     device, n_layers: int) -> dict:
    """Layer-stacked (L, ...) attention weights, reference layout:
    wq (L, D, H, hd), wk/wv (L, D, Hkv, hd), wo (L, H, hd, D)."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    L = n_layers
    p = {
        "wq": dense_init(gen, (L, d, h, hd), dtype, device, fan_in=d),
        "wk": dense_init(gen, (L, d, kv, hd), dtype, device, fan_in=d),
        "wv": dense_init(gen, (L, d, kv, hd), dtype, device, fan_in=d),
        "wo": dense_init(gen, (L, h, hd, d), dtype, device, fan_in=h * hd),
    }
    zeros = lambda *s: torch.zeros((L, *s), dtype=dtype, device=device)
    if cfg.qkv_bias:
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
    return q


def _project_kv(x, p, cfg):
    k, v = _proj(x, p["wk"]), _proj(x, p["wv"])
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return k, v


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
