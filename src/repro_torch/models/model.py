"""Model assembler, dense family (the port's first slice).

The API mirrors the reference ``repro/models/model.py``::

    params = model.init_params(seed)
    logits, cache = model.prefill(params, tokens, slots=N)
    logits, cache = model.decode_step(params, token, cache, pos)   # T = 1
    logits, cache = model.verify_step(params, window, cache, pos)  # T = γ+1
    logits, cache = model.verify_step(params, tree_tokens, cache, pos,
                                      slot_off=..., pos_off=...,
                                      win_mask=...)               # a tree

Parameters are a nested dict of layer-stacked tensors with the reference's
names and layout (``layers.attn.wq`` is (L, D, H, hd), …), so
:mod:`repro_torch.bridge` carries reference weights across unchanged. The
layers run as a Python loop over the stacked axis; caches are updated in
place and returned for the reference's calling convention.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ModelConfig
from .attention import (attention_decode, attention_decode_paged,
                        init_attn_params)
from .kvcache import (AttnCache, PagedAttnCache, init_attn_cache,
                      init_paged_attn_cache)
from .layers import dense_init, dtype_of, rms_norm, rope_angles, swiglu

# families the port does not run yet, with the ROADMAP item that ports them
_LATER = {"moe": "A12", "vlm": "A12", "encdec": "A12", "ssm": "A11",
          "hybrid": "A11"}


def _check_family(cfg: ModelConfig) -> None:
    if cfg.arch_type != "dense":
        item = _LATER.get(cfg.arch_type, "A12")
        raise NotImplementedError(
            f"the PyTorch port runs the dense family only; "
            f"{cfg.arch_type!r} comes with ROADMAP item {item}")


def _layer(tree: dict, l: int) -> dict:
    return {k: (_layer(v, l) if isinstance(v, dict) else v[l])
            for k, v in tree.items()}


class Model:
    def __init__(self, cfg: ModelConfig, device):
        _check_family(cfg)
        self.cfg = cfg
        self.dtype = dtype_of(cfg.dtype)
        self.device = torch.device(device)

    # ------------------------------------------------------------------ init

    def init_params(self, seed: int = 0) -> dict:
        """Random weights drawn on ``self.device`` in the model dtype from a
        seeded ``torch.Generator`` (reference init scales; norms and biases
        zero). The draws differ from the reference's ``jax.random`` ones:
        parity tests carry reference weights over with the bridge."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))
        L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
        zeros = lambda *s: torch.zeros(s, dtype=dt, device=dev)
        params = {
            "embed": dense_init(gen, (cfg.vocab, d), dt, dev, fan_in=d),
            "final_norm": zeros(d),
            "layers": {
                "ln1": zeros(L, d),
                "ln2": zeros(L, d),
                "attn": init_attn_params(gen, cfg, dt, dev, L),
                "mlp": {
                    "w_gate": dense_init(gen, (L, d, f), dt, dev, fan_in=d),
                    "w_up": dense_init(gen, (L, d, f), dt, dev, fan_in=d),
                    "w_down": dense_init(gen, (L, f, d), dt, dev, fan_in=f),
                },
            },
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(gen, (d, cfg.vocab), dt, dev,
                                           fan_in=d)
        return params

    # ------------------------------------------------------------ primitives

    def _logits(self, params, h):
        cfg = self.cfg
        h = rms_norm(h, params["final_norm"], cfg.norm_eps)
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        return (h @ head).float()

    def _mlp(self, lp: dict, h: torch.Tensor) -> torch.Tensor:
        hn = rms_norm(h, lp["ln2"], self.cfg.norm_eps)
        m = lp["mlp"]
        return h + swiglu(hn, m["w_gate"], m["w_up"], m["w_down"])

    # ------------------------------------------------------------------ cache

    def init_cache(self, batch: int, slots: int,
                   ring: bool = False) -> AttnCache:
        cfg = self.cfg
        return init_attn_cache(cfg.n_layers, batch, slots, cfg.n_kv_heads,
                               cfg.head_dim, self.dtype, self.device, ring)

    def init_paged_cache(self, batch: int, length: int, n_blocks: int,
                         block_size: int, quantize: bool = False,
                         ring: bool = False) -> PagedAttnCache:
        cfg = self.cfg
        return init_paged_attn_cache(cfg.n_layers, batch, length, n_blocks,
                                     block_size, cfg.n_kv_heads,
                                     cfg.head_dim, self.dtype, self.device,
                                     quantize=quantize, ring=ring)

    # ------------------------------------------------------- decode / verify

    def decode_step(self, params, token: torch.Tensor, cache,
                    pos: torch.Tensor, window: int = 0):
        """token: (B,) int; pos: (B,) int32. Returns (logits (B, V), cache)."""
        logits, cache = self._window_step(params, token[:, None], cache, pos,
                                          window)
        return logits[:, -1, :], cache

    def verify_step(self, params, window_tokens: torch.Tensor, cache,
                    pos: torch.Tensor, window: int = 0,
                    slot_off: Optional[torch.Tensor] = None,
                    pos_off: Optional[torch.Tensor] = None,
                    win_mask: Optional[torch.Tensor] = None):
        """window_tokens: (B, T). Returns (logits (B, T, V), cache).
        ``slot_off``/``pos_off``/``win_mask`` — the tree-speculation window
        layout (dense caches only; see
        :func:`repro_torch.models.attention.attention_decode`)."""
        return self._window_step(params, window_tokens, cache, pos, window,
                                 slot_off, pos_off, win_mask)

    def _window_step(self, params, tokens: torch.Tensor, cache,
                     pos: torch.Tensor, window: int = 0,
                     slot_off: Optional[torch.Tensor] = None,
                     pos_off: Optional[torch.Tensor] = None,
                     win_mask: Optional[torch.Tensor] = None):
        cfg = self.cfg
        T = tokens.shape[1]
        h = params["embed"][tokens.long()]
        w = window or 0
        paged = isinstance(cache, PagedAttnCache)
        tree = (slot_off, pos_off, win_mask)
        if paged and any(a is not None for a in tree):
            raise NotImplementedError(
                "tree-speculation windows need a dense AttnCache")
        off = (torch.arange(T, device=pos.device, dtype=pos.dtype)
               if pos_off is None else pos_off)
        abs_pos = pos[:, None] + off[None, :]
        # one rope table per step, shared by every layer's q and k
        angles = rope_angles(abs_pos, cfg.head_dim, cfg.rope_theta)
        layers = params["layers"]
        for l in range(cfg.n_layers):
            lp = _layer(layers, l)
            x = rms_norm(h, lp["ln1"], cfg.norm_eps)
            if paged:
                a = attention_decode_paged(
                    x, lp["attn"], cfg, cache.k_buf[l], cache.v_buf[l],
                    None if cache.ks_buf is None else cache.ks_buf[l],
                    None if cache.vs_buf is None else cache.vs_buf[l],
                    cache.pm_buf[l], cache.block_table, pos, cache.ring,
                    cache.length, w, angles=angles)
            else:
                a = attention_decode(x, lp["attn"], cfg, cache.k_buf[l],
                                     cache.v_buf[l], cache.pm_buf[l], pos,
                                     cache.ring, w, angles, *tree)
            h = self._mlp(lp, h + a)
        return self._logits(params, h), cache

    # ----------------------------------------------------------------- prefill

    def prefill(self, params, tokens: torch.Tensor, slots: int,
                ring: bool = False, window: int = 0):
        """Process the whole (right-padded) prompt through ``verify_step``
        into a fresh cache of ``slots`` positions. Returns (logits
        (B, S, V), cache)."""
        B, S = tokens.shape
        if not ring and slots < S:
            # overflow writes are DROPPED, not clamped (models/kvcache.py):
            # refuse the geometry up front instead of silently losing the
            # prompt tail
            raise ValueError(
                f"prompt length {S} exceeds cache slots {slots}: size the "
                f"cache >= prompt + decode budget (or use a ring cache)")
        cache = self.init_cache(B, slots, ring=ring)
        pos0 = torch.zeros((B,), dtype=torch.int32, device=self.device)
        return self.verify_step(params, tokens, cache, pos0, window)


def build_model(cfg: ModelConfig, device) -> Model:
    return Model(cfg, device)
