"""Model assembler: the dense, ssm (Mamba2) and hybrid (Zamba2: a Mamba2
backbone with one shared attention block called every ``attn_every``
layers) families.

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
layers run as a Python loop over the stacked axis. Attention caches are
updated in place and returned for the reference's calling convention;
recurrent (SSM) state comes back as a new cache and the one passed in is
left as it was (``models/ssm.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import PAGED_FAMILIES, ModelConfig
from .attention import (attention_decode, attention_decode_paged,
                        init_attn_params)
from .kvcache import (HybridCacheT, PagedAttnCache, SSMCache,
                      init_attn_cache, init_paged_attn_cache, init_ssm_cache)
from .layers import dense_init, dtype_of, rms_norm, rope_angles, swiglu
from .ssm import (SSDState, conv_dim, init_ssm_params, ssm_block_decode,
                  ssm_block_train)

FAMILIES = ("dense", "ssm", "hybrid")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.arch_type not in FAMILIES:
        raise NotImplementedError(
            f"the PyTorch port runs the {', '.join(FAMILIES)} families; "
            f"{cfg.arch_type!r} comes with ROADMAP item A12")


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

        def attn_block(n):        # norms, attention and SwiGLU MLP, (n, ...)
            return {"ln1": zeros(n, d), "ln2": zeros(n, d),
                    "attn": init_attn_params(gen, cfg, dt, dev, n),
                    "mlp": {
                        "w_gate": dense_init(gen, (n, d, f), dt, dev,
                                             fan_in=d),
                        "w_up": dense_init(gen, (n, d, f), dt, dev,
                                           fan_in=d),
                        "w_down": dense_init(gen, (n, f, d), dt, dev,
                                             fan_in=f)}}

        params = {
            "embed": dense_init(gen, (cfg.vocab, d), dt, dev, fan_in=d),
            "final_norm": zeros(d),
            "layers": (attn_block(L) if cfg.arch_type == "dense" else
                       {"ln1": zeros(L, d),
                        "ssm": init_ssm_params(gen, cfg, dt, dev, L)}),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(gen, (d, cfg.vocab), dt, dev,
                                           fan_in=d)
        if cfg.arch_type == "hybrid":
            # ONE shared block, unstacked (reference layout)
            params["shared_attn"] = _layer(attn_block(1), 0)
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

    def _hybrid_segments(self) -> tuple[int, int, int]:
        """(layers per segment, segments, trailing Mamba2 layers): the shared
        block runs after each segment."""
        cfg = self.cfg
        every = cfg.attn_every or cfg.n_layers
        n_seg = cfg.n_layers // every
        return every, n_seg, cfg.n_layers - n_seg * every

    def init_cache(self, batch: int, slots: int, ring: bool = False):
        """Dense: an :class:`AttnCache` of ``slots`` positions; ssm: an
        :class:`SSMCache` (no positions); hybrid: both, the attention cache
        with one layer per shared-block call."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        if cfg.arch_type == "dense":
            return init_attn_cache(cfg.n_layers, batch, slots,
                                   cfg.n_kv_heads, cfg.head_dim, dt, dev,
                                   ring)
        ssm = init_ssm_cache(cfg.n_layers, batch, cfg.ssm_conv,
                             conv_dim(cfg), cfg.ssm_heads, cfg.ssm_head_dim,
                             cfg.ssm_state, dt, dev)
        if cfg.arch_type == "ssm":
            return ssm
        _, n_seg, _ = self._hybrid_segments()
        return HybridCacheT(ssm=ssm, shared_attn=init_attn_cache(
            max(1, n_seg), batch, slots, cfg.n_kv_heads, cfg.head_dim, dt,
            dev, ring))

    def init_paged_cache(self, batch: int, length: int, n_blocks: int,
                         block_size: int, quantize: bool = False,
                         ring: bool = False) -> PagedAttnCache:
        """Paged serving cache, pageable (attention) families only:
        recurrent state has no positions to page (the reference's rule)."""
        cfg = self.cfg
        if not cfg.pageable:
            raise ValueError(f"paged KV supports the {PAGED_FAMILIES} "
                             f"families, not {cfg.arch_type!r}")
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
                    seq_lens: Optional[torch.Tensor] = None,
                    slot_off: Optional[torch.Tensor] = None,
                    pos_off: Optional[torch.Tensor] = None,
                    win_mask: Optional[torch.Tensor] = None):
        """window_tokens: (B, T). Returns (logits (B, T, V), cache).
        ``seq_lens`` — right-padded batches (prefill): the valid length per
        sequence, for exact identity-masking of recurrent state.
        ``slot_off``/``pos_off``/``win_mask`` — the tree-speculation window
        layout (dense caches only; see
        :func:`repro_torch.models.attention.attention_decode`)."""
        return self._window_step(params, window_tokens, cache, pos, window,
                                 seq_lens, slot_off, pos_off, win_mask)

    def _window_step(self, params, tokens: torch.Tensor, cache,
                     pos: torch.Tensor, window: int = 0,
                     seq_lens: Optional[torch.Tensor] = None,
                     slot_off: Optional[torch.Tensor] = None,
                     pos_off: Optional[torch.Tensor] = None,
                     win_mask: Optional[torch.Tensor] = None):
        cfg = self.cfg
        T = tokens.shape[1]
        h = params["embed"][tokens.long()]
        w = window or 0
        paged = isinstance(cache, PagedAttnCache)
        tree = (slot_off, pos_off, win_mask)
        if any(a is not None for a in tree) and (
                paged or cfg.arch_type != "dense"):
            raise NotImplementedError(
                "tree-speculation windows need a dense AttnCache")
        if cfg.arch_type == "ssm":
            return self._ssm_window(params, h, cache, T, seq_lens)
        if cfg.arch_type == "hybrid":
            return self._hybrid_window(params, h, cache, pos, T, w,
                                       seq_lens)
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

    def _mamba(self, lp: dict, h: torch.Tensor, conv: torch.Tensor,
               state: torch.Tensor, T: int,
               seq_lens: Optional[torch.Tensor]):
        """One residual Mamba2 layer from the given state (left intact):
        the single-token step at T = 1, the chunked scan (B5) above it.
        Returns (h, new conv tail, new SSD state)."""
        cfg = self.cfg
        x = rms_norm(h, lp["ln1"], cfg.norm_eps)
        st = SSDState(h=state, conv_tail=conv)
        if T == 1:
            y, st = ssm_block_decode(x, lp["ssm"], cfg, st)
        else:
            y, st = ssm_block_train(x, lp["ssm"], cfg, state=st,
                                    seq_lens=seq_lens)
        return h + y, st.conv_tail, st.h

    def _ssm_window(self, params, h, cache: SSMCache, T: int,
                    seq_lens: Optional[torch.Tensor] = None):
        convs, states = [], []
        for l in range(self.cfg.n_layers):
            h, conv, state = self._mamba(_layer(params["layers"], l), h,
                                         cache.conv[l], cache.state[l], T,
                                         seq_lens)
            convs.append(conv)
            states.append(state)
        return self._logits(params, h), SSMCache(conv=torch.stack(convs),
                                                 state=torch.stack(states))

    def _hybrid_window(self, params, h, cache: HybridCacheT,
                       pos: torch.Tensor, T: int, w: int,
                       seq_lens: Optional[torch.Tensor] = None):
        """Segments of ``attn_every`` Mamba2 layers, each followed by the
        shared attention block (its own cache layer per call), then the
        trailing Mamba2 layers. The shared block's KV is written in place
        as in the dense path: window writes land past the committed prefix,
        pos_map masks them, and the next window rewrites them before any
        query can attend them. The recurrent state comes back new."""
        cfg = self.cfg
        every, n_seg, _ = self._hybrid_segments()
        sa, sp = cache.shared_attn, params["shared_attn"]
        abs_pos = pos[:, None] + torch.arange(T, device=pos.device,
                                              dtype=pos.dtype)[None, :]
        angles = rope_angles(abs_pos, cfg.head_dim, cfg.rope_theta)
        convs, states = [], []
        for l in range(cfg.n_layers):
            h, conv, state = self._mamba(_layer(params["layers"], l), h,
                                         cache.ssm.conv[l],
                                         cache.ssm.state[l], T, seq_lens)
            convs.append(conv)
            states.append(state)
            s = l // every
            if (l + 1) % every == 0 and s < n_seg:
                x = rms_norm(h, sp["ln1"], cfg.norm_eps)
                a = attention_decode(x, sp["attn"], cfg, sa.k_buf[s],
                                     sa.v_buf[s], sa.pm_buf[s], pos,
                                     sa.ring, w, angles)
                h = self._mlp(sp, h + a)
        new = HybridCacheT(ssm=SSMCache(conv=torch.stack(convs),
                                        state=torch.stack(states)),
                           shared_attn=sa)
        return self._logits(params, h), new

    # ----------------------------------------------------------------- prefill

    def prefill(self, params, tokens: torch.Tensor, slots: int,
                ring: bool = False, window: int = 0,
                prompt_lens: Optional[torch.Tensor] = None):
        """Process the whole (right-padded) prompt through ``verify_step``
        into a fresh cache of ``slots`` positions. ``prompt_lens`` (B,) —
        each row's true length: recurrent state stops there exactly
        (attention ignores it: padded slots are overwritten before any
        query can attend them). Returns (logits (B, S, V), cache)."""
        B, S = tokens.shape
        if self.cfg.arch_type != "ssm" and not ring and slots < S:
            # overflow writes are DROPPED, not clamped (models/kvcache.py):
            # refuse the geometry up front instead of silently losing the
            # prompt tail
            raise ValueError(
                f"prompt length {S} exceeds cache slots {slots}: size the "
                f"cache >= prompt + decode budget (or use a ring cache)")
        cache = self.init_cache(B, slots, ring=ring)
        pos0 = torch.zeros((B,), dtype=torch.int32, device=self.device)
        return self.verify_step(params, tokens, cache, pos0, window,
                                seq_lens=prompt_lens)


def build_model(cfg: ModelConfig, device) -> Model:
    return Model(cfg, device)
