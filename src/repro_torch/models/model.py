"""Model assembler for all six families of the reference
``repro/models/model.py``:

- ``dense`` / ``vlm`` — a GQA transformer LM (the vlm's image prefix
  enters only through a frontend the reference's serving path refuses too:
  text-only it is the dense stack),
- ``moe`` — GQA attention and the GShard capacity-dispatch MoE FFN
  (``models/moe.py``),
- ``ssm`` — a Mamba2 stack,
- ``hybrid`` — Zamba2: a Mamba2 backbone with one shared attention block
  called every ``attn_every`` layers,
- ``encdec`` — whisper: an encoder over the frontend's frame embeddings and
  a text decoder with cross-attention over the encoder output.

The API mirrors the reference ``repro/models/model.py``::

    params = model.init_params(seed)
    logits, aux = model.forward_train(params, batch)
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
from torch.utils.checkpoint import checkpoint

from ..configs.base import PAGED_FAMILIES, ModelConfig
from ..sharding.runtime import constrain, constrain_head_in, constrain_logits
from . import moe
from .attention import (attention_bidir, attention_cross, attention_decode,
                        attention_decode_paged, attention_train, cross_kv,
                        init_attn_params)
from .kvcache import (EncDecCache, HybridCacheT, PagedAttnCache, SSMCache,
                      init_attn_cache, init_paged_attn_cache, init_ssm_cache)
from .layers import dense_init, dtype_of, rms_norm, rope_angles, swiglu
from .ssm import (SSDState, conv_dim, init_ssm_params, ssm_block_decode,
                  ssm_block_train)

FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec")
# families whose decoder layers are the GQA stack over one AttnCache
STACK_FAMILIES = ("dense", "vlm", "moe")


def _layer(tree: dict, l: int) -> dict:
    return {k: (_layer(v, l) if isinstance(v, dict) else v[l])
            for k, v in tree.items()}


def _unbind(tree: dict, n: int) -> list[dict]:
    """The ``n`` per-layer dicts of a layer-stacked tree, each leaf split
    by one ``unbind`` (its backward stacks the layers' gradients once;
    indexing layer by layer would build a full-size gradient per layer)."""
    parts = {k: (_unbind(v, n) if isinstance(v, dict) else v.unbind(0))
             for k, v in tree.items()}
    return [{k: v[l] for k, v in parts.items()} for l in range(n)]


class Model:
    def __init__(self, cfg: ModelConfig, device):
        if cfg.arch_type not in FAMILIES:
            raise ValueError(f"unknown family {cfg.arch_type!r}")
        self.cfg = cfg
        self.dtype = dtype_of(cfg.dtype)
        self.device = torch.device(device)

    # ------------------------------------------------------------------ init

    def init_params(self, seed: int = 0) -> dict:
        """Random weights drawn on ``self.device`` in the model dtype from a
        seeded ``torch.Generator`` (reference init scales; norms and biases
        zero). The draws differ from the reference's ``jax.random`` ones:
        parity tests carry reference weights over with the bridge. A model
        on the meta device gets the same tree of shapes and dtypes with no
        storage and no draws (the dry-run's parameters)."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        gen = None
        if dev.type != "meta":
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
        L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
        zeros = lambda *s: torch.zeros(s, dtype=dt, device=dev)

        def mlp(n):
            return {"w_gate": dense_init(gen, (n, d, f), dt, dev, fan_in=d),
                    "w_up": dense_init(gen, (n, d, f), dt, dev, fan_in=d),
                    "w_down": dense_init(gen, (n, f, d), dt, dev, fan_in=f)}

        def attn_block(n, family="dense"):  # norms, attention, FFN: (n, ...)
            p = {"ln1": zeros(n, d), "ln2": zeros(n, d),
                 "attn": init_attn_params(gen, cfg, dt, dev, n)}
            if family == "moe":
                p["moe"] = moe.init_moe_params(gen, cfg, dt, dev, n)
            else:
                p["mlp"] = mlp(n)
            if family == "encdec":      # the decoder's cross-attention
                p["ln_x"] = zeros(n, d)
                p["xattn"] = init_attn_params(gen, cfg, dt, dev, n,
                                              cross=True)
            return p

        fam = cfg.arch_type
        params = {
            "embed": dense_init(gen, (cfg.vocab, d), dt, dev, fan_in=d),
            "final_norm": zeros(d),
            "layers": (attn_block(L, fam) if fam not in ("ssm", "hybrid")
                       else {"ln1": zeros(L, d),
                             "ssm": init_ssm_params(gen, cfg, dt, dev, L)}),
        }
        if fam == "encdec":
            params["encoder"] = attn_block(cfg.encoder_layers)
            params["enc_norm"] = zeros(d)
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
        h = constrain_head_in(rms_norm(h, params["final_norm"],
                                       cfg.norm_eps))
        head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        return constrain_logits((h @ head).float())

    def _mlp(self, lp: dict, h: torch.Tensor) -> torch.Tensor:
        """The residual FFN of one block: the SwiGLU MLP, or for a moe
        layer the MoE block (``_mlp_or_moe`` of the reference; the aux
        loss is a training term and is dropped here)."""
        hn = rms_norm(h, lp["ln2"], self.cfg.norm_eps)
        if "moe" in lp:
            return h + moe.moe_block(hn, lp["moe"], self.cfg)[0]
        m = lp["mlp"]
        return h + swiglu(hn, m["w_gate"], m["w_up"], m["w_down"])

    def _mlp_or_moe(self, lp: dict, h: torch.Tensor):
        """The residual FFN of one block and its aux loss (the reference's
        ``_mlp_or_moe``): the MoE block's load-balance term for a moe
        layer, a float32 zero otherwise."""
        hn = rms_norm(h, lp["ln2"], self.cfg.norm_eps)
        if "moe" in lp:
            y, aux = moe.moe_block(hn, lp["moe"], self.cfg)
            return h + y, aux
        m = lp["mlp"]
        return (h + swiglu(hn, m["w_gate"], m["w_up"], m["w_down"]),
                torch.zeros((), dtype=torch.float32, device=h.device))

    def _encode(self, params, frontend: torch.Tensor) -> torch.Tensor:
        """The whisper encoder over the frontend's frame embeddings (B, F,
        D): bidirectional blocks, then ``enc_norm`` (each block under
        :meth:`_remat` when training)."""
        cfg = self.cfg

        def enc_layer(h, lp):
            h = h + attention_bidir(rms_norm(h, lp["ln1"], cfg.norm_eps),
                                    lp["attn"], cfg)
            return constrain(self._mlp(lp, h))

        h = frontend.to(self.dtype)
        for lp in _unbind(params["encoder"], cfg.encoder_layers):
            h = self._remat(enc_layer, h, lp)
        return rms_norm(h, params["enc_norm"], cfg.norm_eps)

    # ---------------------------------------------------------- train forward

    def _remat(self, fn, *args):
        """``fn(*args)``, its activations recomputed in the backward pass
        when ``cfg.remat`` (the reference's ``jax.checkpoint``)."""
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def forward_train(self, params, batch: dict):
        """batch: {"tokens": (B, S) int, and for encdec/vlm "frontend":
        (B, F, D)}. Returns (float32 logits over the token positions (B, S,
        V), the summed aux loss: the MoE layers' load-balance terms, a
        float32 zero for the other families)."""
        cfg = self.cfg
        h = params["embed"][batch["tokens"].long()]
        zero = torch.zeros((), dtype=torch.float32, device=h.device)
        layers = _unbind(params["layers"], cfg.n_layers)
        eps = cfg.norm_eps

        if cfg.arch_type == "encdec":
            enc_out = self._encode(params, batch["frontend"])

            def dec_layer(h, lp, enc_out):
                h = h + attention_train(rms_norm(h, lp["ln1"], eps),
                                        lp["attn"], cfg)
                h = h + attention_cross(rms_norm(h, lp["ln_x"], eps),
                                        lp["xattn"], cfg,
                                        *cross_kv(lp["xattn"], cfg, enc_out))
                return constrain(self._mlp_or_moe(lp, h)[0])

            for lp in layers:
                h = self._remat(dec_layer, h, lp, enc_out)
            return self._logits(params, h), zero

        if cfg.arch_type in STACK_FAMILIES:
            prefix = 0
            if cfg.arch_type == "vlm":
                fe = batch["frontend"].to(self.dtype)      # (B, P, D)
                prefix = fe.shape[1]
                h = torch.cat([fe, h], dim=1)

            def layer(h, lp):
                h = h + attention_train(rms_norm(h, lp["ln1"], eps),
                                        lp["attn"], cfg, prefix_len=prefix)
                h, aux = self._mlp_or_moe(lp, h)
                return constrain(h), aux

            aux = zero
            for lp in layers:
                h, a = self._remat(layer, h, lp)
                aux = aux + a
            return self._logits(params, h[:, prefix:] if prefix else h), aux

        if cfg.arch_type == "hybrid":
            return self._logits(params, self._hybrid_train(params, h,
                                                           layers)), zero
        for lp in layers:
            h = self._remat(self._mamba_train, h, lp)
        return self._logits(params, h), zero

    def _mamba_train(self, h: torch.Tensor, lp: dict) -> torch.Tensor:
        """One residual Mamba2 layer over the whole sequence from a zero
        state (B5 on the card, forward and backward)."""
        y, _ = ssm_block_train(rms_norm(h, lp["ln1"], self.cfg.norm_eps),
                               lp["ssm"], self.cfg)
        return constrain(h + y)

    def _hybrid_train(self, params, h: torch.Tensor,
                      layers: list[dict]) -> torch.Tensor:
        """The reference's ``_hybrid_train``: segments of ``attn_every``
        Mamba2 layers, each followed by the shared attention block over the
        whole sequence, then the trailing Mamba2 layers."""
        cfg, eps = self.cfg, self.cfg.norm_eps
        every, n_seg, _ = self._hybrid_segments()
        sp = params["shared_attn"]
        m = sp["mlp"]
        for l, lp in enumerate(layers):
            h = self._remat(self._mamba_train, h, lp)
            if (l + 1) % every == 0 and l // every < n_seg:
                h = h + attention_train(rms_norm(h, sp["ln1"], eps),
                                        sp["attn"], cfg)
                h = h + swiglu(rms_norm(h, sp["ln2"], eps), m["w_gate"],
                               m["w_up"], m["w_down"])
        return h

    # ------------------------------------------------------------------ cache

    def _hybrid_segments(self) -> tuple[int, int, int]:
        """(layers per segment, segments, trailing Mamba2 layers): the shared
        block runs after each segment."""
        cfg = self.cfg
        every = cfg.attn_every or cfg.n_layers
        n_seg = cfg.n_layers // every
        return every, n_seg, cfg.n_layers - n_seg * every

    def init_cache(self, batch: int, slots: int, ring: bool = False,
                   enc_frames: int = 0):
        """Dense, vlm, moe: an :class:`AttnCache` of ``slots`` positions;
        encdec: an :class:`EncDecCache` whose cross K/V hold
        ``enc_frames`` frames (0: the config's ``n_frontend_tokens``); ssm:
        an :class:`SSMCache` (no positions); hybrid: both, the attention
        cache with one layer per shared-block call."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        if cfg.arch_type in STACK_FAMILIES:
            return init_attn_cache(cfg.n_layers, batch, slots,
                                   cfg.n_kv_heads, cfg.head_dim, dt, dev,
                                   ring)
        if cfg.arch_type == "encdec":
            cross = (cfg.n_layers, batch, enc_frames or cfg.n_frontend_tokens,
                     cfg.n_kv_heads, cfg.head_dim)
            return EncDecCache(
                self_attn=init_attn_cache(cfg.n_layers, batch, slots,
                                          cfg.n_kv_heads, cfg.head_dim, dt,
                                          dev, ring),
                cross_k=torch.zeros(cross, dtype=dt, device=dev),
                cross_v=torch.zeros(cross, dtype=dt, device=dev))
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
        layout (dense, vlm and moe over a dense cache only; see
        :func:`repro_torch.models.attention.attention_decode`)."""
        return self._window_step(params, window_tokens, cache, pos, window,
                                 seq_lens, slot_off, pos_off, win_mask)

    def _window_step(self, params, tokens: torch.Tensor, cache,
                     pos: torch.Tensor, window: int = 0,
                     seq_lens: Optional[torch.Tensor] = None,
                     slot_off: Optional[torch.Tensor] = None,
                     pos_off: Optional[torch.Tensor] = None,
                     win_mask: Optional[torch.Tensor] = None,
                     need_logits: bool = True):
        """(logits, cache); (None, cache) without ``need_logits`` (a
        chunked prefill's inner chunks: no lm head)."""
        h, cache = self._window_hidden(params, tokens, cache, pos, window,
                                       seq_lens, slot_off, pos_off, win_mask)
        return (self._logits(params, h) if need_logits else None), cache

    def _window_hidden(self, params, tokens: torch.Tensor, cache,
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
                paged or cfg.arch_type not in STACK_FAMILIES):
            raise NotImplementedError(
                "tree-speculation windows need a dense/moe AttnCache")
        if cfg.arch_type == "ssm":
            return self._ssm_window(params, h, cache, T, seq_lens)
        if cfg.arch_type == "hybrid":
            return self._hybrid_window(params, h, cache, pos, T, w,
                                       seq_lens)
        if cfg.arch_type == "encdec":
            return self._encdec_window(params, h, cache, pos, T, w)
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
        return h, cache

    def _encdec_window(self, params, h, cache: EncDecCache,
                       pos: torch.Tensor, T: int, w: int):
        """The whisper decoder: per layer, self-attention over the cache
        (B1, written in place), cross-attention over the layer's encoder
        K/V, then the MLP."""
        cfg = self.cfg
        sa = cache.self_attn
        abs_pos = pos[:, None] + torch.arange(T, device=pos.device,
                                              dtype=pos.dtype)[None, :]
        angles = rope_angles(abs_pos, cfg.head_dim, cfg.rope_theta)
        layers = params["layers"]
        for l in range(cfg.n_layers):
            lp = _layer(layers, l)
            x = rms_norm(h, lp["ln1"], cfg.norm_eps)
            h = h + attention_decode(x, lp["attn"], cfg, sa.k_buf[l],
                                     sa.v_buf[l], sa.pm_buf[l], pos,
                                     sa.ring, w, angles)
            x = rms_norm(h, lp["ln_x"], cfg.norm_eps)
            h = h + attention_cross(x, lp["xattn"], cfg, cache.cross_k[l],
                                    cache.cross_v[l])
            h = self._mlp(lp, h)
        return h, cache

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
        return h, SSMCache(conv=torch.stack(convs), state=torch.stack(states))

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
        return h, new

    # ----------------------------------------------------------------- prefill

    def prefill(self, params, tokens: torch.Tensor, slots: int,
                ring: bool = False, window: int = 0,
                prompt_lens: Optional[torch.Tensor] = None,
                frontend: Optional[torch.Tensor] = None,
                chunk: Optional[int] = None):
        """Process the whole (right-padded) prompt through ``verify_step``
        into a fresh cache of ``slots`` positions. ``prompt_lens`` (B,) —
        each row's true length: recurrent state stops there exactly
        (attention ignores it: padded slots are overwritten before any
        query can attend them). ``frontend`` (B, F, D) — an encdec model
        encodes these frames and fills every decoder layer's cross K/V; a
        vlm refuses a live frontend (the reference's rule); the other
        families ignore it. Returns (logits (B, S, V), cache).

        ``chunk`` (the reference's): a prompt longer than ``chunk`` and a
        multiple of it runs in ``chunk``-token windows in order, so the
        attention scores stay (chunk × slots); only the last window goes
        through the lm head, and the logits are the last window's (B,
        chunk, V). Full prompts only (no ``prompt_lens``)."""
        B, S = tokens.shape
        cfg = self.cfg
        if cfg.arch_type == "vlm" and frontend is not None:
            raise NotImplementedError(
                "vlm prefill with live frontend goes through serving.batching")
        if cfg.arch_type == "encdec" and frontend is None:
            raise ValueError("an encdec prefill needs the frontend's frame "
                             "embeddings (B, F, D)")
        if self.cfg.arch_type != "ssm" and not ring and slots < S:
            # overflow writes are DROPPED, not clamped (models/kvcache.py):
            # refuse the geometry up front instead of silently losing the
            # prompt tail
            raise ValueError(
                f"prompt length {S} exceeds cache slots {slots}: size the "
                f"cache >= prompt + decode budget (or use a ring cache)")
        encdec = cfg.arch_type == "encdec"
        cache = self.init_cache(B, slots, ring=ring,
                                enc_frames=frontend.shape[1] if encdec else 0)
        if encdec:
            enc_out = self._encode(params, frontend)
            for l in range(cfg.n_layers):
                k, v = cross_kv(_layer(params["layers"]["xattn"], l), cfg,
                                enc_out)
                cache.cross_k[l].copy_(k)
                cache.cross_v[l].copy_(v)
        pos0 = torch.zeros((B,), dtype=torch.int32, device=self.device)
        if chunk and S > chunk and S % chunk == 0:
            if prompt_lens is not None:
                raise ValueError("a chunked prefill takes full prompts")
            n = S // chunk
            for i in range(n - 1):
                _, cache = self._window_step(
                    params, tokens[:, i * chunk:(i + 1) * chunk], cache,
                    pos0 + i * chunk, window, need_logits=False)
            return self._window_step(params, tokens[:, (n - 1) * chunk:],
                                     cache, pos0 + (n - 1) * chunk, window)
        return self.verify_step(params, tokens, cache, pos0, window,
                                seq_lens=prompt_lens)


def build_model(cfg: ModelConfig, device) -> Model:
    return Model(cfg, device)
