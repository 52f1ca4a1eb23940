"""Model configuration schema for the whole zoo.

One frozen dataclass covers all six architecture families (dense, moe, ssm,
hybrid, encdec-audio, vlm); family-specific fields default off. Every
assigned architecture file in this package instantiates it with the exact
published numbers and cites its source in the module docstring.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Optional

# families whose layers keep attention KV caches (fused step, tree step);
# the rest (ssm, hybrid) carry recurrent state and take the split step
ATTENTION_FAMILIES = ("dense", "moe", "vlm", "encdec")
# families whose caches a paged KV pool can hold (the reference's rule)
PAGED_FAMILIES = ("dense", "moe")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 → d_model // n_heads

    # attention variants
    qk_norm: bool = False          # qwen3-style per-head RMSNorm on q,k
    qkv_bias: bool = False         # qwen2.5-style bias on qkv projections
    attn_out_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 0        # 0 = full attention; >0 = window size
    # serving variant: use sliding window only for long-context serving
    serve_sliding_window: int = 8192

    # MoE
    n_experts: int = 0
    experts_per_tok: int = 0
    moe_dense_residual: bool = False   # arctic: dense MLP residual beside MoE
    capacity_factor: float = 1.25
    moe_group: int = 4096              # GShard group size for long sequences

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128           # SSD chunk length
    attn_every: int = 0            # hybrid: shared attn block cadence

    # encoder-decoder (audio) / vlm
    encoder_layers: int = 0
    n_frontend_tokens: int = 0     # whisper frames (post-conv) / vit patches
    frontend_dim: int = 0          # stub embedding dim (0 → d_model)
    cross_attention: bool = False

    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    remat: bool = True

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(1, self.n_heads))
        if self.frontend_dim == 0:
            object.__setattr__(self, "frontend_dim", self.d_model)

    # -- derived ------------------------------------------------------------

    @property
    def is_attention_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def has_attention_cache(self) -> bool:
        return self.arch_type in ATTENTION_FAMILIES

    @property
    def pageable(self) -> bool:
        return self.arch_type in PAGED_FAMILIES

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Total parameters (excludes stub frontends, which carry none)."""
        d, hd = self.d_model, self.head_dim
        total = 2 * self.vocab * d if not self.tie_embeddings else self.vocab * d

        def attn_params() -> int:
            p = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
                + (self.n_heads * hd) * d
            if self.qkv_bias:
                p += (self.n_heads + 2 * self.n_kv_heads) * hd
            if self.qk_norm:
                p += 2 * hd
            return p + 2 * d  # two norms

        def mlp_params() -> int:
            return 3 * d * self.d_ff

        def moe_params() -> int:
            p = d * self.n_experts + self.n_experts * 3 * d * self.d_ff
            if self.moe_dense_residual:
                p += 3 * d * self.d_ff
            return p + 2 * d

        def ssm_params() -> int:
            din, st, nh = self.ssm_d_inner, self.ssm_state, self.ssm_heads
            proj_in = d * (2 * din + 2 * st + nh)
            conv = (din + 2 * st) * self.ssm_conv
            return proj_in + conv + 2 * nh + din + din * d + d

        if self.arch_type == "dense" or self.arch_type == "vlm":
            total += self.n_layers * (attn_params() + mlp_params())
        elif self.arch_type == "moe":
            total += self.n_layers * (attn_params() + moe_params())
        elif self.arch_type == "ssm":
            total += self.n_layers * ssm_params()
        elif self.arch_type == "hybrid":
            total += self.n_layers * ssm_params()
            total += attn_params() + mlp_params()   # one shared block
        elif self.arch_type == "encdec":
            total += self.encoder_layers * (attn_params() + mlp_params())
            # decoder blocks: self-attn + cross-attn + mlp
            total += self.n_layers * (2 * attn_params() + mlp_params())
        total += d  # final norm
        return total

    def active_param_count(self) -> int:
        if self.n_experts == 0:
            return self.param_count()
        dense_ffn = self.experts_per_tok * 3 * self.d_model * self.d_ff
        if self.moe_dense_residual:
            dense_ffn += 3 * self.d_model * self.d_ff
        per_layer = (self.d_model * (self.n_heads + 2 * self.n_kv_heads)
                     * self.head_dim + self.n_heads * self.head_dim
                     * self.d_model + dense_ffn + self.d_model * self.n_experts)
        emb = (1 if self.tie_embeddings else 2) * self.vocab * self.d_model
        return emb + self.n_layers * per_layer

    # -- smoke-test reduction -------------------------------------------------

    def reduced(self) -> "ModelConfig":
        """The REDUCED same-family variant used by CPU smoke tests:
        2 layers, d_model ≤ 512, ≤ 4 experts, small vocab."""
        d = min(self.d_model, 256)
        heads = max(1, min(self.n_heads, 4))
        kv = max(1, min(self.n_kv_heads, heads))
        hd = max(8, d // heads)
        kw = dict(
            name=self.name + "-smoke",
            n_layers=2,
            d_model=d,
            n_heads=heads,
            n_kv_heads=kv,
            head_dim=hd,
            d_ff=min(self.d_ff, 512) or 512,
            vocab=min(self.vocab, 512),
            dtype="float32",
            remat=False,
        )
        if self.n_experts:
            kw["n_experts"] = min(4, self.n_experts)
            kw["experts_per_tok"] = min(self.experts_per_tok, 2)
        if self.ssm_state:
            kw["ssm_state"] = min(self.ssm_state, 16)
            kw["ssm_head_dim"] = 16
            kw["ssm_chunk"] = 16
        if self.attn_every:
            kw["attn_every"] = 1
        if self.encoder_layers:
            kw["encoder_layers"] = 2
        if self.n_frontend_tokens:
            kw["n_frontend_tokens"] = min(self.n_frontend_tokens, 16)
        if self.sliding_window:
            kw["sliding_window"] = min(self.sliding_window, 64)
        kw["serve_sliding_window"] = min(self.serve_sliding_window, 64)
        return replace(self, **kw)
