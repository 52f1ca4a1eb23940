"""zamba2-1.2b — hybrid: Mamba2 backbone + SHARED attention block
[arXiv:2411.15242].
38 Mamba2 layers, d_model 2048, shared attn block (32 heads, kv=32,
d_ff 8192) invoked every 6 layers, vocab 32000, ssm_state 64."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", arch_type="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32000, head_dim=64,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_conv=4,
    ssm_chunk=128, attn_every=6)
