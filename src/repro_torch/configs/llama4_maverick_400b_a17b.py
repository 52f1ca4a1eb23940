"""llama4-maverick-400b-a17b — MoE, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E].
48L, d_model 5120, 40 heads (GQA kv=8), d_ff 8192, vocab 202048,
MoE 128 experts top-1."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b", arch_type="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048, head_dim=128,
    n_experts=128, experts_per_tok=1, capacity_factor=1.25,
    rope_theta=500000.0)
