"""arctic-480b — MoE 128 experts top-2 + dense residual MLP
[hf:Snowflake/snowflake-arctic-base].
35L, d_model 7168, 56 heads (GQA kv=8), expert d_ff 4864, vocab 32000."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", arch_type="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab=32000, head_dim=128,
    n_experts=128, experts_per_tok=2, moe_dense_residual=True,
    capacity_factor=1.25)
