"""command-r-plus-104b — dense, GQA, no-bias
[hf:CohereForAI/c4ai-command-r-v01].
64L, d_model 12288, 96 heads (GQA kv=8), d_ff 33792, vocab 256000."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", arch_type="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8,
    d_ff=33792, vocab=256000, head_dim=128, rope_theta=75000000.0)
