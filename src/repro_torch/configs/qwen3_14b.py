"""qwen3-14b — dense, qk_norm + GQA [hf:Qwen/Qwen3-8B].
40L, d_model 5120, 40 heads (GQA kv=8), d_ff 17408, vocab 151936."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b", arch_type="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=17408, vocab=151936, head_dim=128, qk_norm=True,
    rope_theta=1000000.0)
