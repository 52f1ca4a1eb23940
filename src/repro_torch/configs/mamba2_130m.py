"""mamba2-130m — SSD state-space duality [arXiv:2405.21060].
24L, d_model 768, attention-free, vocab 50280, ssm_state 128."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", arch_type="ssm",
    n_layers=24, d_model=768, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50280, ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    ssm_conv=4, ssm_chunk=128, tie_embeddings=True)
