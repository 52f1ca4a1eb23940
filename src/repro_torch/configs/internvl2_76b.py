"""internvl2-76b — VLM: InternViT (STUB) + InternLM2 backbone
[arXiv:2404.16821].
80L, d_model 8192, 64 heads (GQA kv=8), d_ff 28672, vocab 128256.
The vision encoder + projector is stubbed per assignment: input_specs()
provides precomputed patch embeddings (B, 256, 8192) as a bidirectional
prefix ahead of the text tokens."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", arch_type="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256, head_dim=128,
    n_frontend_tokens=256, rope_theta=1000000.0)
