"""whisper-tiny — audio enc-dec, conv frontend STUB [arXiv:2212.04356].
4L decoder (+4L encoder), d_model 384, 6 heads, d_ff 1536, vocab 51865.
The mel-spectrogram + conv feature extractor is stubbed per assignment:
input_specs() provides precomputed frame embeddings (B, 1500, 384)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", arch_type="encdec",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab=51865, head_dim=64,
    encoder_layers=4, n_frontend_tokens=1500, cross_attention=True)
