"""The paper's own draft/target pair (§5): llama2-7b edge draft +
llama2-70b cloud target [arXiv:2307.09288]."""
from .base import ModelConfig

DRAFT = ModelConfig(
    name="llama2-7b", arch_type="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=11008, vocab=32000, head_dim=128)

TARGET = ModelConfig(
    name="llama2-70b", arch_type="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=32000, head_dim=128)

CONFIG = TARGET
