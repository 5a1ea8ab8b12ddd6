"""Mamba2-1.3B: attention-free SSD stack [arXiv:2405.21060]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280,
    sp_residual=True, ssm_state=128, ssm_heads=64, ssm_head_dim=64, ssm_chunk=64,
    tie_embeddings=True,
)
