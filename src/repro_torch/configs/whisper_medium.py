"""Whisper-medium: enc-dec, conv frontend stubbed [arXiv:2212.04356].

24 encoder + 24 decoder layers (the assignment's 24L counts the
decoder); GELU FFN, sinusoidal positions, tied embeddings."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=51865, head_dim=64,
    ffn_kind="gelu", enc_seq=1500, tie_embeddings=True,
)
