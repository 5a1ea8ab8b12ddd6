"""Hymba-1.5B: parallel attention + mamba heads per layer
[arXiv:2411.13676; hf]. SWA everywhere except 3 global layers."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab_size=32001, head_dim=64,
    ssm_state=16, ssm_heads=25, ssm_head_dim=64, ssm_chunk=128,
    sliding_window=1024, global_layers=(0, 15, 31),
    tie_embeddings=True,
)
