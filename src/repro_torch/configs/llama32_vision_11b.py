"""Llama-3.2-Vision-11B: cross-attn image layers every 5th layer
[hf:meta-llama/Llama-3.2-11B-Vision]; vision encoder stubbed
(precomputed patch embeddings, 1601 tokens @ d_vision=1280)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=128256, head_dim=128,
    cross_every=5, n_img_tokens=1601, d_vision=1280,
    rope_theta=500_000.0, sp_residual=True,
)
