"""StarCoder2-3B: dense GQA kv=2, RoPE [arXiv:2402.19173; hf].

Upstream ships a 4k sliding window; the assignment brackets it [dense],
so it is treated as full attention here (long_500k skipped)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2,
    d_ff=12288, vocab_size=49152, head_dim=128,
    rope_theta=100_000.0,
)
