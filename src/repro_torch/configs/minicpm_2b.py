"""MiniCPM-2B: llama-like dense MHA, WSD schedule [arXiv:2404.06395; hf]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36,
    d_ff=5760, vocab_size=122753, head_dim=64,
    rope_theta=10_000.0, tie_embeddings=True,
)
# WSD (warmup-stable-decay) is the paper's training schedule; see
# repro.train.optimizer.wsd_schedule — selected by train configs.
