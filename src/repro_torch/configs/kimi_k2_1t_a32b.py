"""Kimi-K2-1T-A32B: trillion-param MoE, 384 experts top-8
[arXiv:2501.kimi2 (paper-table)]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab_size=163840, head_dim=112,
    n_experts=384, experts_per_token=8,
    rope_theta=50_000.0, optimizer="adafactor", accum_steps=4, param_dtype="bfloat16", sp_residual=True,
)
