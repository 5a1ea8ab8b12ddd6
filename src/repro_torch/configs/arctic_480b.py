"""Snowflake Arctic-480B: 128-expert top-2 MoE + dense residual
[hf:Snowflake/snowflake-arctic-base]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab_size=32000, head_dim=128,
    n_experts=128, experts_per_token=2, dense_residual=True,
    rope_theta=10_000.0, optimizer="adafactor", accum_steps=8, param_dtype="bfloat16", sp_residual=True,
)
