"""Model + shape configuration schema.

One ``ModelConfig`` instance per assigned architecture (exact numbers in
sibling modules); ``ShapeConfig`` instances in shapes.py. ``scaled()``
produces the reduced smoke-test variants."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 32000
    head_dim: int = 0  # 0 -> d_model // n_heads
    ffn_kind: str = "swiglu"  # swiglu | gelu
    rope_theta: float = 1e4
    sliding_window: int = 0  # 0 = full attention
    global_layers: tuple = ()  # full-attention layers within an SWA model
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    # --- SSM ---
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    # --- encoder-decoder ---
    n_enc_layers: int = 0
    enc_seq: int = 1500  # stub frontend frames (whisper 30 s @ 50 Hz)
    # --- VLM ---
    cross_every: int = 0  # cross-attn image layer every N decoder layers
    n_img_tokens: int = 0
    d_vision: int = 0
    # --- misc ---
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    param_dtype: str = "float32"  # bf16 for the 480B/1T archs (+Adafactor)
    sp_residual: bool = False  # sequence-parallel residual stream (Megatron-SP)
    tie_embeddings: bool = False
    optimizer: str = "adamw"  # adamw | adafactor
    accum_steps: int = 1  # gradient-accumulation microbatches per step
    moe_reduce_scatter: bool = False  # §Perf B2: refuted at graph level, keep off

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def padded_vocab(self) -> int:
        from ..models.common import pad_vocab

        return pad_vocab(self.vocab_size)

    def scaled(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def smoke(self) -> "ModelConfig":
        """Reduced same-family config for CPU smoke tests."""
        kw = dict(
            n_layers=min(self.n_layers, 2),
            d_model=64,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            head_dim=16,
            dtype="float32",
        )
        if self.n_heads:
            kw["n_heads"] = 4
            kw["n_kv_heads"] = max(1, min(self.n_kv_heads, 2)) if self.n_kv_heads < self.n_heads else 4
        if self.n_experts:
            kw["n_experts"] = 8
            kw["experts_per_token"] = min(self.experts_per_token, 2)
        if self.ssm_state:
            kw["ssm_state"] = 8
            kw["ssm_heads"] = 4
            kw["ssm_head_dim"] = 16
            kw["ssm_chunk"] = 8
        if self.n_enc_layers:
            kw["n_enc_layers"] = 2
            kw["enc_seq"] = 16
        if self.cross_every:
            kw["cross_every"] = 2
            kw["n_img_tokens"] = 8
            kw["d_vision"] = 32
        if self.sliding_window:
            kw["sliding_window"] = 8
            kw["global_layers"] = (0,)
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    phase: str  # 'train' | 'prefill' | 'decode'

    def scaled(self, **kw) -> "ShapeConfig":
        return dataclasses.replace(self, **kw)
