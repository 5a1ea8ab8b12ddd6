"""Assigned architecture configs (exact hyperparameters from the
assignment) + input shapes. ``get_config(name)`` resolves by id."""

from . import (
    arctic_480b,
    hymba_1_5b,
    kimi_k2_1t_a32b,
    llama32_vision_11b,
    mamba2_1_3b,
    minicpm_2b,
    phi3_medium_14b,
    starcoder2_3b,
    whisper_medium,
    yi_9b,
)
from .base import ModelConfig, ShapeConfig
from .shapes import SHAPES, runnable

CONFIGS = {
    m.CONFIG.name: m.CONFIG
    for m in (
        yi_9b, minicpm_2b, phi3_medium_14b, starcoder2_3b, arctic_480b,
        kimi_k2_1t_a32b, mamba2_1_3b, whisper_medium, llama32_vision_11b,
        hymba_1_5b,
    )
}


def get_config(name: str) -> ModelConfig:
    if name not in CONFIGS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(CONFIGS)}")
    return CONFIGS[name]


__all__ = ["CONFIGS", "SHAPES", "get_config", "runnable", "ModelConfig", "ShapeConfig"]
