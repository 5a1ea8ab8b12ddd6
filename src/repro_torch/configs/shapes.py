"""Assigned input shapes (identical set for every LM arch).

``decode_*`` / ``long_*`` lower serve_step (one new token against a KV
cache / SSM state of seq_len), not train_step. ``long_500k`` runs only
for sub-quadratic archs (ssm / hybrid) — see DESIGN.md §5.
"""

from .base import ShapeConfig

SHAPES = {
    "train_4k": ShapeConfig("train_4k", seq_len=4_096, global_batch=256, phase="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, phase="prefill"),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, phase="decode"),
    "long_500k": ShapeConfig("long_500k", seq_len=524_288, global_batch=1, phase="decode"),
}

SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")


def runnable(cfg, shape: ShapeConfig) -> bool:
    """Cell-skip rule: long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k":
        return cfg.family in SUBQUADRATIC_FAMILIES
    return True
