"""Hand-written CUDA kernels of the DB-LSH query path, with their plain
PyTorch twins (``ref.py``).  Kernels are built at first CUDA use."""

from . import ref
from .ops import (
    candidate_verify,
    fused_cand_search,
    fused_window_search,
    launches,
    mode_launches,
    reset_launches,
    window_verify,
)

__all__ = [
    "candidate_verify",
    "fused_cand_search",
    "fused_window_search",
    "launches",
    "mode_launches",
    "reset_launches",
    "window_verify",
    "ref",
]
