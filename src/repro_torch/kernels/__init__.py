"""Hand-written CUDA kernels of the DB-LSH query path, with their plain
PyTorch twins (``ref.py``).  Kernels are built at first CUDA use."""

from . import ref
from .ops import (
    candidate_dist,
    candidate_verify,
    fused_cand_search,
    fused_window_search,
    launches,
    merge_schedule,
    mode_launches,
    pairwise_l2,
    reset_launches,
    select_blocks,
    window_dist,
    window_verify,
)

__all__ = [
    "candidate_dist",
    "candidate_verify",
    "fused_cand_search",
    "fused_window_search",
    "launches",
    "merge_schedule",
    "mode_launches",
    "pairwise_l2",
    "reset_launches",
    "select_blocks",
    "window_dist",
    "window_verify",
    "ref",
]
