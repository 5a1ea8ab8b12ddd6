"""Hand-written CUDA kernels of the DB-LSH query path, with their plain
PyTorch twins (``ref.py``).  Kernels are built at first CUDA use."""

from . import ref
from .ops import fused_cand_search, fused_window_search, launches, reset_launches

__all__ = [
    "fused_cand_search",
    "fused_window_search",
    "launches",
    "reset_launches",
    "ref",
]
