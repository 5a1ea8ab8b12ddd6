"""DB-LSH query-phase helpers.  Only the serving path's merge is ported
so far; the paper's adaptive ``search``/``rc_nn`` come with termination."""

from __future__ import annotations

import torch

from ..kernels.ref import topk_rounds

__all__ = ["merge_dedup_topk"]


def merge_dedup_topk(run_d, run_i, new_d, new_i, n: int, k: int):
    """Batched dedup'd top-k merge via k rounds of min-select.

    Each round takes the smallest distance, the smallest id among the
    entries at that distance, and then drops every entry equal to the
    selected (dist, id) pair — cross-table duplicates of one point carry
    identical pairs, so that is exact dedup.  The result is the k
    lexicographically smallest distinct (dist, id) pairs with finite
    dist, ascending.

    Args:
      run_d/run_i: (Q, a) running top-k (ascending, +inf / ``n`` padded).
      new_d/new_i: (Q, b) fresh candidates (masked slots +inf).
      n: invalid-id sentinel; k: top-k.

    Returns: (Q, k) distances ascending, (Q, k) int32 ids (``n`` when
    unfilled).
    """
    cd = torch.cat([run_d, new_d], dim=1)
    ci = torch.cat([run_i.to(torch.int32), new_i.to(torch.int32)], dim=1)
    return topk_rounds(cd, ci, k, fill_id=n)
