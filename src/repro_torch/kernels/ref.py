"""Plain PyTorch twins of the CUDA kernels (the ``ref.py`` contract).

Each twin computes what its kernel computes.  The wrappers in ``ops.py``
take the twin for tensors on the CPU, the tests hold the twins against
the reference's Pallas kernels, and ``chip_smoke.py`` holds each kernel
against its twin on the card.
"""

from __future__ import annotations

import torch

__all__ = [
    "topk_rounds",
    "merge_topk",
    "slot_d2",
    "take_fill",
    "bins_from_pool",
    "fused_window_search_ref",
    "fused_cand_search_ref",
    "window_verify_ref",
    "candidate_verify_ref",
]

IMAX = 2**31 - 1


def topk_rounds(cd: torch.Tensor, ci: torch.Tensor, k: int, fill_id: int):
    """k rounds of min-select over the last axis: the k lexicographically
    smallest distinct (dist, id) pairs with finite dist, ascending.

    Each round takes the smallest distance, the smallest id at that
    distance, then drops every entry equal to the selected pair.
    Unfilled slots get (+inf, ``fill_id``).  cd: (..., C) float32,
    ci: (..., C) int32."""
    shape = cd.shape[:-1] + (k,)
    nd = torch.full(shape, torch.inf, dtype=cd.dtype, device=cd.device)
    ni = torch.full(shape, fill_id, dtype=torch.int32, device=cd.device)
    for j in range(k):
        m = cd.amin(dim=-1, keepdim=True)
        eq = cd == m
        sel = torch.where(eq, ci, IMAX).amin(dim=-1, keepdim=True)
        nd[..., j] = m[..., 0]
        ni[..., j] = torch.where(torch.isfinite(m), sel, fill_id)[..., 0]
        cd = torch.where(eq & (ci == sel), torch.inf, cd)
    return nd, ni


def merge_topk(cd, ci, out_d, out_i, k: int):
    """Twin of the reference's in-kernel ``merge_topk``
    (``repro/kernels/window_verify.py:83``): merge candidates (..., C)
    into a running top-k (..., k); unfilled ids are INT32_MAX."""
    return topk_rounds(
        torch.cat([out_d, cd], dim=-1),
        torch.cat([out_i, ci], dim=-1).to(torch.int32),
        k, fill_id=IMAX,
    )


def slot_d2(x: torch.Tensor, q: torch.Tensor, nrm: torch.Tensor, exact: bool):
    """Per-slot squared distances over the last axis.

    ``exact``: diff form sum((x - q)^2).  Otherwise the norm form
    max(||x||^2 - 2<q,x> + ||q||^2, 0) with the squared norms ``nrm``
    precomputed (+inf norms poison padded slots).  The dot is a per-slot
    multiply plus last-axis reduce, not a batched matmul: its order then
    does not depend on the batch shape.  ``q`` broadcasts against ``x``."""
    if exact:
        return torch.sum(torch.square(x - q), dim=-1)
    q2 = torch.sum(torch.square(q), dim=-1)
    dots = torch.sum(x * q, dim=-1)
    return torch.clamp(nrm - 2.0 * dots + q2, min=0.0)


def bins_from_pool(d2, hw, ids, halves, n: int, ks: int):
    """Bin accumulators from a flat (Q, C) pool (``fused_search_ref``).

    ``binid = #{j: hw > halves[j]}`` is the first admitting step
    (``steps`` = never admitted); per bin, the ks lexicographically
    smallest distinct (d2, id) pairs with finite d2; ``cnt[q, j]`` counts
    the slots of bin j.  Returns bins_d (Q, steps, ks) f32, bins_i
    (Q, steps, ks) int32 with ``n`` on unfilled slots, cnt (Q, steps)
    int32."""
    steps = halves.shape[0]
    binid = (hw.unsqueeze(-1) > halves).sum(dim=-1)
    ids = ids.to(torch.int32)
    bds, bis, cnts = [], [], []
    for j in range(steps):
        inbin = binid == j
        cnts.append(inbin.sum(dim=1))
        bd, bi = topk_rounds(torch.where(inbin, d2, torch.inf), ids, ks, fill_id=n)
        bds.append(bd)
        bis.append(bi)
    return (torch.stack(bds, 1), torch.stack(bis, 1),
            torch.stack(cnts, 1).to(torch.int32))


def take_fill(table: torch.Tensor, idx: torch.Tensor, fill):
    """``table[idx]`` along axis 0 with ``fill`` where idx is out of range."""
    valid = (idx >= 0) & (idx < table.shape[0])
    out = table[torch.where(valid, idx, 0).long()]
    valid = valid.reshape(valid.shape + (1,) * (table.dim() - 1))
    return torch.where(valid, out, torch.as_tensor(fill, dtype=table.dtype))


def fused_window_search_ref(blk_idx, halves, proj_blocks, x_blocks, norm_blocks,
                            ids_blocks, g, q, *, M: int, ks: int, n: int,
                            mode: str = "norm"):
    """Twin of the fused window kernel: gather the selected blocks of the
    flattened (L*nb) axis (invalid ids >= L*nb gather +inf projections,
    so they never admit), then bin the pool."""
    Qn, S = blk_idx.shape
    pb = take_fill(proj_blocks, blk_idx, torch.inf)  # (Q, S, B, K)
    vb = take_fill(x_blocks, blk_idx, 0.0)  # (Q, S, B, d)
    nrm = take_fill(norm_blocks, blk_idx, torch.inf)  # (Q, S, B)
    ib = take_fill(ids_blocks, blk_idx, n)
    g_rep = torch.repeat_interleave(g, M, dim=1)  # (Q, S, K)
    hw = torch.abs(pb - g_rep[:, :, None, :]).amax(dim=-1)
    d2 = slot_d2(vb, q[:, None, None, :], nrm, mode == "exact")
    return bins_from_pool(d2.reshape(Qn, -1), hw.reshape(Qn, -1),
                          ib.reshape(Qn, -1), halves, n, ks)


def fused_cand_search_ref(cand_proj, cand_x, cand_norms, cand_ids, halves, g, q,
                          *, ks: int, n: int, mode: str = "norm"):
    """Twin of the fused gathered kernel over (Q, L, Ct, ·) candidates;
    +inf projections keep invalid slots out of every bin."""
    Qn = cand_proj.shape[0]
    hw = torch.abs(cand_proj - g[:, :, None, :]).amax(dim=-1)  # (Q, L, Ct)
    d2 = slot_d2(cand_x, q[:, None, None, :], cand_norms, mode == "exact")
    return bins_from_pool(d2.reshape(Qn, -1), hw.reshape(Qn, -1),
                          cand_ids.reshape(Qn, -1), halves, n, ks)


def candidate_verify_ref(cand_proj, cand_vecs, cand_ids, g, q, w: float, *,
                         n: int, k: int):
    """Twin of the per-radius gathered verify kernel (B7): the box test
    ``max_k |p_k - g_k| <= 0.5 * w`` and ``id < n`` per slot, diff-form
    d2 for the slots that pass, then the k lexicographically smallest
    distinct (d2, id) pairs with finite d2 (unfilled: +inf / ``n``).

    cand_proj: (Q, C, K) f32 (+inf on invalid slots); cand_vecs: (Q, C, d);
    cand_ids: (Q, C) int32; g: (Q, K); q: (Q, d); w: window width."""
    half = float(0.5 * torch.tensor(w, dtype=torch.float32))
    hw = torch.abs(cand_proj - g[:, None, :]).amax(dim=-1)
    inbox = (hw <= half) & (cand_ids < n)
    d2 = slot_d2(cand_vecs, q[:, None, :], None, exact=True)
    return topk_rounds(torch.where(inbox, d2, torch.inf), cand_ids.to(torch.int32),
                       k, fill_id=n)


def window_verify_ref(blk_idx, proj_blocks, vec_blocks, ids_blocks, g, q, w: float,
                      *, n: int, k: int):
    """Twin of the per-radius window verify kernel (B6): gather the
    selected blocks of one table (ids outside [0, nb) gather +inf
    projections, so they never pass the box test), then verify them as
    :func:`candidate_verify_ref` does.

    blk_idx: (Q, M) int32; proj_blocks: (nb, B, K); vec_blocks: (nb, B, d);
    ids_blocks: (nb, B) int32; g: (Q, K); q: (Q, d); w: window width."""
    Qn, M = blk_idx.shape
    B, K = proj_blocks.shape[1:]
    pb = take_fill(proj_blocks, blk_idx, torch.inf).reshape(Qn, M * B, K)
    vb = take_fill(vec_blocks, blk_idx, 0.0).reshape(Qn, M * B, -1)
    ib = take_fill(ids_blocks, blk_idx, n).reshape(Qn, M * B)
    return candidate_verify_ref(pb, vb, ib, g, q, w, n=n, k=k)
