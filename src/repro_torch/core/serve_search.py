"""Batched fixed-schedule DB-LSH search — the serving path.

Every query runs ``steps`` probes r0, c·r0, …, c^{steps-1}·r0 with
one-pass incremental probing (DESIGN.md §7): windows nest across the
schedule, so the search

  1. projects the queries once (one einsum);
  2. selects blocks once, at the final radius (``_select_blocks``: MBR
     overlap test plus the M smallest MINDIST per table);
  3. verifies every selected slot once, emitting its distance and its
     window halfwidth ``hw = max_k |p_k - g_k|``;
  4. merges, per step, only the slots newly admitted at that step.

Three verify engines:
  * ``torch``  — plain PyTorch gather + verify into a (Q, C) pool, merged
                 per step (the reference's ``jnp`` engine);
  * ``kernel`` — the fused CUDA kernel B2 on pre-gathered candidates;
  * ``inline`` — the fused CUDA kernel B1 reading the selected blocks in
                 place (needs params.inline_vectors).
The fused engines bin every slot by its first admitting step and keep a
per-(query, step) top-k, so step j's merge folds k pre-reduced entries.
On CPU tensors they run the kernels' plain twins.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from .. import kernels
from ..device import as_tensor, full_fp32, resolve_device
from .index import DBLSHIndex
from ..kernels.ref import slot_d2, take_fill
from .query import merge_dedup_topk

__all__ = ["search_batch_fixed", "validate_engine", "ENGINES"]

ENGINES = ("torch", "kernel", "inline")


def validate_engine(engine: str) -> str:
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}: use " + " | ".join(ENGINES))
    return engine


def _select_blocks(index: DBLSHIndex, G: torch.Tensor, w: float):
    """MINDIST-ordered fixed-capacity block selection for a query batch.

    G: (Q, L, K) query projections.  Returns (blk, bhw), each (L, Q, M):
    block ids (nb = invalid) and per-block window halfwidths — the L∞ box
    distance from the query projection to the block MBR, the smallest
    half width whose window overlaps the block (+inf on invalid slots).

    Ties: the reference's ``lax.top_k`` takes the lowest block index
    among equal scores, and MINDIST ties at exactly 0 are common (every
    block whose MBR contains g scores 0).  ``torch.topk`` promises no tie
    order, so this takes the first M of a stable ascending sort."""
    M = index.params.max_blocks
    nb = index.nb
    half = 0.5 * w
    blks, bhws = [], []
    for li in range(index.params.L):  # one table at a time bounds memory
        lo_, hi_ = index.mbr_lo[li][None], index.mbr_hi[li][None]  # (1, nb, K)
        g = G[:, li, None, :]  # (Q, 1, K)
        overlap = ((lo_ <= g + half) & (hi_ >= g - half)).all(dim=-1)
        # per-dim box distance (at most one term is positive for a valid
        # MBR, so the sum equals the clamped max)
        pd = torch.clamp(lo_ - g, min=0.0) + torch.clamp(g - hi_, min=0.0)
        mindist = torch.sum(torch.square(pd), dim=-1)  # (Q, nb)
        score = torch.where(overlap, mindist, torch.inf)
        blk = torch.sort(score, dim=1, stable=True).indices[:, :M]
        sel_ok = torch.gather(overlap, 1, blk)
        bhw = torch.gather(pd.amax(dim=-1), 1, blk)
        blks.append(torch.where(sel_ok, blk, nb).to(torch.int32))
        bhws.append(torch.where(sel_ok, bhw, torch.inf))
    return torch.stack(blks), torch.stack(bhws)


def _gather_pool(index: DBLSHIndex, blk_q, G, Q, exact: bool):
    """The ``torch`` engine's verify-once stage.

    blk_q: (Qn, S) flattened cross-table block ids (S = L·M, sentinel
    L·nb).  Returns (d2, hw): (Qn, C) squared distances and window
    halfwidths over the C = S·B candidate slots, table-major.  Slots are
    not window-masked — the schedule masks hw per step."""
    p = index.params
    L, M, B, K = p.L, p.max_blocks, p.block_size, p.K
    nb, Qn = index.nb, Q.shape[0]
    proj_flat = index.proj_blocks.reshape(L * nb, B, K)
    pb = take_fill(proj_flat, blk_q, torch.inf)  # (Qn, S, B, K)
    if p.inline_vectors:
        vb = take_fill(index.vec_blocks.reshape(L * nb, B, -1), blk_q, 0.0)
    else:
        ib = take_fill(index.ids_blocks.reshape(L * nb, B), blk_q, index.n)
        vb = take_fill(index.data, ib.reshape(Qn, -1), 0.0).reshape(Qn, L * M, B, -1)
    nrm = take_fill(index.norm_blocks.reshape(L * nb, B), blk_q, torch.inf)
    g_rep = torch.repeat_interleave(G, M, dim=1)  # (Qn, S, K)
    hw = torch.abs(pb - g_rep[:, :, None, :]).amax(dim=-1)  # (Qn, S, B)
    # per-slot multiply + last-axis reduce (not a batched matmul): the
    # reduction order is then independent of the batch shape, so a
    # padded batch stays bit-identical to an unpadded one
    d2 = slot_d2(vb, Q[:, None, None, :], nrm, exact)
    return d2.reshape(Qn, -1), hw.reshape(Qn, -1)


def _fused_bins(index: DBLSHIndex, blk_q, G, Q, halves, engine: str,
                exact: bool, ks: int):
    """Fused verify+bin stage (kernels B1/B2): per-(query, step) top-ks
    bin accumulators instead of the (Qn, C) pool.  Bin j holds the ks
    best distinct (d2, id) pairs among slots first admitted at step j —
    exactly step j's delta, since windows nest — and ``cnt`` (Qn, steps)
    the admitted slots per bin."""
    p = index.params
    L, M, B, K = p.L, p.max_blocks, p.block_size, p.K
    nb, n, Qn = index.nb, index.n, Q.shape[0]
    mode = "exact" if exact else "norm"
    proj_flat = index.proj_blocks.reshape(L * nb, B, K)
    nrm_flat = index.norm_blocks.reshape(L * nb, B)
    ids_flat = index.ids_blocks.reshape(L * nb, B)

    if engine == "inline":
        return kernels.fused_window_search(
            blk_q, halves, proj_flat, index.vec_blocks.reshape(L * nb, B, -1),
            nrm_flat, ids_flat, G, Q, M=M, ks=ks, n=n, mode=mode,
        )

    pb = take_fill(proj_flat, blk_q, torch.inf)
    ib = take_fill(ids_flat, blk_q, n)
    nrm = take_fill(nrm_flat, blk_q, torch.inf)
    if p.inline_vectors:
        vb = take_fill(index.vec_blocks.reshape(L * nb, B, -1), blk_q, 0.0)
    else:
        vb = take_fill(index.data, ib.reshape(Qn, -1), 0.0)
    Ct = M * B
    return kernels.fused_cand_search(
        pb.reshape(Qn, L, Ct, K), vb.reshape(Qn, L, Ct, -1),
        nrm.reshape(Qn, L, Ct), ib.reshape(Qn, L, Ct), halves, G, Q,
        ks=ks, n=n, mode=mode,
    )


def _masked_delta_merge(best_d, best_i, delta, d2, ci, done, n: int, k: int):
    """One schedule-step merge: fold the newly admitted delta slice into
    the running top-k, with finished queries frozen.  The reference skips
    the merge when the delta is empty batch-wide; merging an all-masked
    delta is the identity, and testing for it here would cost a host
    sync per step, so the merge always runs."""
    nd, ni = merge_dedup_topk(best_d, best_i, torch.where(delta, d2, torch.inf),
                              ci, n, k)
    frozen = done[:, None]
    return torch.where(frozen, best_d, nd), torch.where(frozen, best_i, ni)


def search_batch_fixed(
    index: DBLSHIndex,
    Q,
    k: int = 0,
    r0: float = 1.0,
    steps: int = 8,
    engine: str = "torch",
    with_stats: bool = False,
    exact: bool = False,
    termination=None,
    with_explain: bool = False,
    dtype: str = "fp32",
    *,
    device=None,
):
    """Fixed-schedule batched (c,k)-ANN — one-pass incremental probing.

    Args:
      index: built DBLSHIndex on ``device`` (engine 'inline' needs
        params.inline_vectors).
      Q: (Qn, d) query batch (tensor or array).
      k, r0, steps: top-k (0 -> params.k), initial radius, schedule length.
      engine: 'torch' | 'kernel' | 'inline'.
      with_stats: also return per-query probe statistics.
      exact: diff-form distances instead of the norm form.
      termination, with_explain, dtype: only the reference's defaults
        (None, False, 'fp32') are ported so far.
      device: where to run (None -> the CUDA device); the index must lie
        there.

    Returns: (Qn, k) distances ascending, (Qn, k) int32 ids (``n`` when
    unfilled); with ``with_stats`` a third element ``{"radius_steps":
    (Qn,) int32, "candidates": (Qn,) int32}`` — schedule steps run before
    the C2 rule fired, and distinct selected slots fetched while active
    (each selected block counts its B slots once, at the step its window
    first overlaps it).
    """
    validate_engine(engine)
    if termination is not None:
        raise NotImplementedError("termination: C1/C2 early exit is not ported yet (ROADMAP A7)")
    if with_explain:
        raise NotImplementedError("with_explain: explain is not ported yet (ROADMAP A7)")
    if dtype != "fp32":
        raise NotImplementedError(f"dtype={dtype!r}: the quantized path is not ported yet (ROADMAP A14)")
    device = resolve_device(device)
    if index.device.type != device.type:
        raise ValueError(f"index lies on {index.device}, search asked for {device}")
    p = index.params
    if engine == "inline" and not p.inline_vectors:
        raise ValueError("engine 'inline' needs an index built with inline_vectors=True")
    k = k or p.k
    n, nb = index.n, index.nb
    L, M, B = p.L, p.max_blocks, p.block_size
    Q = as_tensor(Q, index.device).contiguous()
    Qn = Q.shape[0]

    # profiler spans named as the reference's named_scopes: a trace of
    # the device time lines up with the four stages by name
    with record_function("dblsh.project"), full_fp32():
        G = torch.einsum("lkd,qd->qlk", index.proj_vecs, Q).contiguous()  # (Qn, L, K)

    # the schedule in float32, by the reference's multiply chain: the
    # admission compares against the bit-identical half widths
    c32, w32 = np.float32(p.c), np.float32(p.w0)
    radii = [np.float32(r0)]
    for _ in range(steps - 1):
        radii.append(radii[-1] * c32)
    halves = [np.float32(0.5) * (w32 * r) for r in radii]

    # select once, at the final radius (windows nest)
    with record_function("dblsh.select"):
        blk, bhw = _select_blocks(index, G, float(w32 * radii[-1]))  # (L, Qn, M)
        offs = (torch.arange(L, dtype=torch.int32, device=Q.device) * nb)[:, None, None]
        blk_q = torch.where(blk < nb, blk + offs, L * nb).transpose(0, 1)
        blk_q = blk_q.reshape(Qn, L * M).contiguous()
        bhw_q = bhw.transpose(0, 1).reshape(Qn, L * M)

    # verify once: the fused bins (kernels B1/B2) or the (Qn, C) pool
    use_bins = engine in ("kernel", "inline")
    with record_function("dblsh.verify"):
        if use_bins:
            halves_t = torch.tensor(np.array(halves, np.float32), device=Q.device)
            bins_d, bins_i, _ = _fused_bins(index, blk_q, G, Q, halves_t, engine, exact, k)
        else:
            ci = take_fill(index.ids_blocks.reshape(L * nb, B), blk_q, n).reshape(Qn, -1)
            d2, hw = _gather_pool(index, blk_q, G, Q, exact)

    with record_function("dblsh.merge"):
        best_d = torch.full((Qn, k), torch.inf, device=Q.device)
        best_i = torch.full((Qn, k), n, dtype=torch.int32, device=Q.device)
        done = torch.zeros((Qn,), dtype=torch.bool, device=Q.device)
        radius_steps = torch.zeros((Qn,), dtype=torch.int32, device=Q.device)
        candidates = torch.zeros((Qn,), dtype=torch.int32, device=Q.device)
        prev_half = -np.inf
        for j in range(steps):
            half = float(halves[j])
            if with_stats:
                active = ~done
                radius_steps += active.to(torch.int32)
                newly = (bhw_q <= half) & (bhw_q > prev_half)
                n_slots = newly.sum(dim=1, dtype=torch.int32) * B
                candidates += torch.where(active, n_slots, 0)
            # on the fused path the step-j delta IS bin j
            if use_bins:
                cd, cids = bins_d[:, j], bins_i[:, j]
                best_d, best_i = _masked_delta_merge(
                    best_d, best_i, torch.isfinite(cd), cd, cids, done, n, k)
            else:
                delta = (hw <= half) & (hw > prev_half)
                best_d, best_i = _masked_delta_merge(
                    best_d, best_i, delta, d2, ci, done, n, k)
            # C2: the k-th best within c·r certifies the answer
            done = done | (best_d[:, k - 1] <= float(np.square(c32 * radii[j])))
            prev_half = half

    if with_stats:
        stats = {"radius_steps": radius_steps, "candidates": candidates}
        return torch.sqrt(best_d), best_i, stats
    return torch.sqrt(best_d), best_i
