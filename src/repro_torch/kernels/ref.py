"""Plain PyTorch twins of the CUDA kernels (the ``ref.py`` contract).

Each twin computes what its kernel computes.  The wrappers in ``ops.py``
take the twin for tensors on the CPU, the tests hold the twins against
the reference's Pallas kernels, and ``chip_smoke.py`` holds each kernel
against its twin on the card.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "QUANT_MODES",
    "TERM_EXHAUSTED",
    "TERM_C1",
    "TERM_C2",
    "topk_rounds",
    "merge_topk",
    "merge_dedup_topk",
    "masked_delta_merge",
    "merge_schedule_ref",
    "quantize_query",
    "slot_d2",
    "pool_d2",
    "take_fill",
    "bins_from_pool",
    "fused_search_ref",
    "fused_window_search_ref",
    "fused_cand_search_ref",
    "window_verify_ref",
    "candidate_verify_ref",
    "window_dist_ref",
    "candidate_dist_ref",
    "pairwise_l2_ref",
    "select_blocks_ref",
]

IMAX = 2**31 - 1
QUANT_MODES = ("bf16", "int8")
#: ``explain["term_cause"]`` codes: why a query's schedule stopped
#: advancing.  C2 wins ties with C1 on the same step, as in the order of
#: the done-mask updates.
TERM_EXHAUSTED, TERM_C1, TERM_C2 = 0, 1, 2


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


def masked_delta_merge(best_d, best_i, delta, d2, ci, done, n: int, k: int):
    """One schedule-step merge: fold the newly admitted delta slice into
    the running top-k, with finished queries frozen.  The reference skips
    the merge when the delta is empty batch-wide; merging an all-masked
    delta is the identity, and testing for it here would cost a host
    sync per step, so the merge always runs."""
    nd, ni = merge_dedup_topk(best_d, best_i, torch.where(delta, d2, torch.inf),
                              ci, n, k)
    frozen = done[:, None]
    return torch.where(frozen, best_d, nd), torch.where(frozen, best_i, ni)


def merge_schedule_ref(bins_d, bins_i, bhw, cum_adm, sched, *, k: int, n: int, B: int,
                       c1_thr=None, use_c2: bool = True, early_exit: bool = False,
                       with_stats: bool = False, with_explain: bool = False):
    """Twin of the merge schedule kernel (M1): the one-pass search's
    per-step merges of its fused bins, with the stats and the C2 then C1
    done marks, step by step in eager PyTorch.

    bins_d/bins_i: (Q, S, kb) bin j's (d2, id) pairs, the slots first
    admitted at step j (non-finite d2 never enter); bhw: (Q, T) the
    selected blocks' window halfwidths (``with_stats``), else None;
    cum_adm: (Q, S) int64 admitted slots of bins 0..j, given with
    ``c1_thr`` (C1's budget); sched: (3, S) f32 per step the half width,
    C2's bound (c·r)² and the radius; k, n, B: top-k, the id of unfilled
    slots, slots a block.  ``early_exit`` reads the done mask on the host
    before every step but the first and stops once every query is done;
    done queries are frozen, so the exit changes no result.

    Returns (best_d, best_i, stats, span): (Q, k) squared distances
    ascending and int32 ids (``n`` unfilled); stats None, or
    {"radius_steps", "candidates"} (Q,) int32 and, with ``with_explain``,
    "step_slots" (Q, S) int32, "term_cause" (Q,) int32 and "final_radius"
    (Q,) f32; span {"steps": steps merged, "syncs": host reads of the done
    mask}."""
    with_stats = with_stats or with_explain
    Qn, steps = bins_d.shape[:2]
    dev = bins_d.device
    halves, c2_bounds, radii = sched.tolist()
    best_d = torch.full((Qn, k), torch.inf, device=dev)
    best_i = torch.full((Qn, k), n, dtype=torch.int32, device=dev)
    done = torch.zeros((Qn,), dtype=torch.bool, device=dev)
    radius_steps = torch.zeros((Qn,), dtype=torch.int32, device=dev)
    candidates = torch.zeros((Qn,), dtype=torch.int32, device=dev)
    if with_explain:
        step_slots = torch.zeros((Qn, steps), dtype=torch.int32, device=dev)
        term_cause = torch.full((Qn,), TERM_EXHAUSTED, dtype=torch.int32, device=dev)
        final_radius = torch.zeros((Qn,), dtype=torch.float32, device=dev)

    def mark(fired, cause, r):
        """Fold one rule's firing into the done mask (and the explain
        record: the first rule to fire names the cause)."""
        nonlocal done, term_cause, final_radius
        if with_explain:
            newly = fired & ~done
            term_cause = torch.where(newly, cause, term_cause)
            final_radius = torch.where(newly, float(r), final_radius)
        done = done | fired

    prev_half = -math.inf
    ran = syncs = 0  # steps merged, host syncs made (counted, not waited on)
    for j in range(steps):
        # early exit: stop once every query is done.  Reading the mask
        # is one host sync per step; done queries are frozen, so the
        # exit never changes a result
        if early_exit and j > 0:
            syncs += 1
            if bool(done.all()):
                break
        ran += 1
        half = halves[j]
        if with_stats:
            active = ~done
            radius_steps += active.to(torch.int32)
            newly = (bhw <= half) & (bhw > prev_half)
            n_slots = torch.where(active, newly.sum(dim=1, dtype=torch.int32) * B, 0)
            candidates += n_slots
            if with_explain:
                step_slots[:, j] = n_slots
        # the step-j delta IS bin j
        cd, cids = bins_d[:, j], bins_i[:, j]
        best_d, best_i = masked_delta_merge(
            best_d, best_i, torch.isfinite(cd), cd, cids, done, n, k)
        # C2: the k-th best within c·r certifies the answer
        if use_c2:
            mark(best_d[:, k - 1] <= c2_bounds[j], TERM_C2, radii[j])
        # C1: admitted slots with a finite distance (verified work)
        if c1_thr is not None:
            mark(cum_adm[:, j] >= c1_thr, TERM_C1, radii[j])
        prev_half = half

    stats = None
    if with_stats:
        stats = {"radius_steps": radius_steps, "candidates": candidates}
    if with_explain:
        # queries still running at the end stopped at the final radius
        final_radius = torch.where(term_cause == TERM_EXHAUSTED, float(radii[-1]),
                                   final_radius)
        stats.update(step_slots=step_slots, term_cause=term_cause, final_radius=final_radius)
    return best_d, best_i, stats, {"steps": ran, "syncs": syncs}


def quantize_query(q: torch.Tensor, mode: str):
    """Query-side operand of a distance mode (the reference's
    ``ops._quantize_query``): (qv, qs), the query in the mode's dtype and
    its (Q, 1) float32 dequant scale.

    bf16: round to nearest even, scale all-ones.  int8: symmetric per
    query, ``qs = amax(|q|) / 127`` (1.0 on all-zero rows), ``round``
    half to even, clipped to ±127.  Other modes: (q, None)."""
    if mode == "bf16":
        return q.to(torch.bfloat16), torch.ones((q.shape[0], 1), dtype=torch.float32,
                                                device=q.device)
    if mode == "int8":
        amax = q.abs().amax(dim=-1, keepdim=True)
        qs = torch.where(amax > 0.0, amax / 127.0, 1.0)
        qv = torch.clamp(torch.round(q / qs), -127.0, 127.0).to(torch.int8)
        return qv, qs
    return q, None


def slot_d2(x: torch.Tensor, q: torch.Tensor, nrm, mode: str, *, q2=None,
            xscale=None, qscale=None):
    """Per-slot squared distances over the last axis.

    ``exact``: diff form sum((x - q)^2).  ``norm``: max(||x||^2 - 2<q,x> +
    ||q||^2, 0) with the squared norms ``nrm`` precomputed (+inf norms
    poison padded slots).  The dot is a per-slot multiply plus last-axis
    reduce, not a batched matmul: its order then does not depend on the
    batch shape.  ``q`` broadcasts against ``x``.

    ``bf16`` / ``int8`` (kernel B3): x and q are quantized; only the dot
    is reduced precision — bf16 products summed in float32 (each product
    is exact in float32), int8 products summed in integers (exact) — then
    max(nrm - 2 * ((xscale * qscale) * dot) + q2, 0) in that order, with
    ``q2`` the squared norm of the float32 query."""
    if mode == "exact":
        return torch.sum(torch.square(x - q), dim=-1)
    if mode == "norm":
        q2 = torch.sum(torch.square(q), dim=-1)
        dots = torch.sum(x * q, dim=-1)
        return torch.clamp(nrm - 2.0 * dots + q2, min=0.0)
    if mode == "bf16":
        dots = torch.sum(x.float() * q.float(), dim=-1)
    elif mode == "int8":
        dots = torch.sum(x.to(torch.int32) * q.to(torch.int32), dim=-1).to(torch.float32)
    else:
        raise ValueError(f"unknown distance mode {mode!r}")
    return torch.clamp(nrm - 2.0 * ((xscale * qscale) * dots) + q2, min=0.0)


def pool_d2(x: torch.Tensor, q: torch.Tensor, nrm, mode: str, scale=None):
    """Squared distances of a (Q, ..., d) candidate pool to the float32
    queries q (Q, d) in a distance mode; the quantized modes quantize q
    as the kernels' wrappers do and take the slots' dequant ``scale``
    (Q, ...)."""
    shape = (q.shape[0],) + (1,) * (x.dim() - 2)
    if mode not in QUANT_MODES:
        return slot_d2(x, q.reshape(shape + (-1,)), nrm, mode)
    qv, qs = quantize_query(q, mode)
    q2 = torch.sum(torch.square(q), dim=-1)
    return slot_d2(x, qv.reshape(shape + (-1,)), nrm, mode, q2=q2.reshape(shape),
                   xscale=scale, qscale=qs.reshape(shape))


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


#: the reference's name for the pool oracle of the fused kernels' bins
fused_search_ref = bins_from_pool


def take_fill(table: torch.Tensor, idx: torch.Tensor, fill):
    """``table[idx]`` along axis 0 with ``fill`` where idx is out of range.

    ``fill`` is a Python number of the table's kind (an int for an
    integer table), so the result keeps the table's dtype; it goes to
    ``torch.where`` as a scalar, never as a CPU tensor, which ``where``
    would copy to the card with a host wait."""
    valid = (idx >= 0) & (idx < table.shape[0])
    out = table[torch.where(valid, idx, 0).long()]
    valid = valid.reshape(valid.shape + (1,) * (table.dim() - 1))
    return torch.where(valid, out, fill)


def fused_window_search_ref(blk_idx, halves, proj_blocks, x_blocks, norm_blocks,
                            ids_blocks, g, q, *, M: int, ks: int, n: int,
                            mode: str = "norm", x_scale=None):
    """Twin of the fused window kernel: gather the selected blocks of the
    flattened (L*nb) axis (invalid ids >= L*nb gather +inf projections,
    so they never admit; quantized rows gather 0, their scales 1.0), then
    bin the pool."""
    Qn, S = blk_idx.shape
    pb = take_fill(proj_blocks, blk_idx, torch.inf)  # (Q, S, B, K)
    vb = take_fill(x_blocks, blk_idx, 0)  # (Q, S, B, d)
    nrm = take_fill(norm_blocks, blk_idx, torch.inf)  # (Q, S, B)
    ib = take_fill(ids_blocks, blk_idx, n)
    xs = None if x_scale is None else take_fill(x_scale, blk_idx, 1.0)
    g_rep = torch.repeat_interleave(g, M, dim=1)  # (Q, S, K)
    hw = torch.abs(pb - g_rep[:, :, None, :]).amax(dim=-1)
    d2 = pool_d2(vb, q, nrm, mode, xs)
    return bins_from_pool(d2.reshape(Qn, -1), hw.reshape(Qn, -1),
                          ib.reshape(Qn, -1), halves, n, ks)


def fused_cand_search_ref(cand_proj, cand_x, cand_norms, cand_ids, halves, g, q,
                          *, ks: int, n: int, mode: str = "norm", cand_scale=None):
    """Twin of the fused gathered kernel over (Q, L, Ct, ·) candidates;
    +inf projections keep invalid slots out of every bin."""
    Qn = cand_proj.shape[0]
    hw = torch.abs(cand_proj - g[:, :, None, :]).amax(dim=-1)  # (Q, L, Ct)
    d2 = pool_d2(cand_x, q, cand_norms, mode, cand_scale)
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
    d2 = slot_d2(cand_vecs, q[:, None, :], None, "exact")
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


def candidate_dist_ref(cand_proj, cand_vecs, cand_norms, g, q, *, exact: bool = False):
    """Twin of the gathered distance kernel (B5): per slot of (Q, L, Ct)
    candidates, the window halfwidth ``hw = max_k |p_k - g_k|`` against
    its table's projection and the squared distance (norm form, or the
    diff form with ``exact``), flattened table-major to (Q, L*Ct) each.
    +inf projections give hw = +inf; +inf norms give d2 = +inf in norm
    form, while the diff form computes the slot's real distance.

    cand_proj: (Q, L, Ct, K); cand_vecs: (Q, L, Ct, d); cand_norms:
    (Q, L, Ct); g: (Q, L, K); q: (Q, d)."""
    Qn = cand_proj.shape[0]
    hw = torch.abs(cand_proj - g[:, :, None, :]).amax(dim=-1)
    d2 = pool_d2(cand_vecs, q, cand_norms, "exact" if exact else "norm")
    return d2.reshape(Qn, -1), hw.reshape(Qn, -1)


def window_dist_ref(blk_idx, proj_blocks, vec_blocks, norm_blocks, g, q, *, M: int,
                    exact: bool = False):
    """Twin of the in-place distance kernel (B4): gather the selected
    blocks of the flattened (L*nb) axis, then :func:`candidate_dist_ref`
    per slot, slot s belonging to table s // M.  A slot of an invalid
    block (id outside [0, L*nb)) gets d2 = hw = +inf in both forms, as
    the reference's kernel writes it (its jnp oracle leaves a finite
    diff-form d2 there).  Returns d2, hw: (Q, S*B) each."""
    Qn, S = blk_idx.shape
    valid = (blk_idx >= 0) & (blk_idx < proj_blocks.shape[0])
    pb = take_fill(proj_blocks, blk_idx, torch.inf)  # (Q, S, B, K)
    vb = take_fill(vec_blocks, blk_idx, 0.0)  # (Q, S, B, d)
    nrm = take_fill(norm_blocks, blk_idx, torch.inf)  # (Q, S, B)
    g_rep = torch.repeat_interleave(g, M, dim=1)  # (Q, S, K)
    hw = torch.abs(pb - g_rep[:, :, None, :]).amax(dim=-1)
    d2 = pool_d2(vb, q, nrm, "exact" if exact else "norm")
    d2 = torch.where(valid[:, :, None], d2, torch.inf)
    return d2.reshape(Qn, -1), hw.reshape(Qn, -1)


def pairwise_l2_ref(Q: torch.Tensor, X: torch.Tensor):
    """Twin of the squared-distance matrix kernel (B8):
    ``max(||q||^2 - 2 q.x + ||x||^2, 0)`` (nq, nn) in float32, computed on
    the inputs widened to float32 (a bf16 x bf16 product is exact there).
    Run it with TF32 off on the card."""
    Q, X = Q.float(), X.float()
    qn = torch.sum(torch.square(Q), dim=-1, keepdim=True)
    xn = torch.sum(torch.square(X), dim=-1)
    return torch.clamp(qn - 2.0 * (Q @ X.T) + xn, min=0.0)


def select_blocks_ref(mbr_lo, mbr_hi, g, half: float, *, M: int):
    """Twin of the block selection kernel (S1): MINDIST-ordered
    fixed-capacity selection for a query batch.

    mbr_lo, mbr_hi: (L, nb, K) block bounding boxes; g: (Q, L, K) query
    projections; half: the window's half width.  Returns (blk, bhw), each
    (L, Q, M): per table and query the M blocks of smallest MINDIST among
    those whose box overlaps the window (``nb`` where fewer overlap) and
    their L∞ box distances to g (+inf on those slots).

    Ties: the reference's ``lax.top_k`` takes the lowest block index
    among equal scores, and MINDIST ties at exactly 0 are common (every
    block whose MBR contains g scores 0).  ``torch.topk`` promises no tie
    order, so this takes the first M of a stable ascending sort.  On the
    card, MINDIST's sum runs in torch's order for a contiguous last
    dimension, which the kernel follows (``csrc/select.cu``)."""
    nb = mbr_lo.shape[1]
    blks, bhws = [], []
    for li in range(mbr_lo.shape[0]):  # one table at a time bounds memory
        lo_, hi_ = mbr_lo[li][None], mbr_hi[li][None]  # (1, nb, K)
        gl = g[:, li, None, :]  # (Q, 1, K)
        overlap = ((lo_ <= gl + half) & (hi_ >= gl - half)).all(dim=-1)
        # per-dim box distance (at most one term is positive for a valid
        # MBR, so the sum equals the clamped max)
        pd = torch.clamp(lo_ - gl, min=0.0) + torch.clamp(gl - hi_, min=0.0)
        mindist = torch.sum(torch.square(pd), dim=-1)  # (Q, nb)
        score = torch.where(overlap, mindist, torch.inf)
        blk = torch.sort(score, dim=1, stable=True).indices[:, :M]
        sel_ok = torch.gather(overlap, 1, blk)
        bhw = torch.gather(pd.amax(dim=-1), 1, blk)
        blks.append(torch.where(sel_ok, blk, nb).to(torch.int32))
        bhws.append(torch.where(sel_ok, bhw, torch.inf))
    return torch.stack(blks), torch.stack(bhws)
