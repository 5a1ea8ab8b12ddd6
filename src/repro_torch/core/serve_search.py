"""Batched fixed-schedule DB-LSH search — the serving path.

Every query runs ``steps`` probes r0, c·r0, …, c^{steps-1}·r0 with
one-pass incremental probing (DESIGN.md §7): windows nest across the
schedule, so the search

  1. projects the queries once (one einsum);
  2. selects blocks once, at the final radius (``_select_blocks``: MBR
     overlap test plus the M smallest MINDIST per table, kernel S1);
  3. verifies every selected slot once, emitting its distance and its
     window halfwidth ``hw = max_k |p_k - g_k|``;
  4. merges, per step, only the slots newly admitted at that step (on
     the fused engines the whole schedule in one launch, kernel M1).

Three verify engines:
  * ``torch``  — plain PyTorch gather + verify into a (Q, C) pool, merged
                 per step (the reference's ``jnp`` engine);
  * ``kernel`` — the fused CUDA kernel B2 on pre-gathered candidates;
  * ``inline`` — the fused CUDA kernel B1 reading the selected blocks in
                 place (needs params.inline_vectors).
The fused engines bin every slot by its first admitting step and keep a
per-(query, step) top-k, so step j's merge folds k pre-reduced entries.
On CPU tensors they run the kernels' plain twins.

``dtype='bf16' | 'int8'`` (DESIGN.md §13) computes the candidate dots
against the index's quantized blocks (kernel B3 on the fused engines, the
same bins in plain PyTorch on ``torch``), keeps a top-4k shortlist per
bin, and re-ranks it in float32 (``_rerank_bins``) before the merges, so
C2 certifies on float32 distances.

``search_batch_fixed_ref`` keeps the multi-pass algorithm (re-select,
re-gather and re-verify at every radius, kernels B6/B7 on its fused
engines): the equivalence oracle of the one-pass pipeline and the
baseline of its speedup.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import kernels
from ..device import as_tensor, full_fp32, resolve_device, upload
from ..obs.trace import get_tracer
from .index import DBLSHIndex
from ..kernels.ref import (
    TERM_C1,
    TERM_C2,
    TERM_EXHAUSTED,
    merge_dedup_topk,
    merge_schedule_ref,
    pool_d2,
    slot_d2,
    take_fill,
)
from .query import first_of_group, lexsort

__all__ = [
    "Termination",
    "search_batch_fixed",
    "search_batch_fixed_ref",
    "search_batch_fixed_dispatch",
    "PendingSearch",
    "validate_engine",
    "validate_dtype",
    "ENGINES",
    "DTYPES",
    "TERM_EXHAUSTED",
    "TERM_C1",
    "TERM_C2",
]

ENGINES = ("torch", "kernel", "inline")
DTYPES = ("fp32", "bf16", "int8")

def validate_engine(engine: str) -> str:
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}: use " + " | ".join(ENGINES))
    return engine


def validate_dtype(dtype: str, params=None, exact: bool = False) -> str:
    """The distance-dtype check of the serving path.

    ``fp32`` is the float32 path.  ``bf16``/``int8`` run the dots on the
    quantized blocks (top-4k shortlist + float32 re-rank), so they need
    an index built with the matching ``params.quant_dtype``; ``exact=True``
    promises bit-equality with the multi-pass oracle, which no quantized
    path can give, so it is refused with them."""
    if dtype not in DTYPES:
        raise ValueError(f"unknown dtype {dtype!r}: use " + " | ".join(DTYPES))
    if dtype != "fp32":
        if exact:
            raise ValueError(
                f"exact=True requires dtype='fp32' (got {dtype!r}): the quantized "
                "path is a shortlist + re-rank, not bit-exact")
        if params is not None and params.quant_dtype != dtype:
            raise ValueError(
                f"dtype={dtype!r} needs an index built with quant_dtype={dtype!r} "
                f"(index has {params.quant_dtype!r}): rebuild, or derive params "
                "with quant_dtype set")
    return dtype


@dataclasses.dataclass(frozen=True)
class Termination:
    """The paper's terminate conditions (§IV-B/§IV-C) as a schedule policy.

    ``termination=None`` keeps the plain fixed schedule: all ``steps``
    radii run, with the C2 rule freezing finished queries' results.  A
    ``Termination`` adds per-query done masks that gate every merge:

    * **C1** (``use_c1``): a query is done once its windows have admitted
      at least ``c1_budget`` verified candidate slots (cross-table
      duplicates included) — the paper's candidate budget; ``0`` derives
      ``2tL + k`` from the index params.
    * **C2** (``use_c2``): a query is done once its k-th best distance is
      ≤ c·r, which certifies a c²-approximate answer at radius r.
    * **early exit** (``early_exit``): the schedule stops as soon as every
      query of the batch is done.  Done queries are frozen, so the exit
      does not change any result; it only skips work.
    """

    use_c1: bool = True
    c1_budget: int = 0  # 0 -> the paper budget 2tL + k from the params
    use_c2: bool = True
    early_exit: bool = True


def _check_engine_index(index: DBLSHIndex, engine: str, device, dtype: str = "fp32"):
    validate_engine(engine)
    device = resolve_device(device)
    if index.device.type != device.type:
        raise ValueError(f"index lies on {index.device}, search asked for {device}")
    # a quantized search reads the quantized blocks, which every layout has
    if engine == "inline" and dtype == "fp32" and not index.params.inline_vectors:
        raise ValueError("engine 'inline' needs an index built with inline_vectors=True")


def _schedule(p, r0: float, steps: int):
    """The schedule in float32, by the reference's multiply chain
    r_{j+1} = r_j · c: radii and half window widths 0.5·(w0·r_j), so
    every admission compares against bit-identical values."""
    c32, w32 = np.float32(p.c), np.float32(p.w0)
    radii = [np.float32(r0)]
    for _ in range(steps - 1):
        radii.append(radii[-1] * c32)
    return radii, [np.float32(0.5) * (w32 * r) for r in radii]


def _c2_bound(p, r) -> float:
    """C2's threshold (c·r)² in float32: the k-th best squared distance
    must not exceed it."""
    return float(np.square(np.float32(p.c) * r))


def _select_blocks(index: DBLSHIndex, G: torch.Tensor, w: float):
    """MINDIST-ordered fixed-capacity block selection for a query batch
    (kernel S1 on the card, its twin ``ref.select_blocks_ref`` on the CPU).

    G: (Q, L, K) query projections.  Returns (blk, bhw), each (L, Q, M):
    block ids (nb = invalid) and per-block window halfwidths — the L∞ box
    distance from the query projection to the block MBR, the smallest
    half width whose window overlaps the block (+inf on invalid slots).
    Ties go to the lowest block index, as the reference's ``lax.top_k``.
    The kernel takes contiguous operands: a shard restored from a split
    snapshot holds strided MBRs, and the multi-pass oracle a strided G."""
    return kernels.select_blocks(index.mbr_lo.contiguous(), index.mbr_hi.contiguous(),
                                 G.contiguous(), 0.5 * w, M=index.params.max_blocks)


def _gather_pool(index: DBLSHIndex, blk_q, G, Q, engine: str, exact: bool):
    """Engine dispatch for the verify-once stage (the reference's pool
    engines).

    blk_q: (Qn, S) flattened cross-table block ids (S = L·M, sentinel
    L·nb).  Returns (d2, hw): (Qn, C) squared distances and window
    halfwidths over the C = S·B candidate slots, table-major.  Slots are
    not window-masked — the schedule masks hw per step.  Engines:
    'inline' runs kernel B4 on the blocks in place (needs
    params.inline_vectors), 'kernel' kernel B5 on the gathered candidates,
    'torch' plain PyTorch.  ``search_batch_fixed`` takes this stage only
    on 'torch'; its kernel engines bin in B1/B2 instead."""
    p = index.params
    L, M, B, K = p.L, p.max_blocks, p.block_size, p.K
    nb, Qn = index.nb, Q.shape[0]
    proj_flat = index.proj_blocks.reshape(L * nb, B, K)
    nrm_flat = index.norm_blocks.reshape(L * nb, B)
    if engine == "inline":
        if not p.inline_vectors:
            raise ValueError("engine 'inline' needs an index built with inline_vectors=True")
        return kernels.window_dist(blk_q, proj_flat, index.vec_blocks.reshape(L * nb, B, -1),
                                   nrm_flat, G, Q, M=M, exact=exact)
    pb = take_fill(proj_flat, blk_q, torch.inf)  # (Qn, S, B, K)
    if p.inline_vectors:
        vb = take_fill(index.vec_blocks.reshape(L * nb, B, -1), blk_q, 0.0)
    else:
        ib = take_fill(index.ids_blocks.reshape(L * nb, B), blk_q, index.n)
        vb = take_fill(index.data, ib.reshape(Qn, -1), 0.0).reshape(Qn, L * M, B, -1)
    nrm = take_fill(nrm_flat, blk_q, torch.inf)
    if engine == "kernel":
        return kernels.candidate_dist(pb.reshape(Qn, L, M * B, K),
                                      vb.reshape(Qn, L, M * B, -1),
                                      nrm.reshape(Qn, L, M * B), G, Q, exact=exact)
    g_rep = torch.repeat_interleave(G, M, dim=1)  # (Qn, S, K)
    hw = torch.abs(pb - g_rep[:, :, None, :]).amax(dim=-1)  # (Qn, S, B)
    # per-slot multiply + last-axis reduce (not a batched matmul): the
    # reduction order is then independent of the batch shape, so a
    # padded batch stays bit-identical to an unpadded one
    d2 = slot_d2(vb, Q[:, None, None, :], nrm, "exact" if exact else "norm")
    return d2.reshape(Qn, -1), hw.reshape(Qn, -1)


def _fused_bins(index: DBLSHIndex, blk_q, G, Q, halves, engine: str,
                exact: bool, dtype: str, ks: int):
    """Fused verify+bin stage: per-(query, step) top-ks bin accumulators
    instead of the (Qn, C) pool.  Bin j holds the ks best distinct (d2, id)
    pairs among slots first admitted at step j — exactly step j's delta,
    since windows nest — and ``cnt`` (Qn, steps) the admitted slots per bin.

    Engines: 'inline' runs B1 on the blocks in place, 'kernel' B2 on the
    gathered candidates (B3 in both, for a quantized dtype: quantized rows
    and their dequant scales in place of the float32 vectors); 'torch'
    lands here only for a quantized dtype and computes the same bins in
    plain PyTorch (the reference's jnp twin of the quantized kernels)."""
    p = index.params
    L, M, B, K = p.L, p.max_blocks, p.block_size, p.K
    nb, n, Qn = index.nb, index.n, Q.shape[0]
    quant = dtype != "fp32"
    mode = dtype if quant else ("exact" if exact else "norm")
    proj_flat = index.proj_blocks.reshape(L * nb, B, K)
    nrm_flat = index.norm_blocks.reshape(L * nb, B)
    ids_flat = index.ids_blocks.reshape(L * nb, B)
    if quant:
        xb = index.qvec_blocks.reshape(L * nb, B, -1)
        xs = index.qvec_scale.reshape(L * nb, B)
    else:
        xb, xs = index.vec_blocks.reshape(L * nb, B, -1), None

    if engine == "inline":
        return kernels.fused_window_search(
            blk_q, halves, proj_flat, xb, nrm_flat, ids_flat, G, Q, M=M, ks=ks, n=n,
            mode=mode, x_scale=xs,
        )

    pb = take_fill(proj_flat, blk_q, torch.inf)
    ib = take_fill(ids_flat, blk_q, n)
    nrm = take_fill(nrm_flat, blk_q, torch.inf)
    sc = None
    if quant:
        vb = take_fill(xb, blk_q, 0)
        sc = take_fill(xs, blk_q, 1.0)
    elif p.inline_vectors:
        vb = take_fill(xb, blk_q, 0.0)
    else:
        vb = take_fill(index.data, ib.reshape(Qn, -1), 0.0)
    Ct = M * B
    if engine == "kernel":
        return kernels.fused_cand_search(
            pb.reshape(Qn, L, Ct, K), vb.reshape(Qn, L, Ct, -1),
            nrm.reshape(Qn, L, Ct), ib.reshape(Qn, L, Ct), halves, G, Q,
            ks=ks, n=n, mode=mode, cand_scale=None if sc is None else sc.reshape(Qn, L, Ct),
        )

    # 'torch' + quantized: the pool, binned, each bin a merge from empty
    g_rep = torch.repeat_interleave(G, M, dim=1)  # (Qn, S, K)
    hw = torch.abs(pb - g_rep[:, :, None, :]).amax(dim=-1).reshape(Qn, -1)
    d2q = pool_d2(vb, Q, nrm, mode, sc).reshape(Qn, -1)
    ci = ib.reshape(Qn, -1)
    steps = halves.shape[0]
    binid = (hw[:, :, None] > halves).sum(dim=-1)  # (Qn, C)
    cnt = torch.stack([(binid == j).sum(dim=1, dtype=torch.int32) for j in range(steps)], 1)
    bd0 = torch.full((Qn, ks), torch.inf, device=Q.device)
    bi0 = torch.full((Qn, ks), n, dtype=torch.int32, device=Q.device)
    bins = [merge_dedup_topk(bd0, bi0, torch.where(binid == j, d2q, torch.inf), ci, n, ks)
            for j in range(steps)]
    return (torch.stack([b[0] for b in bins], 1), torch.stack([b[1] for b in bins], 1), cnt)


def _rerank_bins(index: DBLSHIndex, Q, bins_d, bins_i):
    """Float32 re-rank of the quantized shortlist bins: gather the
    shortlisted rows of ``data`` and recompute their norm-form distances,
    so the merges and C2's ``kth <= c*r`` run on float32 distances.  The
    only loss the quantization leaves is a true neighbour that fell off
    its bin's top-4k shortlist.  Unfilled and invalid slots get +inf."""
    Qn, steps, ks = bins_d.shape
    x = take_fill(index.data, bins_i.reshape(Qn, steps * ks), 0.0)
    x = x.reshape(Qn, steps, ks, -1)
    d2 = slot_d2(x, Q[:, None, None, :], torch.sum(torch.square(x), dim=-1), "norm")
    valid = (bins_i < index.n) & torch.isfinite(bins_d)
    return torch.where(valid, d2, torch.inf)


def search_batch_fixed(
    index: DBLSHIndex,
    Q,
    k: int = 0,
    r0: float = 1.0,
    steps: int = 8,
    engine: str = "torch",
    with_stats: bool = False,
    exact: bool = False,
    termination: Termination | None = None,
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
      exact: diff-form distances instead of the norm form (bit-equal to
        :func:`search_batch_fixed_ref` of the same engine).
      termination: ``None`` runs the plain fixed schedule; a
        :class:`Termination` adds the C1/C2 done masks and early exit.
      with_explain: also return the per-step arrays the stats reduce away
        (implies ``with_stats``).  Results are the same with it on or off.
      dtype: 'fp32' | 'bf16' | 'int8'.  The quantized dtypes run the dots
        on the index's quantized blocks (``params.quant_dtype`` must
        match; kernel B3 on the fused engines), keep a top-4k shortlist
        per schedule bin and re-rank it in float32 before the merges, so
        the returned distances and C2 are float32; only a neighbour that
        fell off its bin's shortlist is lost.
      device: where to run (None -> the CUDA device); the index must lie
        there.

    Returns: (Qn, k) distances ascending, (Qn, k) int32 ids (``n`` when
    unfilled); with ``with_stats`` a third element ``{"radius_steps":
    (Qn,) int32, "candidates": (Qn,) int32}`` — schedule steps run before
    the query was done, and distinct selected slots fetched while active
    (each selected block counts its B slots once, at the step its window
    first overlaps it).  With ``with_explain`` a fourth element::

        {"step_half":    (steps,)    f32  per-step window halfwidths,
         "step_slots":   (Qn, steps) i32  admitted slots per step (rows
                                          sum to ``candidates``),
         "term_cause":   (Qn,)       i32  TERM_EXHAUSTED | TERM_C1 | TERM_C2,
         "final_radius": (Qn,)       f32  radius at termination}
    """
    p = index.params
    validate_dtype(dtype, p, exact)
    _check_engine_index(index, engine, device, dtype)
    if steps < 1:
        raise ValueError(f"steps={steps}: the schedule runs at least one radius")
    with_stats = with_stats or with_explain
    k = k or p.k
    n, nb = index.n, index.nb
    L, M, B = p.L, p.max_blocks, p.block_size
    Q = as_tensor(Q, index.device).contiguous()
    Qn = Q.shape[0]
    dev = Q.device

    # the four stages, named as the reference's named_scopes: spans on the
    # tracer's search lane, and profiler ranges under a session, so a
    # trace of the device time lines up with them by name
    tr = get_tracer()
    with tr.stage("dblsh.project"), full_fp32():
        G = torch.einsum("lkd,qd->qlk", index.proj_vecs, Q).contiguous()  # (Qn, L, K)

    radii, halves = _schedule(p, r0, steps)

    # select once, at the final radius (windows nest)
    with tr.stage("dblsh.select"):
        blk, bhw = _select_blocks(index, G, float(np.float32(p.w0) * radii[-1]))  # (L, Qn, M)
        offs = (torch.arange(L, dtype=torch.int32, device=dev) * nb)[:, None, None]
        blk_q = torch.where(blk < nb, blk + offs, L * nb).transpose(0, 1)
        blk_q = blk_q.reshape(Qn, L * M).contiguous()
        bhw_q = bhw.transpose(0, 1).reshape(Qn, L * M).contiguous() if with_stats else None

    c1_thr = None
    if termination is not None and termination.use_c1:
        c1_thr = termination.c1_budget if termination.c1_budget > 0 else p.budget
    use_c2 = termination is None or termination.use_c2
    early_exit = termination is not None and termination.early_exit

    # verify once: the fused bins (kernels B1/B2, B3 when quantized; every
    # quantized dtype) or the (Qn, C) pool (the 'torch' fp32 path)
    quant = dtype != "fp32"
    use_bins = engine in ("kernel", "inline") or quant
    ks = 4 * k if quant else k  # quantized: a top-4k shortlist per bin
    # per step the half width, C2's bound and the radius
    sched_h = torch.from_numpy(np.array([halves, [_c2_bound(p, r) for r in radii], radii],
                                        np.float32))
    if use_bins or with_explain:
        # staged through pinned memory: a pageable copy would make the host
        # wait for the card here, and the search must not wait
        sched = upload(sched_h, dev)
        halves_t = sched[0]
    with tr.stage("dblsh.verify"):
        if use_bins:
            bins_d, bins_i, bin_cnt = _fused_bins(index, blk_q, G, Q, halves_t, engine,
                                                  exact, dtype, ks)
            if quant:
                bins_d = _rerank_bins(index, Q, bins_d, bins_i)
            # C1's admitted count at step j is the slots of bins 0..j
            cum_adm = torch.cumsum(bin_cnt, dim=1) if c1_thr is not None else None
        else:
            ci = take_fill(index.ids_blocks.reshape(L * nb, B), blk_q, n).reshape(Qn, -1)
            d2, hw = _gather_pool(index, blk_q, G, Q, "torch", exact)

    kw = dict(k=k, n=n, B=B, c1_thr=c1_thr, use_c2=use_c2, early_exit=early_exit,
              with_stats=with_stats, with_explain=with_explain)
    with tr.stage("dblsh.merge") as merge_span:
        if use_bins and bins_d.is_cuda:
            # the whole schedule in one launch (kernel M1): the host reads
            # nothing, early exit included
            best_d, best_i, stats = kernels.merge_schedule(bins_d, bins_i, bhw_q, cum_adm,
                                                           sched, **kw)
            span = {"steps": steps, "syncs": 0, "kernel": 1}
        else:
            # the twin's step loop: on the CPU, and on the 'torch' fp32
            # engine's (Qn, C) pool, whose bin j is the pool's slots newly
            # inside step j's window
            if not use_bins:
                bins_d, bins_i, cum_adm = _pool_bins(d2, hw, ci, sched_h[0].tolist(),
                                                     c1_thr is not None)
            best_d, best_i, stats, span = merge_schedule_ref(bins_d, bins_i, bhw_q, cum_adm,
                                                             sched_h, **kw)
        if merge_span:
            merge_span.set(**span)

    out = (torch.sqrt(best_d), best_i)
    if with_stats:
        out += ({"radius_steps": stats["radius_steps"], "candidates": stats["candidates"]},)
    if with_explain:
        out += ({"step_half": halves_t, "step_slots": stats["step_slots"],
                 "term_cause": stats["term_cause"], "final_radius": stats["final_radius"]},)
    return out


def _pool_bins(d2, hw, ci, halves, with_c1: bool):
    """The (Qn, C) pool as per-step bins: (bins_d, bins_i) (Qn, S, C),
    bin j the pool's slots with ``halves[j-1] < hw <= halves[j]`` (the
    rest +inf), and C1's admitted count (Qn, S) when ``with_c1``: the
    finite slots with hw <= halves[j], since the windows nest."""
    edges = [-math.inf, *halves]
    delta = torch.stack([(hw <= hi) & (hw > lo) for lo, hi in zip(edges, edges[1:])], dim=1)
    bins_d = torch.where(delta, d2[:, None], torch.inf)
    bins_i = ci[:, None].expand(bins_d.shape)
    cum_adm = torch.isfinite(bins_d).sum(dim=2).cumsum(dim=1) if with_c1 else None
    return bins_d, bins_i, cum_adm


def _merge_dedup_topk_lexsort(run_d, run_i, new_d, new_i, n: int, k: int):
    """(Q, a) + (Q, b) -> (Q, k) dedup'd ascending merge: the multi-pass
    oracle's merge, with the reference's tie order.  Ordered by id, then
    distance, the first entry of each id group is its best distance;
    ``lax.top_k`` then takes the lowest index among equal distances: the
    first k of a stable ascending sort."""
    d = torch.cat([run_d, new_d], dim=1)
    i = torch.cat([run_i.to(torch.int32), new_i.to(torch.int32)], dim=1)
    order = lexsort(d, i)
    ids_s = torch.gather(i, 1, order)
    d_s = torch.where(first_of_group(ids_s) & (ids_s < n), torch.gather(d, 1, order),
                      torch.inf)
    top_d, idx = torch.sort(d_s, dim=1, stable=True)
    top_d, idx = top_d[:, :k], idx[:, :k]
    ids = torch.gather(ids_s, 1, idx)
    return top_d, torch.where(torch.isfinite(top_d), ids, n)


def _verify_table(index: DBLSHIndex, li: int, blk, g, Q, w, engine: str, k: int):
    """One table of one multi-pass step: the k best distinct in-window
    (d2, id) pairs of its selected blocks.  blk: (Qn, M) block ids
    (``nb`` = invalid); g: (Qn, K); w: float32 window width."""
    p = index.params
    n = index.n
    if engine == "inline":
        return kernels.window_verify(blk, index.proj_blocks[li], index.vec_blocks[li],
                                     index.ids_blocks[li], g, Q, w, n=n, k=k)
    Qn, M = blk.shape
    B, K = p.block_size, p.K
    pb = take_fill(index.proj_blocks[li], blk, torch.inf)  # (Qn, M, B, K)
    ib = take_fill(index.ids_blocks[li], blk, n)
    if p.inline_vectors:
        vb = take_fill(index.vec_blocks[li], blk, 0.0)
    else:
        vb = take_fill(index.data, ib.reshape(Qn, -1), 0.0)
    cp, cv, ci = pb.reshape(Qn, M * B, K), vb.reshape(Qn, M * B, -1), ib.reshape(Qn, M * B)
    if engine == "kernel":
        return kernels.candidate_verify(cp, cv, ci, g, Q, w, n=n, k=k)
    # 'torch': the reference's jnp engine, lax.top_k's lowest-index ties
    inbox = (torch.abs(cp - g[:, None, :]) <= float(np.float32(0.5) * w)).all(dim=-1)
    d2 = torch.where(inbox & (ci < n), slot_d2(cv, Q[:, None, :], None, "exact"), torch.inf)
    d_l, idx = torch.sort(d2, dim=1, stable=True)
    d_l, idx = d_l[:, :k], idx[:, :k]
    return d_l, torch.where(torch.isfinite(d_l), torch.gather(ci, 1, idx), n)


def search_batch_fixed_ref(
    index: DBLSHIndex,
    Q,
    k: int = 0,
    r0: float = 1.0,
    steps: int = 8,
    engine: str = "torch",
    with_stats: bool = False,
    *,
    device=None,
):
    """Multi-pass reference: re-select, re-gather and re-verify at every
    radius (the serving algorithm before one-pass probing).

    The oracle of :func:`search_batch_fixed` (``exact=True`` gives
    bit-equal results on the same engine) and the baseline of its
    speedup.  Each step runs, per table, the engine's verify — kernel B6
    (``inline``) or B7 (``kernel``), or plain torch — so the fused
    engines launch L·steps kernels per search.  ``with_stats`` keeps the
    multi-pass accounting: every selected block slot recounts at every
    step it remains selected.

    Returns: (Qn, k) distances ascending, (Qn, k) int32 ids (``n`` when
    unfilled), and with ``with_stats`` ``{"radius_steps", "candidates"}``.
    """
    _check_engine_index(index, engine, device)
    p = index.params
    k = k or p.k
    n, nb, B = index.n, index.nb, p.block_size
    Q = as_tensor(Q, index.device).contiguous()
    Qn = Q.shape[0]
    dev = Q.device

    # the one-pass search's span names, so one trace reads both paths
    tr = get_tracer()
    with tr.stage("dblsh.project"), full_fp32():
        G = torch.einsum("lkd,qd->qlk", index.proj_vecs, Q)  # (Qn, L, K)
    best_d = torch.full((Qn, k), torch.inf, device=dev)
    best_i = torch.full((Qn, k), n, dtype=torch.int32, device=dev)
    done = torch.zeros((Qn,), dtype=torch.bool, device=dev)
    radius_steps = torch.zeros((Qn,), dtype=torch.int32, device=dev)
    candidates = torch.zeros((Qn,), dtype=torch.int32, device=dev)

    radii, _ = _schedule(p, r0, steps)
    for r in radii:
        w = np.float32(p.w0) * r
        with tr.stage("dblsh.select"):
            blk, _ = _select_blocks(index, G, float(w))  # (L, Qn, M)
        if with_stats:
            active = ~done
            radius_steps += active.to(torch.int32)
            n_slots = (blk < nb).sum(dim=(0, 2), dtype=torch.int32) * B
            candidates += torch.where(active, n_slots, 0)

        step_d = torch.full((Qn, k), torch.inf, device=dev)
        step_i = torch.full((Qn, k), n, dtype=torch.int32, device=dev)
        for li in range(p.L):
            with tr.stage("dblsh.verify"):
                d_l, i_l = _verify_table(index, li, blk[li].contiguous(),
                                         G[:, li].contiguous(), Q, float(w), engine, k)
            with tr.stage("dblsh.merge"):
                step_d, step_i = _merge_dedup_topk_lexsort(step_d, step_i, d_l, i_l, n, k)

        # masked merge: finished queries keep their result
        with tr.stage("dblsh.merge"):
            nd, ni = _merge_dedup_topk_lexsort(best_d, best_i, step_d, step_i, n, k)
            best_d = torch.where(done[:, None], best_d, nd)
            best_i = torch.where(done[:, None], best_i, ni)
            done = done | (best_d[:, k - 1] <= _c2_bound(p, r))

    if with_stats:
        stats = {"radius_steps": radius_steps, "candidates": candidates}
        return torch.sqrt(best_d), best_i, stats
    return torch.sqrt(best_d), best_i


class PendingSearch:
    """Handle for a started, not yet awaited ``search_batch_fixed`` call.

    PyTorch launches CUDA work asynchronously: the search returns tensors
    whose values the card may still be computing.  The handle records a
    CUDA event after the search on the current stream, so a serving loop
    can do host work for the next batch before it waits:

        pending = search_batch_fixed_dispatch(index, Q, k=10)
        ...host work for the next batch...
        dists, ids = pending.result()        # the first host sync

    On the CPU the work is done when the call returns: ``ready()`` is
    always true.  On the card the fused engines' merge (kernel M1) reads
    nothing on the host, early exit included: each query stops at its own
    done step.  Only the 'torch' fp32 engine's merge loop still reads the
    done mask once a step under ``termination.early_exit``.
    """

    __slots__ = ("dists", "ids", "stats", "explain", "_event")

    def __init__(self, dists, ids, stats=None, explain=None, event=None):
        self.dists = dists
        self.ids = ids
        self.stats = stats
        self.explain = explain  # per-step arrays on the device, or None
        self._event = event

    def ready(self) -> bool:
        """True once the search's work on the card is complete (never
        blocks)."""
        return self._event is None or self._event.query()

    def result(self):
        """Block until complete; returns (dists, ids[, stats])."""
        if self._event is not None:
            self._event.synchronize()
        if self.stats is not None:
            return self.dists, self.ids, self.stats
        return self.dists, self.ids


def search_batch_fixed_dispatch(
    index: DBLSHIndex,
    Q,
    k: int = 0,
    r0: float = 1.0,
    steps: int = 8,
    engine: str = "torch",
    with_stats: bool = False,
    exact: bool = False,
    termination: Termination | None = None,
    with_explain: bool = False,
    dtype: str = "fp32",
    *,
    device=None,
) -> PendingSearch:
    """Start a fixed-schedule search without waiting for the card.

    Same arguments and numerics as :func:`search_batch_fixed` (it runs
    that very call, so its results are bit-equal to the synchronous
    path); ``result()`` of the returned :class:`PendingSearch` is the only
    wait on the fused engines.  On the 'torch' fp32 engine with
    ``termination.early_exit`` the call itself reads the done mask once
    per step, so it returns only after the schedule's last step was
    enqueued."""
    out = search_batch_fixed(
        index, Q, k=k, r0=r0, steps=steps, engine=engine, with_stats=with_stats,
        exact=exact, termination=termination, with_explain=with_explain, dtype=dtype,
        device=device,
    )
    event = None
    if out[0].is_cuda:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(out[0].device))
    return PendingSearch(*out, event=event)
