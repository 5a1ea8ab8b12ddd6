"""DB-LSH query phase (paper §IV-C, Algorithms 1 & 2).

A (r,c)-NN probe at radius ``r`` materializes, per table i, the
query-centric hypercubic bucket W(G_i(q), w0·r) (Eq. 8) and verifies the
points inside it.  c-ANN runs the radius schedule r = r0, c·r0, ...
(Algorithm 2); (c,k)-ANN stops a query

  * when its k-th best verified distance is <= c·r, or
  * when >= 2tL + k distinct points have been verified, or
  * after ``max_radius_steps`` schedule steps (safety bound).

Each (table, radius) probe fetches at most ``M = params.max_blocks`` STR
blocks (the M whose MBRs lie nearest the query projection) and verifies
at most M·B points; points outside the box are masked to +inf.  A batch
runs the schedule in lockstep with per-query done masks: a done query's
state is frozen, so each query gets the result it would get alone.  No
kernel runs here: this is the paper-faithful path and the independent
oracle of the serving pipeline's nesting contract.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import as_tensor, full_fp32
from ..kernels.ref import merge_dedup_topk, take_fill
from .index import DBLSHIndex

__all__ = ["search", "search_batch", "rc_nn", "probe_radius", "merge_dedup_topk"]


def lexsort(d: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """Per row, ``jnp.lexsort((d, i))``: the order by id, then distance
    (a stable sort on d, then a stable sort on id)."""
    by_d = torch.sort(d, dim=1, stable=True).indices
    by_i = torch.sort(torch.gather(i, 1, by_d), dim=1, stable=True).indices
    return torch.gather(by_d, 1, by_i)


def first_of_group(ids_s: torch.Tensor) -> torch.Tensor:
    """Per row of id-sorted ids, True at the first entry of each id."""
    first = torch.ones_like(ids_s, dtype=torch.bool)
    first[:, 1:] = ids_s[:, 1:] != ids_s[:, :-1]
    return first


def _scan_tables(index: DBLSHIndex, Q: torch.Tensor, G: torch.Tensor, w):
    """Window query W(g, w) against every table, for a batch of queries.

    Per table: the MBR overlap test, the M overlapping blocks of smallest
    MINDIST to g (lowest block index among ties, as ``lax.top_k``), and
    the box test ``lo <= p <= hi`` per slot with ``lo = g - w/2``,
    ``hi = g + w/2`` in float32.  Q: (Qn, d); G: (Qn, L, K); w: float32.
    Returns (d2, ids), each (Qn, L·M·B): diff-form squared distances
    (+inf outside the window) and ids."""
    p = index.params
    M, nb, n = p.max_blocks, index.nb, index.n
    half = float(np.float32(0.5) * np.float32(w))
    Qn = Q.shape[0]
    d2s, idss = [], []
    for li in range(p.L):
        g = G[:, li]  # (Qn, K)
        lo, hi = g - half, g + half
        mbr_lo, mbr_hi = index.mbr_lo[li][None], index.mbr_hi[li][None]  # (1, nb, K)
        overlap = ((mbr_lo <= hi[:, None]) & (mbr_hi >= lo[:, None])).all(dim=-1)
        mindist = torch.sum(torch.square(torch.clamp(mbr_lo - g[:, None], min=0.0)
                                         + torch.clamp(g[:, None] - mbr_hi, min=0.0)), dim=-1)
        score = torch.where(overlap, mindist, torch.inf)  # (Qn, nb)
        blk = torch.sort(score, dim=1, stable=True).indices[:, :M]
        blk = torch.where(torch.gather(overlap, 1, blk), blk, nb)
        pb = take_fill(index.proj_blocks[li], blk, torch.inf)  # (Qn, M, B, K)
        ib = take_fill(index.ids_blocks[li], blk, n)  # (Qn, M, B)
        inbox = ((pb >= lo[:, None, None]) & (pb <= hi[:, None, None])).all(dim=-1)
        inbox = inbox & (ib < n)
        if p.inline_vectors:
            xb = take_fill(index.vec_blocks[li], blk, 0.0)
        else:
            xb = take_fill(index.data, ib.reshape(Qn, -1), 0.0).reshape(ib.shape + (-1,))
        d2 = torch.sum(torch.square(xb - Q[:, None, None, :]), dim=-1)
        d2s.append(torch.where(inbox, d2, torch.inf).reshape(Qn, -1))
        idss.append(ib.reshape(Qn, -1))
    return torch.cat(d2s, dim=1), torch.cat(idss, dim=1)


def _project(index: DBLSHIndex, Q: torch.Tensor) -> torch.Tensor:
    with full_fp32():
        return torch.einsum("lkd,qd->qlk", index.proj_vecs, Q)  # (Qn, L, K)


def probe_radius(index: DBLSHIndex, q, g_all, w):
    """All-L-tables probe of one query at one width ``w``.

    q: (d,) query; g_all: (L, K) its projections; returns flat (d2, ids)
    of shape (L·M·B,), +inf / the slot's id where a slot is outside the
    window."""
    q = as_tensor(q, index.device)
    g_all = as_tensor(g_all, index.device)
    d2, ids = _scan_tables(index, q[None], g_all[None], w)
    return d2[0], ids[0]


def _dedup_merge(best_d2, best_id, new_d2, new_id, n: int, k: int):
    """Merge running top-k rows with freshly verified candidates, dropping
    duplicate ids (the same point found in several tables or radii).

    Returns (Qn, k) squared distances ascending, (Qn, k) ids, and (Qn,)
    the number of distinct ids with a finite distance among ``new``.
    As in the reference, an unfilled slot keeps the id the sort put
    there, not ``n``."""
    d2 = torch.cat([best_d2, new_d2], dim=1)
    ids = torch.cat([best_id.to(torch.int32), new_id.to(torch.int32)], dim=1)
    order = lexsort(d2, ids)
    ids_s, d2_s = torch.gather(ids, 1, order), torch.gather(d2, 1, order)
    valid = first_of_group(ids_s) & (ids_s < n) & torch.isfinite(d2_s)
    d2_s = torch.where(valid, d2_s, torch.inf)

    new_id = new_id.to(torch.int32)
    nord = lexsort(new_d2, new_id)
    nids, nd2 = torch.gather(new_id, 1, nord), torch.gather(new_d2, 1, nord)
    n_verified = (first_of_group(nids) & (nids < n) & torch.isfinite(nd2)).sum(
        dim=1, dtype=torch.int32)

    # lax.top_k: the lowest index among equal distances
    top_d, idx = torch.sort(d2_s, dim=1, stable=True)
    return top_d[:, :k], torch.gather(ids_s, 1, idx[:, :k]), n_verified


def search_batch(index: DBLSHIndex, Q, k: int = 0, r0: float = 1.0):
    """Batched (c,k)-ANN (Algorithm 2 + the §IV-C k-NN rules).

    Every query runs the radius schedule r0, c·r0, ... until its own
    termination rule fires or ``params.max_radius_steps`` steps ran; a
    done query's state is frozen.  The loop stops when every query is
    done, which costs one host sync per step.

    Args:
      index: built DBLSHIndex (on the device the search runs on).
      Q: (Qn, d) queries; k: neighbours (0 -> params.k); r0: initial
        radius (the paper's 1; callers may pass a data-scale estimate).

    Returns: (Qn, k) ascending L2 distances and int32 ids; slots never
    filled hold +inf.
    """
    p = index.params
    k = k or p.k
    n = index.n
    Q = as_tensor(Q, index.device)
    Qn = Q.shape[0]
    dev = Q.device
    G = _project(index, Q)
    c32, w32 = np.float32(p.c), np.float32(p.w0)

    best_d = torch.full((Qn, k), torch.inf, device=dev)
    best_i = torch.full((Qn, k), n, dtype=torch.int32, device=dev)
    nver = torch.zeros((Qn,), dtype=torch.int32, device=dev)
    done = torch.zeros((Qn,), dtype=torch.bool, device=dev)
    r = np.float32(r0)
    for _ in range(p.max_radius_steps):
        if bool(done.all()):
            break
        new_d2, new_id = _scan_tables(index, Q, G, w32 * r)
        nd, ni, n_new = _dedup_merge(best_d, best_i, new_d2, new_id, n, k)
        frozen = done[:, None]
        best_d = torch.where(frozen, best_d, nd)
        best_i = torch.where(frozen, best_i, ni)
        # windows nest across radii: distinct-this-radius is the running
        # distinct total
        nver = torch.where(done, nver, torch.maximum(nver, n_new))
        c2 = float(np.square(c32 * r))
        done = done | (best_d[:, k - 1] <= c2) | (nver >= p.budget)
        r = r * c32
    return torch.sqrt(best_d), best_i


def search(index: DBLSHIndex, q, k: int = 0, r0: float = 1.0):
    """(c,k)-ANN search for a single query (Algorithm 2): q (d,) ->
    (k,) ascending distances and ids."""
    d, i = search_batch(index, as_tensor(q, index.device)[None], k=k, r0=r0)
    return d[0], i[0]


def rc_nn(index: DBLSHIndex, q, r: float, k: int = 1):
    """Single (r,c)-NN probe (Algorithm 1): one window per table at width
    w0·r; returns the best k verified points (+inf / ``n`` when none was
    found — the paper's 'return nothing')."""
    p = index.params
    q = as_tensor(q, index.device)[None]
    d2, ids = _scan_tables(index, q, _project(index, q),
                           np.float32(p.w0) * np.float32(r))
    bd = torch.full((1, k), torch.inf, device=q.device)
    bi = torch.full((1, k), index.n, dtype=torch.int32, device=q.device)
    bd, bi, _ = _dedup_merge(bd, bi, d2, ids, index.n, k)
    return torch.sqrt(bd[0]), bi[0]
