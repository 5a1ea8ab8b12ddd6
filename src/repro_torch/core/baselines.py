"""Competitor/baseline methods the paper compares against (§VI-A).

* ``brute_force``   — exact k-NN oracle (ground truth for recall/ratio).
* ``FBLSH``         — the paper's own ablation: identical (K,L)-index but
                      *fixed* (query-oblivious) bucketing. Isolates the
                      value of query-centric dynamic buckets.
* ``MQIndex``       — dynamic metric-query scheme (PM-LSH/SRS family):
                      one m-dim projected space, candidates = beta*n
                      nearest in the projected space, verified exactly.
* ``C2Index``       — collision-counting scheme (QALSH family): m one-dim
                      projections, candidates = points colliding on >= l
                      projections at query-centric width w.

These are compact but faithful reimplementations of the *schemes* (the
candidate-generation rules and cost profiles), which is what the paper's
comparison exercises.

Each ``build(generator, data, ...)`` draws its hash functions from a
``torch.Generator`` and places the index on ``device`` (the CUDA device
when None); ``from_arrays`` makes an index from given arrays (for example
the reference's) and its meta fields.  Every top-k keeps the reference's
tie order, the lowest position first, through stable sorts
(``torch.topk`` promises no order among equal values).  Large batches are
taken in query chunks, which changes no result.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import as_tensor, full_fp32, resolve_device
from . import hashing

__all__ = ["brute_force", "FBLSH", "MQIndex", "C2Index"]

# elements of a chunk's largest temporary (a (queries, candidates, d)
# gather or a (queries, n, K) code comparison)
_CHUNK_ELEMS = 1 << 26


def brute_force(data, Q, k: int = 50, *, device=None):
    """Exact k-NN via ||q||^2 - 2 q.x + ||x||^2 (full fp32).
    Returns (dists, ids) of shape (Qn, k), ids int64."""
    device = resolve_device(device)
    data = as_tensor(data, device)
    Q = as_tensor(Q, device)
    qn = torch.sum(torch.square(Q), dim=-1, keepdim=True)
    xn = torch.sum(torch.square(data), dim=-1)
    with full_fp32():
        d2 = torch.clamp(qn - 2.0 * Q @ data.T + xn, min=0.0)
    neg, ids = torch.topk(-d2, k, dim=1)
    return torch.sqrt(-neg), ids


def _rows_per_chunk(per_row: int) -> int:
    return max(1, _CHUNK_ELEMS // max(per_row, 1))


def _smallest(d: torch.Tensor, k: int) -> torch.Tensor:
    """Positions of each row's k smallest values, ties to the lowest
    position: ``lax.top_k`` over ``-d``."""
    return torch.sort(d, dim=1, stable=True).indices[:, :k]


def _first_hits(hit: torch.Tensor, cap: int) -> torch.Tensor:
    """Each row's first ``cap`` hit positions in ascending order, padded
    with n (the row length): ``sort(where(hit, arange(n), n))[:cap]``."""
    A, n = hit.shape
    cap = min(cap, n)
    pos = torch.cumsum(hit, dim=1) - 1
    keep = hit & (pos < cap)
    out = torch.full((A, cap + 1), n, dtype=torch.int64, device=hit.device)
    cols = torch.arange(n, device=hit.device).expand(A, n)
    # every dropped position writes to the spare column cap
    out.scatter_(1, torch.where(keep, pos, cap), torch.where(keep, cols, n))
    return out[:, :cap]


def _exact_d2(data: torch.Tensor, cand: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """Diff-form squared distances of each query to its candidates; +inf
    where a candidate is the padding n."""
    n = data.shape[0]
    xb = data[cand.clamp(max=n - 1)]
    d2 = torch.sum(torch.square(xb - Q[:, None, :]), dim=-1)
    return torch.where(cand < n, d2, torch.inf)


def _chunked(Q: torch.Tensor, per_row: int, fn):
    """``fn`` over query chunks, the outputs concatenated."""
    step = _rows_per_chunk(per_row)
    outs = [fn(lo, min(lo + step, Q.shape[0])) for lo in range(0, Q.shape[0], step)]
    return tuple(torch.cat(parts) for parts in zip(*outs))


# ---------------------------------------------------------------------------
# FB-LSH: static (K, L)-index with fixed-width buckets.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FBLSH:
    """Fixed-bucketing LSH over the same (K, L) projections.

    Bucket code of point o in table i: floor((h_ij(o) + b_ij) / w). The
    query probes its *own* bucket only — reproducing the hash-boundary
    issue DB-LSH eliminates. The radius schedule is emulated by virtual
    rehashing (recomputing codes at width w0*r), as in LSB/E2LSH's
    r in {1, c, c^2, ...} suite-of-indexes semantics.
    """

    proj_vecs: torch.Tensor  # (L, K, d)
    proj: torch.Tensor  # (L, n, K)
    offsets: torch.Tensor  # (L, K) uniform [0, w0)
    data: torch.Tensor  # (n, d)
    K: int
    L: int
    w0: float
    c: float
    t: int
    max_radius_steps: int
    cand_cap: int

    @staticmethod
    def build(generator, data, K, L, w0, c, t=100, max_radius_steps=24, cand_cap=0,
              *, device=None):
        device = resolve_device(device)
        data = as_tensor(data, device)
        proj_vecs = hashing.sample_projections(generator, data.shape[1], K, L, device)
        proj = hashing.project(data, proj_vecs)
        offsets = torch.rand((L, K), generator=generator, device=generator.device) * w0
        cand_cap = cand_cap or (2 * t + 64)
        return FBLSH(proj_vecs, proj, offsets.to(device), data, K, L, w0, c, t,
                     max_radius_steps, cand_cap)

    @classmethod
    def from_arrays(cls, arrays: dict, *, device=None, **meta) -> "FBLSH":
        """An index from its four arrays (``proj_vecs``, ``proj``,
        ``offsets``, ``data``) and its meta fields."""
        device = resolve_device(device)
        return cls(**{f: as_tensor(arrays[f], device)
                      for f in ("proj_vecs", "proj", "offsets", "data")}, **meta)

    def search_batch(self, Q, k=50, r0=1.0):
        """(Qn, d) -> (dists, ids) of shape (Qn, k), ids int32 (n where
        unfilled).

        The radius r = r0 c^j is the same for every query at step j, so
        the points' codes are computed once a step for the batch; a query
        stops at its own step (C1 or C2) and keeps its results."""
        dev = self.data.device
        Q = torch.atleast_2d(as_tensor(Q, dev))
        n, L = self.data.shape[0], self.L
        with full_fp32():
            gq = torch.einsum("lkd,qd->qlk", self.proj_vecs, Q)
        bd = torch.full((Q.shape[0], k), torch.inf, device=dev)
        bi = torch.full((Q.shape[0], k), n, dtype=torch.int32, device=dev)
        done = torch.zeros(Q.shape[0], dtype=torch.bool, device=dev)
        c32 = np.float32(self.c)
        r = np.float32(r0)
        budget = 2 * self.t * L + k
        for _ in range(self.max_radius_steps):
            act = torch.nonzero(~done).squeeze(1)
            if act.numel() == 0:
                break
            # a one-element tensor, so that CUDA divides instead of
            # multiplying by a rounded reciprocal
            w = torch.tensor([np.float32(self.w0) * r], dtype=torch.float32, device=dev)
            codes = torch.floor((self.proj + self.offsets[:, None, :]) / w)  # (L,n,K)
            qcodes = torch.floor((gq[act] + self.offsets) / w)  # (A,L,K)
            cr = np.float32(c32 * r)

            def step(lo, hi):
                qc = qcodes[lo:hi]
                hit = torch.zeros((hi - lo, n), dtype=torch.bool, device=dev)
                for li in range(L):
                    hit |= torch.all(codes[li][None] == qc[:, li, None, :], dim=-1)
                cand = _first_hits(hit, self.cand_cap * L)
                d2 = _exact_d2(self.data, cand, Q[act[lo:hi]])
                return self._merge(bd[act[lo:hi]], bi[act[lo:hi]], d2, cand, n, k, cr, budget)

            nd, ni, ndone = _chunked(act, n * self.K, step)
            bd[act], bi[act], done[act] = nd, ni, ndone
            r = np.float32(r * c32)
        return torch.sqrt(bd), bi

    @staticmethod
    def _merge(bd, bi, d2, cand, n, k, cr, budget):
        alld = torch.cat([bd, d2], dim=1)
        alli = torch.cat([bi, cand.to(torch.int32)], dim=1)
        # lexsort((alld, alli)): by id, then by distance
        o = torch.sort(alld, dim=1, stable=True).indices
        o = o.gather(1, torch.sort(alli.gather(1, o), dim=1, stable=True).indices)
        ids_s, d_s = alli.gather(1, o), alld.gather(1, o)
        first = torch.ones_like(ids_s, dtype=torch.bool)
        first[:, 1:] = ids_s[:, 1:] != ids_s[:, :-1]
        real = first & (ids_s < n)
        d_s = torch.where(real, d_s, torch.inf)
        ti = _smallest(d_s, k)
        nbd, nbi = d_s.gather(1, ti), ids_s.gather(1, ti)
        nver = torch.sum(real & torch.isfinite(d_s), dim=1)
        done = (nbd[:, k - 1] <= np.float32(cr * cr)) | (nver >= budget)
        return nbd, nbi, done


# ---------------------------------------------------------------------------
# MQ (PM-LSH / SRS family): metric queries in one projected space.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MQIndex:
    proj_vecs: torch.Tensor  # (m, d)
    proj: torch.Tensor  # (n, m)
    data: torch.Tensor
    m: int
    beta: float

    @staticmethod
    def build(generator, data, m=15, beta=0.08, *, device=None):
        device = resolve_device(device)
        data = as_tensor(data, device)
        pv = torch.randn((m, data.shape[1]), generator=generator,
                         device=generator.device).to(device)
        with full_fp32():
            proj = data @ pv.T
        return MQIndex(pv, proj, data, m, beta)

    @classmethod
    def from_arrays(cls, arrays: dict, *, device=None, **meta) -> "MQIndex":
        """An index from ``proj_vecs``, ``proj`` and ``data`` and its meta
        fields."""
        device = resolve_device(device)
        return cls(**{f: as_tensor(arrays[f], device)
                      for f in ("proj_vecs", "proj", "data")}, **meta)

    def search_batch(self, Q, k=50):
        Q = torch.atleast_2d(as_tensor(Q, self.data.device))
        n, d = self.data.shape
        ncand = max(k, int(self.beta * n))
        pn = torch.sum(torch.square(self.proj), -1)

        def chunk(lo, hi):
            q = Q[lo:hi]
            with full_fp32():
                gq = q @ self.proj_vecs.T  # (Qc, m)
                # exact NN in the projected space (the 'metric query')
                d2p = torch.sum(torch.square(gq), -1, keepdim=True) - 2.0 * gq @ self.proj.T + pn
            cand = _smallest(d2p, ncand)  # (Qc, ncand)
            d2 = torch.sum(torch.square(self.data[cand] - q[:, None, :]), dim=-1)
            ti = _smallest(d2, k)
            return (torch.sqrt(torch.clamp(d2.gather(1, ti), min=0.0)),
                    cand.gather(1, ti).to(torch.int32))

        return _chunked(Q, max(ncand * d, n), chunk)


# ---------------------------------------------------------------------------
# C2 (QALSH family): collision counting over one-dim projections.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class C2Index:
    proj_vecs: torch.Tensor  # (m, d)
    proj: torch.Tensor  # (n, m)
    data: torch.Tensor
    m: int
    l: int  # noqa: E741 (the reference's name)
    w: float
    cand_cap: int

    @staticmethod
    def build(generator, data, m=60, collision_ratio=0.45, w=2.0, cand_cap=0, *,
              device=None):
        device = resolve_device(device)
        data = as_tensor(data, device)
        pv = torch.randn((m, data.shape[1]), generator=generator,
                         device=generator.device).to(device)
        with full_fp32():
            proj = data @ pv.T
        l = max(1, int(collision_ratio * m))  # noqa: E741
        cand_cap = cand_cap or max(256, data.shape[0] // 20)
        return C2Index(pv, proj, data, m, l, w, cand_cap)

    @classmethod
    def from_arrays(cls, arrays: dict, *, device=None, **meta) -> "C2Index":
        """An index from ``proj_vecs``, ``proj`` and ``data`` and its meta
        fields."""
        device = resolve_device(device)
        return cls(**{f: as_tensor(arrays[f], device)
                      for f in ("proj_vecs", "proj", "data")}, **meta)

    def search_batch(self, Q, k=50):
        Q = torch.atleast_2d(as_tensor(Q, self.data.device))
        n, d = self.data.shape
        projT = self.proj.T.contiguous()  # (m, n): one projection a row
        half = 0.5 * self.w

        def chunk(lo, hi):
            q = Q[lo:hi]
            with full_fp32():
                gq = q @ self.proj_vecs.T  # (Qc, m)
            # query-centric one-dim buckets, count collisions per point
            counts = torch.zeros((hi - lo, n), dtype=torch.int32, device=q.device)
            for j in range(self.m):
                counts += torch.abs(projT[j][None, :] - gq[:, j:j + 1]) <= half
            # the first cand_cap hits in id order; a row with fewer takes
            # non-hits after them, which are masked (+inf, id n) all the same
            cand = _first_hits(counts >= self.l, self.cand_cap)
            d2 = _exact_d2(self.data, cand, q)
            ti = _smallest(d2, k)
            dk = d2.gather(1, ti)
            ids = torch.where(torch.isfinite(dk), cand.gather(1, ti), n)
            return torch.sqrt(torch.clamp(dk, min=0.0)), ids.to(torch.int32)

        return _chunked(Q, max(min(self.cand_cap, n) * d, n), chunk)
