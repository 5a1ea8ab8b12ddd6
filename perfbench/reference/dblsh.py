"""A plain DB-LSH (paper ICDE 2022, Sec. IV) in PyTorch, for judging the
port: the (c, k)-ANN answer of the one-pass fixed schedule on given
inputs, worked out from the vectors and the hash functions alone.

It imports nothing of the program.  What it computes, step by step:

1. projections ``G_i(o) = (a_i1 . o, ..., a_iK . o)`` of every vector and
   query (float64 sums, exact on the benchmark's inputs, then float32);
2. per table, the STR order (points ranked by the first coordinate into
   ``ceil(sqrt(nb))`` slabs of equal count, then by the second within a
   slab, ties by id), cut into blocks of ``B`` with their bounding boxes;
3. per query and table, the ``M`` blocks whose box overlaps the final
   window ``[g - w/2, g + w/2]`` (``w = w0 * r_last``), nearest first by
   the squared box distance (MINDIST), lowest block first among ties;
4. per slot of those blocks, its first schedule step: the first ``j``
   with ``max_k |p_k - g_k| <= w0 * r_j / 2`` (radii ``r_j = r0 * c^j``
   by a float32 multiply chain);
5. per step, the ``k`` smallest distinct ``(d^2, id)`` pairs among the
   slots admitted so far; the answer freezes at the first step whose
   ``k``-th ``d^2`` is within ``(c * r_j)^2`` (the paper's C2), else it is
   the last step's.  Distances are returned as float32 ``sqrt(d^2)``.

``precision="tf32"`` rounds the operands of every product (the
projections) to TF32's 10-bit mantissa first: the control that a
lower-precision path must fail.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["Reference", "schedule", "round_tf32", "brute_force_knn"]


def schedule(c: float, w0: float, r0: float, steps: int):
    """Radii by the float32 chain ``r_{j+1} = r_j * c`` and the half
    widths ``0.5 * (w0 * r_j)``, all float32 values."""
    c32, w32 = np.float32(c), np.float32(w0)
    radii = [np.float32(r0)]
    for _ in range(steps - 1):
        radii.append(np.float32(radii[-1] * c32))
    halves = [np.float32(np.float32(0.5) * np.float32(w32 * r)) for r in radii]
    return radii, halves


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits), to nearest,
    ties to even."""
    b = x.contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    b = (b + 0x0FFF + lsb) & ~0x1FFF
    return b.view(torch.float32)


def _project(x: torch.Tensor, proj: torch.Tensor, precision: str,
             rows: int = 1 << 20) -> torch.Tensor:
    """(n, d) x (L, K, d) -> (L, n, K) float32."""
    L, K, d = proj.shape
    a = proj.reshape(L * K, d)
    if precision == "tf32":
        a = round_tf32(a)
    a = a.double().T
    out = torch.empty((L, x.shape[0], K), dtype=torch.float32, device=x.device)
    for s in range(0, x.shape[0], rows):
        xs = x[s:s + rows]
        if precision == "tf32":
            xs = round_tf32(xs)
        p = (xs.double() @ a).float()  # (rows, L*K)
        out[:, s:s + rows] = p.reshape(-1, L, K).permute(1, 0, 2)
    return out


class Reference:
    """The index of one run, rebuilt from its inputs; ``search`` answers
    queries as the one-pass fixed schedule defines them."""

    def __init__(self, data: torch.Tensor, proj: torch.Tensor, *, c: float, w0: float,
                 block_size: int, max_blocks: int, precision: str = "fp32"):
        if precision not in ("fp32", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        self.data, self.proj, self.precision = data, proj, precision
        self.c, self.w0, self.B, self.M = c, w0, block_size, max_blocks
        n = data.shape[0]
        L, K, _ = proj.shape
        B = block_size
        nb = -(-n // B)
        self.n, self.nb, self.L, self.K = n, nb, L, K
        n_slabs = max(1, math.ceil(math.sqrt(nb)))
        slab_pts = -(-n // n_slabs)
        dev = data.device
        self.ids, self.blk_proj, self.lo, self.hi = [], [], [], []
        pad = nb * B - n
        P = _project(data, proj, precision)  # (L, n, K)
        for li in range(L):
            p = P[li]
            rank0 = torch.empty(n, dtype=torch.int64, device=dev)
            rank0[torch.sort(p[:, 0], stable=True).indices] = torch.arange(n, device=dev)
            slab = rank0 // slab_pts
            key2 = p[:, 1] if K > 1 else p[:, 0]
            # lexicographic (slab, key2, id): stable sorts, last key first
            o = torch.sort(key2, stable=True).indices
            o = o[torch.sort(slab[o], stable=True).indices]
            pb = torch.cat([p[o], torch.full((pad, K), torch.inf, device=dev)])
            ib = torch.cat([o, torch.full((pad,), n, dtype=torch.int64, device=dev)])
            pb, ib = pb.reshape(nb, B, K), ib.reshape(nb, B)
            real = (ib < n)[..., None]
            self.lo.append(torch.where(real, pb, torch.inf).amin(dim=1))
            self.hi.append(torch.where(real, pb, -torch.inf).amax(dim=1))
            self.blk_proj.append(pb)
            self.ids.append(ib)
            del rank0, slab, o
        del P

    def _select(self, li: int, g: torch.Tensor, half: float) -> torch.Tensor:
        """(S, M) block ids of table ``li`` (``nb`` where fewer than M
        overlap the window)."""
        lo, hi = self.lo[li][None], self.hi[li][None]
        g3 = g[:, None, :]
        overlap = ((lo <= g3 + half) & (hi >= g3 - half)).all(dim=-1)
        pd = torch.clamp(lo - g3, min=0.0) + torch.clamp(g3 - hi, min=0.0)
        score = torch.where(overlap, torch.sum(torch.square(pd), dim=-1), torch.inf)
        blk = torch.sort(score, dim=1, stable=True).indices[:, :self.M]
        return torch.where(torch.gather(overlap, 1, blk), blk, self.nb)

    def search(self, Q: torch.Tensor, *, k: int, r0: float, steps: int,
               chunk: int = 256):
        """(S, k) float32 distances ascending (+inf unfilled) and (S, k)
        int32 ids (``n`` unfilled) for the query rows ``Q``."""
        out_d, out_i = [], []
        for s in range(0, Q.shape[0], chunk):
            d, i = self._search(Q[s:s + chunk], k, r0, steps)
            out_d.append(d)
            out_i.append(i)
        return torch.cat(out_d), torch.cat(out_i)

    def _search(self, Q, k, r0, steps):
        radii, halves = schedule(self.c, self.w0, r0, steps)
        S, dev, n, B = Q.shape[0], Q.device, self.n, self.B
        G = _project(Q, self.proj, self.precision)  # (L, S, K)
        half_sel = float(halves[-1])
        hal = torch.tensor(np.array(halves, np.float32), device=dev)
        cand_ids, cand_step = [], []
        for li in range(self.L):
            g = G[li]
            blk = self._select(li, g, half_sel)  # (S, M)
            ok = blk < self.nb
            safe = torch.where(ok, blk, 0)
            ids = torch.where(ok[..., None], self.ids[li][safe], n)  # (S, M, B)
            pb = self.blk_proj[li][safe]  # (S, M, B, K)
            hw = torch.abs(pb - g[:, None, None, :]).amax(dim=-1)
            hw = torch.where(ok[..., None] & (ids < n), hw, torch.inf)
            step = (hw[..., None] > hal).sum(dim=-1)  # first admitting step; steps = never
            cand_ids.append(ids.reshape(S, -1))
            cand_step.append(step.reshape(S, -1))
        ids = torch.cat(cand_ids, dim=1)  # (S, C)
        step = torch.cat(cand_step, dim=1)
        admitted = step < steps
        x = self.data[torch.where(admitted, ids, 0)]  # (S, C, d)
        d2 = ((x.double() - Q[:, None, :].double()) ** 2).sum(dim=-1).float()
        d2 = torch.where(admitted, d2, torch.inf)
        ids = torch.where(admitted, ids, n)
        # order by (d2, id); copies of one point (one per table) sit
        # together, and the point counts from its earliest copy's step
        o = torch.sort(ids, dim=1, stable=True).indices
        o = torch.gather(o, 1, torch.sort(torch.gather(d2, 1, o), dim=1, stable=True).indices)
        d2, ids, step = (torch.gather(t, 1, o) for t in (d2, ids, step))
        same = torch.zeros_like(admitted)
        same[:, 1:] = ids[:, 1:] == ids[:, :-1]
        # the earliest step over each run of copies, carried to its head
        grp = torch.cumsum(~same, dim=1) - 1
        first_step = torch.full_like(step, steps).scatter_reduce(1, grp, step, "amin")
        step = torch.where(same, steps, torch.gather(first_step, 1, grp))
        step = torch.where(ids < n, step, steps)
        # per step: the k-th admitted entry's d2, then C2's freeze
        frozen = torch.full((S,), steps - 1, dtype=torch.int64, device=dev)
        done = torch.zeros(S, dtype=torch.bool, device=dev)
        for j in range(steps):
            adm = step <= j
            pos = torch.cumsum(adm, dim=1)
            hit = adm & (pos == k)
            has = hit.any(dim=1)
            kth = torch.where(has, d2.gather(1, hit.float().argmax(dim=1, keepdim=True))[:, 0],
                              torch.inf)
            bound = float(np.square(np.float32(self.c) * radii[j]))
            fire = ~done & (kth <= bound)
            frozen = torch.where(fire, j, frozen)
            done |= fire
        adm = step <= frozen[:, None]
        pos = torch.cumsum(adm, dim=1)
        take = adm & (pos <= k)
        rank = torch.where(take, pos - 1, k)  # k = the discard column
        out_d = torch.full((S, k + 1), torch.inf, device=dev)
        out_i = torch.full((S, k + 1), n, dtype=torch.int64, device=dev)
        out_d.scatter_(1, rank, torch.where(take, d2, torch.inf))
        out_i.scatter_(1, rank, torch.where(take, ids, n))
        return torch.sqrt(out_d[:, :k]), out_i[:, :k].to(torch.int32)


def brute_force_knn(data: torch.Tensor, Q: torch.Tensor, k: int,
                    rows: int = 1 << 20) -> torch.Tensor:
    """(S, k) exact nearest distances (float64, ascending) of the query
    rows over all of ``data``: the recall oracle."""
    q2 = (Q.double() ** 2).sum(dim=1, keepdim=True)
    best = torch.full((Q.shape[0], k), math.inf, dtype=torch.float64, device=Q.device)
    for s in range(0, data.shape[0], rows):
        xs = data[s:s + rows].double()
        d2 = torch.clamp(q2 - 2.0 * (Q.double() @ xs.T) + (xs * xs).sum(dim=1)[None], min=0.0)
        best = torch.topk(torch.cat([best, d2], dim=1), k, dim=1, largest=False).values
    return torch.sqrt(best)
