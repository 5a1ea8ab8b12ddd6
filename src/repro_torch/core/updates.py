"""Incremental DB-LSH index maintenance: insert / delete / compact.

The paper builds a static index; a vector store needs online updates,
and the dense STR block structure takes them (DESIGN.md §4):

* **insert** — project the new points with the index's own LSH functions
  (the hash family is fixed, only the point set grows), STR-order them
  locally and append whole blocks per table.  K and L were sized for the
  build-time n: compact once n has grown past ~2x.
* **delete** — tombstone the slots holding the deleted ids (+inf
  projection and norm, sentinel id) and re-tighten the block MBRs.  A
  deleted point can never be returned; its space comes back at compact.
* **compact** — rebuild from the surviving points with fresh hash
  functions, re-deriving K and L for the live n.

The quantized blocks (``params.quant_dtype`` 'bf16'/'int8') follow:
insert quantizes the appended blocks, delete leaves them as they are
(a tombstoned slot's +inf projection keeps it out of every schedule bin,
and the float32 re-rank masks its sentinel id), compact rebuilds them.
Every function works on tensors on the index's device.
"""

from __future__ import annotations

import dataclasses

import torch

from ..device import as_tensor
from . import hashing
from .index import DBLSHIndex, _str_order, build, quantize_blocks
from .params import DBLSHParams

__all__ = ["grown_params", "insert", "delete", "compact", "live_count",
           "live_ids_padded"]


def grown_params(p: DBLSHParams, n_total: int) -> DBLSHParams:
    """Params for an index grown in place to ``n_total`` points.

    ``max_blocks`` may have been capped by the build-time block count
    (:meth:`DBLSHParams.resolve` takes ``min(budget, ceil(n/B))``);
    appended blocks lift that cap, so it is re-derived at the new n —
    otherwise a small index could never probe past its original blocks
    and inserted points would be unreachable.  An explicitly larger
    setting is kept."""
    grown = dataclasses.replace(p, n=n_total, max_blocks=0).resolve().max_blocks
    return dataclasses.replace(p, n=n_total, max_blocks=max(p.max_blocks, grown))


def insert(index: DBLSHIndex, new_points) -> DBLSHIndex:
    """Append ``new_points`` (m, d) as new STR blocks per table; they get
    the ids n, ..., n + m - 1."""
    p = index.params
    dev = index.device
    new_points = as_tensor(new_points, dev)
    m, d = new_points.shape
    if d != p.d:
        raise ValueError(f"new points have d={d}, the index d={p.d}")
    n_old, B, K = index.n, p.block_size, p.K
    nb_new = -(-m // B)
    pad = nb_new * B - m
    n_total = n_old + m
    i32 = torch.int32

    proj = hashing.project(new_points, index.proj_vecs)  # (L, m, K)
    new_norms = torch.sum(torch.square(new_points), dim=-1)  # (m,)
    pbs, ibs, nrms, los, his, vbs = [], [], [], [], [], []
    for li in range(p.L):
        order = _str_order(proj[li], B)
        ps = torch.cat([proj[li][order], torch.full((pad, K), torch.inf, device=dev)])
        ps = ps.reshape(nb_new, B, K)
        pbs.append(ps)
        ibs.append(torch.cat([order.to(i32) + n_old,
                              torch.full((pad,), n_total, dtype=i32, device=dev)]
                             ).reshape(nb_new, B))
        nrms.append(torch.cat([new_norms[order], torch.full((pad,), torch.inf, device=dev)]
                              ).reshape(nb_new, B))
        # MBRs over real points only, as in build
        finite = torch.isfinite(ps[..., :1])
        los.append(ps.amin(dim=1))
        his.append(torch.where(finite, ps, -torch.inf).amax(dim=1))
        if p.inline_vectors:
            vbs.append(torch.cat([new_points[order], torch.zeros((pad, d), device=dev)]
                                 ).reshape(nb_new, B, d))
    ib = torch.stack(ibs)

    # the old sentinel ids (== n_old) move to the new sentinel n_total
    old_ids = torch.where(index.ids_blocks >= n_old, n_total, index.ids_blocks)
    fields = dict(
        proj_vecs=index.proj_vecs,
        proj_blocks=torch.cat([index.proj_blocks, torch.stack(pbs)], dim=1),
        ids_blocks=torch.cat([old_ids, ib], dim=1),
        mbr_lo=torch.cat([index.mbr_lo, torch.stack(los)], dim=1),
        mbr_hi=torch.cat([index.mbr_hi, torch.stack(his)], dim=1),
        data=torch.cat([index.data, new_points]),
        # old padded and tombstoned slots are +inf already, so a plain
        # concatenation stays slot-aligned
        norm_blocks=torch.cat([index.norm_blocks, torch.stack(nrms)], dim=1),
        vec_blocks=(torch.cat([index.vec_blocks, torch.stack(vbs)], dim=1)
                    if p.inline_vectors else index.vec_blocks),
        qvec_blocks=index.qvec_blocks,
        qvec_scale=index.qvec_scale,
        params=grown_params(p, n_total),
    )
    if p.quant_dtype != "none":
        # quantization is per slot, so the appended region quantizes on
        # its own: ids local to new_points, padded slots get zero rows
        qb, qs = quantize_blocks(new_points, ib - n_old, p.quant_dtype)
        fields["qvec_blocks"] = torch.cat([index.qvec_blocks, qb], dim=1)
        fields["qvec_scale"] = torch.cat([index.qvec_scale, qs], dim=1)
    return DBLSHIndex(**fields)


def delete(index: DBLSHIndex, del_ids) -> DBLSHIndex:
    """Tombstone ``del_ids`` (k,) and re-tighten the MBRs.

    Ids are int32.  Values outside ``[0, n)`` are no-ops: the sentinel
    ``n`` only re-tombstones dead slots and anything else matches
    nothing.  The quantized blocks stay as they are (see the module
    docstring)."""
    n = index.n
    del_ids = as_tensor(del_ids, index.device, torch.int32).reshape(-1)
    dead = torch.isin(index.ids_blocks, del_ids)  # (L, nb, B)
    proj = torch.where(dead[..., None], torch.inf, index.proj_blocks)
    finite = torch.isfinite(proj[..., :1])
    return dataclasses.replace(
        index,
        proj_blocks=proj,
        ids_blocks=torch.where(dead, n, index.ids_blocks),
        mbr_lo=proj.amin(dim=2),
        mbr_hi=torch.where(finite, proj, -torch.inf).amax(dim=2),
        norm_blocks=torch.where(dead, torch.inf, index.norm_blocks),
    )


def live_count(index: DBLSHIndex) -> int:
    """Number of live (not tombstoned) points, from table 0."""
    return int((index.ids_blocks[0] < index.n).sum())


def live_ids_padded(index: DBLSHIndex) -> torch.Tensor:
    """The sorted live point ids (int32), padded with the sentinel ``n``
    to length ``n + 1`` (the reference's static-shape form)."""
    n = index.n
    ids = index.ids_blocks[0]
    live = torch.unique(ids[ids < n]).to(torch.int32)  # sorted
    fill = torch.full((n + 1 - live.numel(),), n, dtype=torch.int32, device=ids.device)
    return torch.cat([live, fill])


def compact(index: DBLSHIndex, *, generator: torch.Generator | None = None,
            proj_vecs=None) -> tuple[DBLSHIndex, torch.Tensor]:
    """Rebuild from the surviving points, re-deriving K and L for the live
    n.  The new hash functions come from ``proj_vecs`` (L', K', d) when
    given, else from ``generator``, as in :func:`build`.

    Returns (new_index, id_map): id_map (n_old,) int32 holds each old id's
    new id, or -1 where the point was deleted."""
    p = index.params
    n_old = index.n
    live_ids = live_ids_padded(index)
    live_ids = live_ids[live_ids < n_old].long()
    n_live = live_ids.numel()
    new_params = DBLSHParams.derive(
        n=n_live, d=p.d, c=p.c, w0=p.w0, t=p.t, k=p.k, block_size=p.block_size,
        inline_vectors=p.inline_vectors, quant_dtype=p.quant_dtype,
    )
    id_map = torch.full((n_old,), -1, dtype=torch.int32, device=index.device)
    id_map[live_ids] = torch.arange(n_live, dtype=torch.int32, device=index.device)
    new_index = build(index.data[live_ids], new_params, generator=generator,
                      proj_vecs=proj_vecs, device=index.device)
    return new_index, id_map
