"""DB-LSH index construction (paper §IV-B): a dense STR block index.

The paper bulk-loads one R*-tree per K-dim projected space.  As in the
reference, the tree levels are flattened into dense arrays: per table,
points are STR-ordered (dim-0 slabs, dim-1 within a slab) and grouped
into blocks of ``B`` points, each block with its K-dim minimum bounding
rectangle.  See DESIGN.md §3.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..device import as_tensor, resolve_device
from . import hashing
from .params import DBLSHParams

__all__ = ["DBLSHIndex", "build", "compute_norm_blocks", "empty_quant_blocks",
           "from_arrays", "quantize_blocks"]

_ARRAY_FIELDS = (
    "proj_vecs",
    "proj_blocks",
    "ids_blocks",
    "mbr_lo",
    "mbr_hi",
    "data",
    "vec_blocks",
    "norm_blocks",
)
_QUANT_FIELDS = ("qvec_blocks", "qvec_scale")


def compute_norm_blocks(data: torch.Tensor, ids_blocks: torch.Tensor) -> torch.Tensor:
    """Per-slot squared norms ||x||^2 aligned with ``ids_blocks``.

    Padded slots (id >= n) get +inf so the distance form
    ||x||^2 - 2<q,x> + ||q||^2 masks them without an id compare."""
    n = data.shape[0]
    norms = torch.sum(torch.square(data), dim=-1)
    valid = ids_blocks < n
    out = norms[torch.where(valid, ids_blocks, 0).long()]
    return torch.where(valid, out, torch.inf).to(torch.float32)


def quantize_blocks(data: torch.Tensor, ids_blocks: torch.Tensor,
                    quant_dtype: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantized per-table vector blocks for the reduced-precision dot
    (kernel B3).  Returns ``(qvec_blocks, qvec_scale)`` slot-aligned with
    ``ids_blocks``:

      * ``bf16``: the vectors rounded to bfloat16 (nearest even), scale
        all-ones;
      * ``int8``: per-slot symmetric quantization ``round(x / s)`` (half
        to even) clipped to ±127, ``s = amax(|x|) / 127`` (1.0 on all-zero
        rows), so the approximate dot is ``s_slot * s_q * <qx, qq>``.

    A pure function of ``data``: snapshots keep the float32 truth and a
    restore re-derives these.  Padded and tombstoned slots (ids outside
    [0, n)) get zero rows, a zero dot; admission and the float32 re-rank
    mask them exactly."""
    if quant_dtype not in ("bf16", "int8"):
        raise ValueError(f"quant_dtype must be 'bf16' or 'int8', got {quant_dtype!r}")
    n = data.shape[0]
    valid = (ids_blocks >= 0) & (ids_blocks < n)
    x = data[torch.where(valid, ids_blocks, 0).long()]
    x = torch.where(valid[..., None], x, 0.0)
    if quant_dtype == "bf16":
        return x.to(torch.bfloat16), torch.ones(ids_blocks.shape, dtype=torch.float32,
                                                device=data.device)
    amax = x.abs().amax(dim=-1)
    scale = torch.where(amax > 0.0, amax / 127.0, 1.0)
    q = torch.clamp(torch.round(x / scale[..., None]), -127.0, 127.0).to(torch.int8)
    return q, scale


def empty_quant_blocks(device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The (empty) quantized fields of an index with quant_dtype 'none'."""
    return (torch.zeros((0,), dtype=torch.int8, device=device),
            torch.zeros((0,), dtype=torch.float32, device=device))


@dataclasses.dataclass
class DBLSHIndex:
    """The (K, L)-index with dynamic bucketing support.

    Shapes (B = params.block_size, nb = ceil(n / B)):
      proj_vecs:   (L, K, d)      the LSH functions a_ij (Eq. 3)
      proj_blocks: (L, nb, B, K)  STR-ordered projections, +inf padded
      ids_blocks:  (L, nb, B)     original point ids (int32), n-padded
      mbr_lo/hi:   (L, nb, K)     per-block K-dim bounding boxes
      data:        (n, d)         the dataset ('gather' verify layout)
      vec_blocks:  (L, nb, B, d)  per-table reordered vectors ('inline'
                                  layout), else an empty tensor
      norm_blocks: (L, nb, B)     per-slot ||x||^2, +inf on padded slots
      qvec_blocks: (L, nb, B, d)  quantized vectors (bf16 or int8) of the
                                  quantized distance path, else empty
      qvec_scale:  (L, nb, B)     per-slot dequant scales (f32; all-ones
                                  for bf16), else empty
    """

    proj_vecs: torch.Tensor
    proj_blocks: torch.Tensor
    ids_blocks: torch.Tensor
    mbr_lo: torch.Tensor
    mbr_hi: torch.Tensor
    data: torch.Tensor
    vec_blocks: torch.Tensor
    norm_blocks: torch.Tensor
    qvec_blocks: torch.Tensor
    qvec_scale: torch.Tensor
    params: DBLSHParams

    @property
    def n(self) -> int:
        return self.data.shape[0]

    @property
    def nb(self) -> int:
        return self.proj_blocks.shape[1]

    @property
    def device(self) -> torch.device:
        return self.proj_blocks.device

    def memory_bytes(self) -> int:
        return sum(
            getattr(self, f).numel() * getattr(self, f).element_size()
            for f in _ARRAY_FIELDS + _QUANT_FIELDS if f != "data"
        )


def _str_order(proj_t: torch.Tensor, block_size: int) -> torch.Tensor:
    """STR ordering for one table: sort by dim-0 into slabs, then by dim-1
    within each slab.  Returns the permutation (n,) of original point ids.

    Mirrors the reference's ``argsort(argsort)`` + ``lexsort((key2,
    slab))`` with stable sorts only, so ties (duplicate rows) land in the
    same order: a stable sort by the secondary key, then a stable sort by
    the primary key."""
    n, K = proj_t.shape
    nb = -(-n // block_size)
    n_slabs = max(1, int(math.ceil(math.sqrt(nb))))
    slab_pts = -(-n // n_slabs)
    rank0 = torch.argsort(torch.argsort(proj_t[:, 0], stable=True), stable=True)
    slab = rank0 // slab_pts
    key2 = proj_t[:, 1] if K > 1 else proj_t[:, 0]
    order = torch.argsort(key2, stable=True)
    return order[torch.argsort(slab[order], stable=True)]


def build(data, params: DBLSHParams, *, generator: torch.Generator | None = None,
          proj_vecs=None, device=None) -> DBLSHIndex:
    """Indexing phase (paper §IV-B): project into L K-dim spaces (Eq. 7),
    then bulk-load one dense STR index per space.

    The hash functions come from ``proj_vecs`` (L, K, d) when given (for
    example a reference index's, to rebuild it exactly), else they are
    drawn from ``generator``."""
    device = resolve_device(device)
    params = params.resolve()
    data = as_tensor(data, device)
    n, d = data.shape
    if (n, d) != (params.n, params.d):
        raise ValueError(f"data shape {(n, d)} does not match params {(params.n, params.d)}")
    B, K, L = params.block_size, params.K, params.L
    nb = -(-n // B)
    n_pad = nb * B

    if proj_vecs is None:
        if generator is None:
            raise ValueError("build needs either proj_vecs or a generator")
        proj_vecs = hashing.sample_projections(generator, d, K, L, device)
    proj_vecs = as_tensor(proj_vecs, device)
    if tuple(proj_vecs.shape) != (L, K, d):
        raise ValueError(f"proj_vecs shape {tuple(proj_vecs.shape)} != {(L, K, d)}")
    proj = hashing.project(data, proj_vecs)  # (L, n, K)

    pad_ids = torch.full((n_pad - n,), n, dtype=torch.int64, device=device)
    pad_proj = torch.full((n_pad - n, K), torch.inf, device=device)
    proj_blocks, ids_blocks, mbr_lo, mbr_hi, vec_blocks = [], [], [], [], []
    for li in range(L):
        order = _str_order(proj[li], B)
        p_sorted = torch.cat([proj[li][order], pad_proj]).reshape(nb, B, K)
        proj_blocks.append(p_sorted)
        ids_blocks.append(torch.cat([order, pad_ids]).reshape(nb, B))
        # MBRs over real points only: padded rows are +inf so they never
        # lower `lo`; mask them out of `hi` with -inf
        finite = torch.isfinite(p_sorted[..., :1])
        mbr_lo.append(p_sorted.amin(dim=1))
        mbr_hi.append(torch.where(finite, p_sorted, -torch.inf).amax(dim=1))
        if params.inline_vectors:
            pad_v = torch.zeros((n_pad - n, d), device=device)
            vec_blocks.append(torch.cat([data[order], pad_v]).reshape(nb, B, d))

    ids_blocks = torch.stack(ids_blocks).to(torch.int32)
    if params.quant_dtype != "none":
        qvec_blocks, qvec_scale = quantize_blocks(data, ids_blocks, params.quant_dtype)
    else:
        qvec_blocks, qvec_scale = empty_quant_blocks(device)
    return DBLSHIndex(
        proj_vecs=proj_vecs,
        proj_blocks=torch.stack(proj_blocks),
        ids_blocks=ids_blocks,
        mbr_lo=torch.stack(mbr_lo),
        mbr_hi=torch.stack(mbr_hi),
        data=data,
        vec_blocks=(torch.stack(vec_blocks) if params.inline_vectors
                    else torch.zeros((0,), device=device)),
        norm_blocks=compute_norm_blocks(data, ids_blocks),
        qvec_blocks=qvec_blocks,
        qvec_scale=qvec_scale,
        params=params,
    )


def from_arrays(arrays: dict, params: dict, *, device=None) -> DBLSHIndex:
    """A reference index carried across: ``arrays`` maps the index's field
    names to numpy arrays and ``params`` is ``dataclasses.asdict`` of its
    params (the shape of the reference's snapshot tree and meta).  The
    quantized blocks are derived state, as in the reference's restore:
    with ``params["quant_dtype"] != "none"`` they are re-derived from
    ``data`` and ``ids_blocks``, and any given in ``arrays`` are ignored."""
    device = resolve_device(device)
    missing = [f for f in _ARRAY_FIELDS if f not in arrays]
    if missing:
        raise ValueError(f"arrays lack index fields {missing}")
    tensors = {
        f: as_tensor(np.ascontiguousarray(arrays[f]), device,
                     torch.int32 if f == "ids_blocks" else torch.float32)
        for f in _ARRAY_FIELDS
    }
    params = DBLSHParams(**params)
    if params.quant_dtype != "none":
        qvec = quantize_blocks(tensors["data"], tensors["ids_blocks"], params.quant_dtype)
    else:
        qvec = empty_quant_blocks(device)
    return DBLSHIndex(params=params, qvec_blocks=qvec[0], qvec_scale=qvec[1], **tensors)
