"""Distributed DB-LSH: the dataset sharded over a mesh's axis.

Every shard builds a *local* DB-LSH index over its n/P slice using the
SAME LSH functions (drawn once, handed to every shard's ``build`` — the
union of per-shard query-centric windows then equals the global window,
so Lemma 1/2 guarantees are unchanged).  A query batch is replicated;
each shard answers a local (c,k)-ANN with the fixed-schedule engine;
results merge on the merge device with one k-sized gather + a stable
top-k (ids are globally offset, hence disjoint across shards — no dedup
needed at the merge).

**The mesh is single-controller.**  One process drives every shard, as
one process drives a JAX ``shard_map``: a :class:`Mesh` is an ordered
tuple of devices (which may repeat — four shards may share one card, as
the reference's tests share one CPU among forced host devices) laid out
over one or more named axes (a fleet uses one; the model's sharding rules
read ``data``, ``model`` and ``pod``, see ``repro_torch.sharding``).  The collectives become tensor ops on the merge device, the
mesh's first device: ``all_gather`` is the per-shard results moved there
with ``non_blocking=True`` and stacked, ``psum`` a ``sum(0)``, ``pmax``
an ``amax(0)``, and compaction's ``all_to_all`` the slices of each
shard's survivor runs copied to their destination shard.  Nothing in a
fleet search waits for the card: the per-shard searches and the merge
are queued, as a local search is.

The index is mutable in place at fleet scale too: :func:`insert_sharded`
/ :func:`delete_sharded` / :func:`compact_sharded` wrap ``core.updates``
(least-loaded insert routing, arithmetic global-id translation,
rebalancing per-shard rebuild with a global id remap — DESIGN.md §9).

Global ids are **strided**: each shard owns the id segment
``[rank * stride, rank * stride + n_local)`` with ``stride >= n_local``,
so ``gid = rank * stride + local``.  Inserts grow ``n_local`` *within*
the stride and therefore never move an existing id; only
:func:`compact_sharded` (which returns an id map) renumbers, when it
re-strides for the new per-shard count.  ``stride == n_local`` (the
:func:`build_sharded` default) degenerates to dense ids that equal global
data-row indices.

Every shard keeps the same array shapes, as under SPMD: a mutation that
logically touches one shard still runs on all of them — *insert* appends
the batch to every shard and tombstones the copies on all but the routed
target, *compact* rebuilds every shard at the balanced count and
tombstones the padding rows.  The snapshot's global layout (block fields
concatenated over shards) depends on it.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..device import as_tensor
from . import hashing
from . import updates as _updates
from .index import build, from_arrays
from .params import DBLSHParams
from .serve_search import search_batch_fixed

__all__ = [
    "Mesh",
    "make_mesh",
    "ShardedDBLSH",
    "id_stride",
    "build_sharded",
    "search_sharded",
    "shard_live_counts",
    "insert_sharded",
    "delete_sharded",
    "compact_sharded",
]

# index fields whose block dimension (axis 1) is split over the shards;
# ``data`` is split on axis 0, ``proj_vecs`` is the same on every shard
_BLOCK_FIELDS = ("proj_blocks", "ids_blocks", "mbr_lo", "mbr_hi", "norm_blocks")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device mesh with named axes over a grid of devices.

    ``axis`` is one axis name (``Mesh(devices, "data")``: ``devices[r]``
    holds shard ``r``) or a tuple of names, and ``dims`` their sizes in
    the same order (row-major over ``devices``, as a ``jax.sharding.Mesh``
    lays out its device grid; None: one axis over every device).  Devices
    may repeat (several shards on one card).  ``shape`` maps each axis
    name to its size, in order, and ``axis_names`` is the tuple of names,
    so both read as they do on a ``jax.sharding.Mesh``.  The first device
    is the merge device: replicated results, the payload and the id maps
    live there.
    """

    devices: tuple
    axis: str | tuple = "data"
    dims: tuple | None = None

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        names = (self.axis,) if isinstance(self.axis, str) else tuple(self.axis)
        dims = (len(devs),) if self.dims is None else tuple(int(n) for n in self.dims)
        if len(dims) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"axes {names} do not match the sizes {dims}")
        if math.prod(dims) != len(devs):
            raise ValueError(f"a mesh of {dims} needs {math.prod(dims)} devices, got {len(devs)}")
        object.__setattr__(self, "devices", devs)
        object.__setattr__(self, "dims", dims)

    @property
    def axis_names(self) -> tuple:
        return (self.axis,) if isinstance(self.axis, str) else tuple(self.axis)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def merge_device(self) -> torch.device:
        return self.devices[0]

    def device_at(self, **coords) -> torch.device:
        """The device at the given axis coordinates (0 on every axis not
        named): ``mesh.device_at(pod=1)``."""
        flat = 0
        for name, n in zip(self.axis_names, self.dims):
            i = int(coords.pop(name, 0))
            if not 0 <= i < n:
                raise IndexError(f"{name}={i} outside an axis of {n}")
            flat = flat * n + i
        if coords:
            raise KeyError(f"the mesh has no axes {sorted(coords)}")
        return self.devices[flat]


def make_mesh(shards, axis="data", devices=None) -> Mesh:
    """A mesh of ``shards`` shards over ``axis``, or, with a tuple of sizes
    and a tuple of axis names, a mesh over those axes
    (``make_mesh((2, 4), ("data", "model"))``, as ``jax.make_mesh``).

    ``devices=None`` cycles the CUDA devices over the grid (four shards
    on a one-card machine all sit on ``cuda:0``); without CUDA it raises —
    pass ``devices=["cpu"] * shards`` to run on the CPU.  A list of
    as many devices as the grid holds is taken as given."""
    dims = (int(shards),) if isinstance(shards, int) else tuple(int(n) for n in shards)
    names = axis if isinstance(axis, str) else tuple(axis)
    if isinstance(names, str) and len(dims) != 1:
        raise ValueError(f"make_mesh: one axis name for the sizes {dims}")
    total = math.prod(dims)
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh places shards on the CUDA devices by default and none "
                "is available; pass devices=['cpu'] * shards (device='cpu' for "
                "every shard) to run on the CPU"
            )
        count = torch.cuda.device_count()
        devices = [torch.device("cuda", r % count) for r in range(total)]
    devices = tuple(devices)
    if len(devices) != total:
        raise ValueError(f"make_mesh: {len(devices)} devices for {total} shards")
    return Mesh(devices, names, None if isinstance(names, str) else dims)


@dataclasses.dataclass
class ShardedDBLSH:
    """One DB-LSH index per shard (``shards[r]`` on the mesh's device r),
    all with the same hash functions and the same array shapes."""

    shards: list
    axis: str
    n_total: int
    n_local: int
    stride: int  # id segment width per shard: gid = rank * stride + local

    @property
    def params(self) -> DBLSHParams:
        """The per-shard params (``n`` is ``n_local``)."""
        return self.shards[0].params

    @property
    def id_space(self) -> int:
        """Exclusive upper bound of the global id space (and the merge
        sentinel for unfilled result slots): ``P * stride``."""
        return (self.n_total // self.n_local) * self.stride

    @property
    def d(self) -> int:
        return self.shards[0].data.shape[1]

    def global_arrays(self) -> dict:
        """The reference's global layout as host arrays: the block fields
        concatenated over shards on axis 1, ``data`` on axis 0,
        ``proj_vecs`` once, ``vec_blocks`` concatenated only with
        ``inline_vectors`` (else the empty replicated array)."""
        out = {"proj_vecs": self.shards[0].proj_vecs.cpu().numpy(),
               "data": torch.cat([s.data.cpu() for s in self.shards]).numpy()}
        fields = _BLOCK_FIELDS + (("vec_blocks",) if self.params.inline_vectors else ())
        for f in fields:
            out[f] = torch.cat([getattr(s, f).cpu() for s in self.shards], dim=1).numpy()
        if not self.params.inline_vectors:
            out["vec_blocks"] = self.shards[0].vec_blocks.cpu().numpy()
        return out


def _mesh_of(s: ShardedDBLSH, mesh: Mesh | None) -> Mesh:
    """The mesh a call runs on, checked against the fleet's shard count."""
    if mesh is None:
        raise TypeError("a sharded call needs mesh=, the mesh the fleet lies on")
    if mesh.shape[s.axis] != len(s.shards):
        raise ValueError(
            f"the mesh has {mesh.shape[s.axis]} devices over {s.axis!r}, the fleet "
            f"{len(s.shards)} shards"
        )
    return mesh


def shard_arrays(arrays: dict, pn: int, params: DBLSHParams) -> list[dict]:
    """The inverse of :meth:`ShardedDBLSH.global_arrays`: one dict of
    per-shard host arrays per rank."""
    fields = [f for f in _BLOCK_FIELDS if f in arrays]
    if params.inline_vectors:
        fields.append("vec_blocks")
    parts = {f: np.split(np.asarray(arrays[f]), pn, axis=1) for f in fields}
    parts["data"] = np.split(np.asarray(arrays["data"]), pn, axis=0)
    shared = {"proj_vecs": arrays["proj_vecs"]}
    if not params.inline_vectors:
        shared["vec_blocks"] = arrays["vec_blocks"]
    return [{**shared, **{f: v[r] for f, v in parts.items()}} for r in range(pn)]


def from_global_arrays(arrays: dict, params: dict, mesh: Mesh, *, axis: str,
                       n_total: int, n_local: int, stride: int) -> ShardedDBLSH:
    """A fleet from the global layout (a snapshot's tree): each shard's
    slice placed on its device through ``from_arrays``, which re-derives
    the quantized blocks per shard (``ids_blocks`` are shard-local, so a
    single quantization of the concatenated arrays would gather the
    wrong rows for every shard past rank 0)."""
    pn = mesh.shape[axis]
    per = shard_arrays(arrays, pn, DBLSHParams(**params))
    shards = [from_arrays(per[r], params, device=mesh.devices[r]) for r in range(pn)]
    return ShardedDBLSH(shards=shards, axis=axis, n_total=n_total, n_local=n_local,
                        stride=stride)


def id_stride(n_local: int, headroom: float = 2.0, reserve: int = 0) -> int:
    """Pick a per-shard id stride with insert headroom.

    ``headroom`` scales the stride past the current per-shard count so
    ids stay stable across inserts until ``n_local`` reaches the stride;
    ``reserve`` additionally guarantees room for a known incoming batch.
    Always at least ``n_local + 1`` so one insert fits."""
    n_local = max(int(n_local), 1)
    return max(
        int(math.ceil(headroom * n_local)),
        n_local + 1,
        n_local + int(reserve),
    )


def build_sharded(generator, data, params_local: DBLSHParams, mesh: Mesh,
                  axis: str = "data", *, stride: int | None = None,
                  proj_vecs=None) -> ShardedDBLSH:
    """data: (n, d) global, split into P contiguous slices, slice r built
    on ``mesh.devices[r]``.

    The hash functions come from ``proj_vecs`` when given, else they are
    drawn once from ``generator`` exactly as :func:`~.index.build` draws
    them, and every shard gets the same ones (so a 1-shard fleet equals a
    local ``build`` with the same generator).  ``stride`` sets the
    per-shard id segment width (default ``n_local``: dense ids that
    double as global data-row indices).  Pass :func:`id_stride` headroom
    when the index will take inserts and ids must survive them."""
    pn = mesh.shape[axis]
    n, d = data.shape
    if n % pn:
        raise ValueError(f"build_sharded: n = {n} does not split over {pn} shards")
    n_local = n // pn
    stride = n_local if stride is None else int(stride)
    if stride < n_local:
        raise ValueError(f"build_sharded: stride {stride} < n_local {n_local}")
    params_local = dataclasses.replace(params_local, n=n_local, d=d).resolve()
    if proj_vecs is None:
        if generator is None:
            raise ValueError("build_sharded needs either proj_vecs or a generator")
        p = params_local
        proj_vecs = hashing.sample_projections(generator, d, p.K, p.L, mesh.devices[0])
    shards = []
    for r, dev in enumerate(mesh.devices):
        part = as_tensor(data[r * n_local:(r + 1) * n_local], dev)
        shards.append(build(part, params_local, proj_vecs=as_tensor(proj_vecs, dev),
                            device=dev))
    return ShardedDBLSH(shards=shards, axis=axis, n_total=n, n_local=n_local,
                        stride=stride)


def _gather(tensors, dev: torch.device) -> torch.Tensor:
    """``all_gather``: per-shard tensors stacked on the merge device
    (device-to-device copies are queued; nothing waits on the host)."""
    return torch.stack([t.to(dev, non_blocking=True) for t in tensors])


def search_sharded(s: ShardedDBLSH, Q, k: int = 0, r0: float = 1.0,
                   steps: int = 8, mesh: Mesh | None = None, with_stats: bool = False,
                   exact: bool = False, termination=None,
                   with_explain: bool = False, dtype: str = "fp32"):
    """Replicated queries -> (Q, k) global distances/ids on the merge
    device.

    Each shard runs ``search_batch_fixed`` with engine ``torch`` (the
    reference pins the sharded path to its pure-framework engine).
    Returned ids live in the strided space ``gid = rank * stride +
    local``; unfilled slots carry the sentinel ``s.id_space`` (always
    mask on the distances — +inf marks an unfilled slot).  The merge
    keeps the k smallest distances of the P·k gathered ones, ties to the
    lowest (shard, slot) position, as ``lax.top_k`` does.

    With ``with_stats`` the per-shard probe statistics survive the merge:
    a third return aggregates them per query — ``candidates`` summed over
    shards, ``radius_steps`` their maximum (the schedule runs in lockstep,
    so the slowest shard's step count is the query's probe depth).

    ``termination`` applies *per shard*: each shard evaluates the C1/C2
    done masks over its local candidates (with ``early_exit`` each shard's
    search reads its own done mask once a step, as a local search does).
    A shard's local k-th distance upper-bounds the global k-th, so local
    C2 never fires before the global condition would.

    ``with_explain`` (implies ``with_stats``) also returns the per-shard
    EXPLAIN arrays before the max/sum collapse: ``shard_steps``,
    ``shard_slots``, ``shard_cause`` (P, Qn); ``step_slots`` (Qn, steps)
    summed over shards; ``step_half`` (steps,); and ``term_cause`` /
    ``final_radius`` (Qn,) of the critical path — the shard that ran
    deepest, ties to the lowest rank."""
    mesh = _mesh_of(s, mesh)
    p = s.params
    k = k or p.k
    n_local, stride, space = s.n_local, s.stride, s.id_space
    if with_explain:
        with_stats = True
    merge = mesh.merge_device
    Q = as_tensor(Q, merge)
    outs = []
    for r, (shard, dev) in enumerate(zip(s.shards, mesh.devices)):
        out = search_batch_fixed(
            shard, Q.to(dev, non_blocking=True), k=k, r0=r0, steps=steps,
            engine="torch", with_stats=with_stats, exact=exact,
            termination=termination, with_explain=with_explain, dtype=dtype,
            device=dev,
        )
        i = out[1]
        gi = torch.where(i < n_local, i + r * stride, space).to(torch.int32)
        outs.append((out[0], gi) + tuple(out[2:]))
    d_all = _gather([o[0] for o in outs], merge)  # (P, Qn, k)
    i_all = _gather([o[1] for o in outs], merge)
    Qn = d_all.shape[1]
    d_flat = d_all.transpose(0, 1).reshape(Qn, -1)
    i_flat = i_all.transpose(0, 1).reshape(Qn, -1)
    d2 = torch.where(torch.isfinite(d_flat), d_flat, torch.inf)
    # lax.top_k(-d, k): the k smallest, ties to the lowest position — a
    # stable ascending sort, never torch.topk (no tie order)
    vals, pos = torch.sort(d2, dim=1, stable=True)
    vals, pos = vals[:, :k], pos[:, :k]
    ids = torch.take_along_dim(i_flat, pos, dim=1)
    merged = (vals, torch.where(torch.isfinite(vals), ids, space).to(torch.int32))
    if with_stats:
        shard_steps = _gather([o[2]["radius_steps"] for o in outs], merge)
        shard_slots = _gather([o[2]["candidates"] for o in outs], merge)
        merged = merged + ({
            "radius_steps": shard_steps.amax(0),
            "candidates": shard_slots.sum(0, dtype=torch.int32),
        },)
    if with_explain:
        shard_cause = _gather([o[3]["term_cause"] for o in outs], merge)
        shard_radius = _gather([o[3]["final_radius"] for o in outs], merge)
        # critical path = the shard whose schedule ran deepest; argmax
        # takes the first maximum, the lowest rank
        crit = torch.argmax(shard_steps, dim=0)[None]  # (1, Qn)
        merged = merged + ({
            "step_half": outs[0][3]["step_half"].to(merge, non_blocking=True),
            "step_slots": _gather([o[3]["step_slots"] for o in outs], merge)
            .sum(0, dtype=torch.int32),
            "term_cause": torch.take_along_dim(shard_cause, crit, dim=0)[0],
            "final_radius": torch.take_along_dim(shard_radius, crit, dim=0)[0],
            "shard_steps": shard_steps,
            "shard_slots": shard_slots,
            "shard_cause": shard_cause,
        },)
    return merged


# --------------------------------------------------------------------------
# Sharded index maintenance over ``core.updates``.  Every shard keeps the
# same shapes: *insert* appends the batch to every shard and tombstones
# the copies on all but the routed target; *delete* translates global ids
# to (shard, local) pairs arithmetically; *compact* rebalances survivors
# across shards (runs of rows copied to their destination shard) and
# rebuilds every shard at the balanced count, padding rows tombstoned.
# Only compaction renumbers (it re-strides for the new count) and it
# returns the id map; the store layer (``store.lifecycle``) communicates
# that remap.
# --------------------------------------------------------------------------


def shard_live_counts(s: ShardedDBLSH, mesh: Mesh | None = None) -> torch.Tensor:
    """Per-shard live (non-tombstoned) point counts, shape (P,) int32 on
    the merge device — the routing signal for least-loaded insert
    placement."""
    mesh = _mesh_of(s, mesh)
    return _gather([(sh.ids_blocks[0] < sh.n).sum(dtype=torch.int32) for sh in s.shards],
                   mesh.merge_device)


def insert_sharded(s: ShardedDBLSH, new_points, target: int,
                   mesh: Mesh | None = None) -> ShardedDBLSH:
    """Append ``new_points`` (m, d) to shard ``target``.

    Every shard appends the batch (uniform shapes) and all but the target
    tombstone their copy at once, so only the target's rows are live and
    ``n_total`` becomes ``P * n_local``.  The inserted points' global ids
    are ``target * stride + n_local_old + j`` and every pre-existing id is
    untouched: ``n_local`` grows *within* the stride.  Raises when the
    batch would overflow the stride — that is the one renumbering event,
    and it belongs to :func:`compact_sharded`."""
    mesh = _mesh_of(s, mesh)
    pn = mesh.shape[s.axis]
    m = int(new_points.shape[0])
    n_old = s.n_local
    n_new = n_old + m
    if n_new > s.stride:
        raise ValueError(
            f"insert_sharded: id stride exhausted (n_local {n_old} + {m} "
            f"inserted > stride {s.stride}); compact_sharded() renumbers "
            "into a fresh stride with headroom"
        )
    target = int(target)
    shards = []
    for r, (shard, dev) in enumerate(zip(s.shards, mesh.devices)):
        grown = _updates.insert(shard, as_tensor(new_points, dev))
        if r != target:  # the target keeps its copy live
            grown = _updates.delete(
                grown, torch.arange(n_old, n_new, dtype=torch.int32, device=dev))
        shards.append(grown)
    return ShardedDBLSH(shards=shards, axis=s.axis, n_total=pn * n_new,
                        n_local=n_new, stride=s.stride)


def delete_sharded(s: ShardedDBLSH, gids, mesh: Mesh | None = None) -> ShardedDBLSH:
    """Tombstone global ids: each shard translates ``gids`` to its local
    id space (``local = g % stride`` iff ``g // stride == rank``, the
    sentinel otherwise) and runs :func:`core.updates.delete` locally.  A
    gid pointing into a shard's stride *headroom* (``g % stride >=
    n_local``) matches nothing — deleting an unallocated id is a no-op,
    like deleting a tombstone."""
    mesh = _mesh_of(s, mesh)
    n_local, stride = s.n_local, s.stride
    shards = []
    for r, (shard, dev) in enumerate(zip(s.shards, mesh.devices)):
        g = as_tensor(gids, dev, torch.int32).reshape(-1)
        local = torch.where(torch.div(g, stride, rounding_mode="floor") == r,
                            torch.remainder(g, stride), n_local)
        shards.append(_updates.delete(shard, local.to(torch.int32)))
    return ShardedDBLSH(shards=shards, axis=s.axis, n_total=s.n_total, n_local=n_local,
                        stride=stride)


def balanced_split(counts: np.ndarray, pn: int):
    """The balanced contiguous split of ``sum(counts)`` survivors (taken
    in (source shard, local id) order) over ``pn`` destination shards:
    ``(targets, src_off, dst_off)`` — per destination its count (counts
    differ by at most 1), and the survivor-ordinal offsets of the
    sources and destinations."""
    total = int(np.sum(counts))
    base, rem = divmod(total, pn)
    targets = (base + (np.arange(pn) < rem)).astype(np.int64)
    src_off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    dst_off = np.concatenate([[0], np.cumsum(targets)]).astype(np.int64)
    return targets, src_off, dst_off


def compact_sharded(
    s: ShardedDBLSH, generator, mesh: Mesh | None = None, *, headroom: float = 1.0,
    reserve: int = 0, proj_vecs=None,
) -> tuple[ShardedDBLSH, torch.Tensor]:
    """Rebalancing rebuild from survivors (fresh K/L for the new n).

    Survivors — ordered by ascending old global id (shard-major, then
    local) — are re-partitioned into *balanced* contiguous runs, one per
    destination shard (counts differ by at most 1), each run's rows
    copied to its destination, and every shard rebuilds with the *same*
    fresh hash functions (from ``proj_vecs`` when given, else drawn once
    from ``generator``: the :func:`build_sharded` invariant).  Shards
    under the balanced max pad with tombstoned zero rows.  K and L are
    re-derived for the balanced count, as the local compact does.
    ``headroom`` / ``reserve`` size the new id stride via
    :func:`id_stride` (``headroom=1.0`` keeps dense ids, matching the
    :func:`build_sharded` default).

    Returns ``(new_sharded, id_map)`` with ``id_map`` (id_space_old,)
    int32 on the merge device mapping each old global id to its new
    global id, or -1 if deleted (stride-headroom holes map to -1 too).
    New ids ascend with old ids, so a payload scattered through the map
    stays aligned."""
    mesh = _mesh_of(s, mesh)
    p = s.params
    pn = mesh.shape[s.axis]
    merge = mesh.merge_device
    # survivors per source shard, ascending local id (the host reads the
    # counts: the routing is host-side, as in the reference)
    surv = []
    for sh in s.shards:
        live = _updates.live_ids_padded(sh)
        surv.append(live[live < sh.n].long())
    counts = np.array([t.numel() for t in surv], np.int64)
    total = int(counts.sum())
    if total == 0:
        raise ValueError("compact_sharded: no live points on any shard")
    targets, src_off, dst_off = balanced_split(counts, pn)
    n_keep = int(targets.max())
    stride_new = id_stride(n_keep, headroom, reserve)
    # contiguous survivor-ordinal ranges: src shard s owns
    # [src_off[s], src_off[s+1]), dst shard r receives [dst_off[r], ...)
    lo = np.maximum(src_off[:-1, None], dst_off[None, :-1])  # (P_src, P_dst)
    hi = np.minimum(src_off[1:, None], dst_off[None, 1:])
    send_cnt = np.maximum(hi - lo, 0)
    send_start = lo - src_off[:-1, None]  # local survivor rank of run start
    # new gid of each global survivor ordinal (the renumbering itself)
    ords = np.arange(total)
    dst = np.clip(np.searchsorted(dst_off, ords, side="right") - 1, 0, pn - 1)
    newgid_by_ord = (dst * stride_new + (ords - dst_off[dst])).astype(np.int32)
    new_params = DBLSHParams.derive(
        n=n_keep, d=p.d, c=p.c, w0=p.w0, t=p.t, k=p.k,
        block_size=p.block_size, inline_vectors=p.inline_vectors,
        quant_dtype=p.quant_dtype,
    )
    if proj_vecs is None:
        proj_vecs = hashing.sample_projections(generator, p.d, new_params.K, new_params.L,
                                               merge)
    shards = []
    for r, dev in enumerate(mesh.devices):
        # the all_to_all: each source's run for this destination, in
        # source order, then zero padding rows up to the balanced max
        runs = [s.shards[src].data[surv[src][send_start[src, r]:
                                             send_start[src, r] + send_cnt[src, r]]].to(dev)
                for src in range(pn) if send_cnt[src, r] > 0]
        pad = n_keep - int(targets[r])
        if pad:
            runs.append(torch.zeros((pad, p.d), dtype=torch.float32, device=dev))
        new = build(torch.cat(runs), new_params, proj_vecs=as_tensor(proj_vecs, dev),
                    device=dev)
        if pad:
            new = _updates.delete(new, torch.arange(int(targets[r]), n_keep,
                                                    dtype=torch.int32, device=dev))
        shards.append(new)
    # old gid -> new gid over each shard's old stride segment
    id_map = torch.full((pn * s.stride,), -1, dtype=torch.int32, device=merge)
    newgid = torch.from_numpy(newgid_by_ord).to(merge)
    for src in range(pn):
        old = surv[src].to(merge) + src * s.stride
        id_map[old] = newgid[src_off[src]:src_off[src + 1]]
    return (
        ShardedDBLSH(shards=shards, axis=s.axis, n_total=pn * n_keep, n_local=n_keep,
                     stride=stride_new),
        id_map,
    )
