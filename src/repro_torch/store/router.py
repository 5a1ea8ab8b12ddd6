"""Shard-aware routing: the full Collection lifecycle over
``core.distributed``.

A dataset too large for one device shards over a mesh's axis: every
shard builds a local DB-LSH index with the *same* LSH functions
(``core.distributed.build_sharded``), queries replicate, and the
per-shard top-k merge on the merge device into globally-id'd results.
:class:`ShardedCollection` implements the same mutable lifecycle
protocol as a local :class:`~repro_torch.store.collection.Collection`
(``store.lifecycle.CollectionLifecycle``): ``add`` routes inserts to the
least-loaded shard, ``remove`` translates global ids per shard,
``compact`` rebalances survivors across shards and rebuilds with a
global id remap, and ``snapshot`` / ``restore(mesh=...)`` persist the
whole state — elastically: a snapshot taken on P shards restores onto
any shard count — so a :class:`~repro_torch.store.service.StoreService`
serves both placements through one admission queue, one
cache-invalidation contract, and one policy/engine resolution path.

:func:`open_collection` is the router decision point: it places data on
a single device when it fits (``max_points_per_shard``), otherwise fans
out over the mesh — the lifecycle options (``policy``, ``engine``,
``search_policy``) apply to whichever placement wins.

**Id contract** (DESIGN.md §9): global ids are *strided*,
``gid = rank * stride + local`` with per-shard headroom
(``stride >= n_local``, sized by the compaction policy's growth ratio).
That keeps the merge's disjoint-id invariant AND makes ids durable
handles: an ``add`` grows ``n_local`` inside the stride, so every
existing id survives untouched.  Only ``compact`` renumbers — when the
policy fires, when called explicitly, or when an ``add`` would overflow
the stride — and it returns the id map exactly like the local
placement.  Elastic ``restore`` onto a different shard count also
renumbers (the manifest's geometry is P-specific); derive fresh ids
from searches after one.

Snapshots keep the reference's global layout (block fields concatenated
over shards, ``data`` concatenated, ``proj_vecs`` once) and meta
(``axis``, ``shards``, ``n_local``, ``n_total``, ``stride``): a sharded
snapshot the reference wrote restores here.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import torch

from ..checkpoint import Checkpointer
from ..core import DBLSHParams
from ..core.distributed import (
    Mesh,
    ShardedDBLSH,
    balanced_split,
    build_sharded,
    compact_sharded,
    delete_sharded,
    from_global_arrays,
    id_stride,
    insert_sharded,
    search_sharded,
    shard_live_counts,
)
from ..device import as_tensor
from ..resilience import faults
from ..tune import planner as _planner
from .collection import Collection, _snapshot_keys
from .lifecycle import CollectionLifecycle, CompactionPolicy, split_key

__all__ = ["ShardedCollection", "open_collection"]


class ShardedCollection(CollectionLifecycle):
    """A collection fanned out over the mesh ``axis`` — same mutable
    lifecycle as :class:`~repro_torch.store.collection.Collection`.

    The payload stays global, on the merge device: it is indexed by
    *global* ids after the top-k merge, which is exactly what
    ``search_sharded`` returns.  Mutations draw versions from the same
    process-wide clock as local collections, so the service result cache
    invalidates sharded updates identically (DESIGN.md §6).
    """

    placement = "sharded"

    def __init__(self, name: str, sharded: ShardedDBLSH, mesh: Mesh, **kw):
        self.sharded = sharded
        self.mesh = mesh
        # the sharded path always verifies through the torch engine;
        # ``fixed_engine`` tells the StoreService's engine resolution to
        # ignore request/collection/service preferences entirely, so
        # tickets and cache keys reflect the engine that actually ran
        self.fixed_engine = "torch"
        # set transiently by _insert when a batch would overflow the id
        # stride, so the forced compact re-strides with room for it
        self._stride_reserve = 0
        payload = kw.get("payload")
        if payload is not None:
            payload = self._payload_tensor(payload)
            if (payload.shape[0] == sharded.n_total
                    and sharded.n_total != self.id_space):
                # a dense one-row-per-point payload (the create()
                # convention): expand it into the strided id layout — row
                # for gid g at buffer index g, headroom holes zero
                payload = self._expand_payload(payload)
            kw = dict(kw, payload=payload)
        super().__init__(name, **kw)

    @property
    def device(self) -> torch.device:
        """The merge device: results, the payload and id maps live here."""
        return self.mesh.merge_device

    def _expand_payload(self, dense: torch.Tensor) -> torch.Tensor:
        """Dense (n_total, ...) payload -> strided (id_space, ...)."""
        s = self.sharded
        row = torch.arange(s.n_total, device=dense.device)
        gid = torch.div(row, s.n_local, rounding_mode="floor") * s.stride + row % s.n_local
        buf = torch.zeros((self.id_space,) + tuple(dense.shape[1:]), dtype=dense.dtype,
                          device=dense.device)
        buf[gid] = dense
        return buf

    def _validate_default_engine(self, engine: str | None) -> str | None:
        if engine not in (None, "torch"):
            raise ValueError(
                f"collection {self.name!r}: sharded collections verify per "
                f"shard through the torch engine; engine={engine!r} cannot be "
                "honored (fixed_engine pins service resolution)"
            )
        return engine

    @classmethod
    def create(
        cls,
        name: str,
        generator: torch.Generator,
        data,
        mesh: Mesh,
        *,
        axis: str = "data",
        params: DBLSHParams | None = None,
        payload=None,
        policy: CompactionPolicy | None = None,
        engine: str | None = None,
        search_policy=None,
        **derive_kw,
    ) -> "ShardedCollection":
        """Build a fleet over ``data`` on ``mesh``: the hash functions are
        drawn once from ``generator`` (as ``Collection.create`` draws
        them), then the collection's compaction key — so a 1-shard fleet
        equals a local collection made with the same generator."""
        n, d = data.shape
        pn = mesh.shape[axis]
        if params is None:
            # size K/L for the per-shard n: each shard answers locally
            params = DBLSHParams.derive(n=n // pn, d=d, **derive_kw)
        # id stride with insert headroom: the growth trigger fires at
        # growth_ratio * built n, so sizing the stride to the same ratio
        # means a well-behaved policy compacts before the stride ever
        # forces a renumber
        pol = policy or CompactionPolicy()
        stride = id_stride(n // pn, cls._headroom(pol))
        sharded = build_sharded(generator, data, params, mesh, axis=axis, stride=stride)
        key = torch.randint(0, 1 << 32, (2,), generator=generator, device=generator.device)
        return cls(name, sharded, mesh, payload=payload, policy=policy, key=key,
                   engine=engine, search_policy=search_policy)

    @staticmethod
    def _headroom(policy: CompactionPolicy) -> float:
        """Stride headroom factor: track the growth trigger, floored so
        a no-growth policy still leaves real insert room."""
        return max(float(policy.growth_ratio), 1.25)

    # ---------------------------------------------------------------- surface
    @property
    def n(self) -> int:
        return self.sharded.n_total

    @property
    def d(self) -> int:
        return self.sharded.d

    @property
    def id_space(self) -> int:
        return self.sharded.id_space

    def live_count(self) -> int:
        return int(self.shard_counts().sum())

    def shard_counts(self) -> np.ndarray:
        """Per-shard live point counts (P,) — the insert-routing signal."""
        return shard_live_counts(self.sharded, self.mesh).cpu().numpy()

    def _occupancy(self) -> tuple[int, int]:
        counts = self.shard_counts()  # one device read serves both
        live = int(counts.sum())
        pn = int(counts.shape[0])
        # compaction rebalances, so the attainable n is the balanced
        # ceiling — imbalance alone justifies a rebuild when it leaves the
        # fleet hollow enough to trip the policy
        return live, pn * -(-live // pn)

    # -------------------------------------------------------- placement hooks
    def _insert(self, points, payload) -> np.ndarray:
        m = int(points.shape[0])
        if self.sharded.n_local + m > self.sharded.stride:
            # the stride is the id contract's renumbering boundary: ids
            # are stable until the headroom is exhausted, then one
            # compact() renumbers and re-strides with room for this batch
            self._stride_reserve = m
            try:
                self.compact()
            finally:
                self._stride_reserve = 0
        target = int(np.argmin(self.shard_counts()))  # least-loaded shard
        s = self.sharded
        n_old = s.n_local
        self.sharded = insert_sharded(s, points, target, mesh=self.mesh)
        base = target * s.stride + n_old
        if self.payload is not None:
            # ids are stable, so the strided payload layout is too: the
            # batch lands in the target's headroom, one in-place write
            self.payload[base:base + m] = payload.to(self.payload.dtype)
        return base + np.arange(m, dtype=np.int32)

    def _delete(self, ids) -> None:
        self.sharded = delete_sharded(self.sharded, ids, mesh=self.mesh)

    def _compact_impl(self, generator) -> torch.Tensor:
        self.sharded, id_map = compact_sharded(
            self.sharded, generator, self.mesh,
            headroom=self._headroom(self.policy),
            reserve=self._stride_reserve,
        )
        return id_map

    def _calibrate_impl(self, queries, *, k, r0, steps_max, engine, measure_ms):
        del engine  # per-shard verify is pinned to the torch engine
        kk = k or self.sharded.params.k

        def search_fn(Q, r0, steps, with_stats=False):
            return search_sharded(self.sharded, Q, k=kk, r0=r0, steps=steps,
                                  mesh=self.mesh, with_stats=with_stats)

        rows, gids = self._live_rows_and_ids()
        # the planner reads the params, the device and the (global) data
        # of the oracle from this view
        view = types.SimpleNamespace(
            params=self.sharded.params, device=self.device,
            data=torch.cat([sh.data.to(self.device) for sh in self.sharded.shards]),
        )
        return _planner.calibrate(
            view, queries, k=kk, r0=r0, steps_max=steps_max,
            measure_ms=measure_ms, search_fn=search_fn,
            oracle_rows=rows, oracle_ids=gids,
        )

    def _live_rows_and_ids(self) -> tuple[np.ndarray | None, np.ndarray | None]:
        """Live points as ``(data_rows, gids)`` — the calibration oracle
        needs both: brute force runs over data *rows* while the search
        reports strided *gids*, and the two spaces coincide only in the
        dense, fully-live case (then ``(None, None)``: use everything).
        The oracle must exclude dead rows: a sharded insert leaves P-1
        tombstoned replicas of every point at identical coordinates, and
        compaction padding adds zero rows — none of them returnable."""
        s = self.sharded
        rows, gids = [], []
        for r, sh in enumerate(s.shards):
            loc = np.unique(sh.ids_blocks[0].cpu().numpy())
            loc = loc[loc < s.n_local]
            rows.append(loc + r * s.n_local)
            gids.append(loc + r * s.stride)
        rows = np.concatenate(rows)
        if rows.size == s.n_total and s.stride == s.n_local:
            return None, None
        return rows, np.concatenate(gids)

    # ------------------------------------------------------------------ reads
    def search(
        self,
        Q,
        k: int = 0,
        *,
        r0: float = 1.0,
        steps: int = 8,
        engine: str | None = None,
        with_stats: bool = False,
        rows: int | None = None,
        exact: bool = False,
        termination=None,
        with_explain: bool = False,
        dtype: str = "fp32",
    ):
        """Global (c,k)-ANN: per-shard fixed-schedule search + the top-k
        merge on the merge device.  ``engine`` is accepted for API parity;
        the sharded path always verifies through the torch engine.
        ``rows`` (real rows in a service-padded batch) advances the query
        counter like the local placement.  With ``with_stats`` the
        per-shard probe statistics survive the merge (candidates summed,
        radius_steps maxed), so ``svc.stats()`` reports real per-query
        probe effort.  ``termination`` applies per shard.
        ``with_explain`` appends the per-step EXPLAIN arrays *with
        per-shard attribution* (see ``search_sharded``).  ``dtype``
        selects the per-shard distance precision ('fp32'/'bf16'/'int8'):
        each shard runs the quantized shortlist + exact re-rank locally,
        so the merge always compares fp32 distances.  Nothing here waits
        for the card."""
        del engine
        Q = torch.atleast_2d(as_tensor(Q, self.device))
        self._count_queries(Q, rows)
        k = k or self.sharded.params.k
        # shard.straggle: one slow shard stalls the merge — injected here
        # (a no-op without an installed FaultPlan) so the service's EWMA
        # straggler monitor sees it as a slow batch
        faults.fire("shard.straggle", collection=self.name, scale=steps)
        return search_sharded(
            self.sharded, Q, k=k, r0=r0, steps=steps, mesh=self.mesh,
            with_stats=with_stats, exact=exact, termination=termination,
            with_explain=with_explain, dtype=dtype,
        )

    # ------------------------------------------------------------ persistence
    def _snapshot_arrays(self) -> dict:
        # the manifest stores the *global* layout plus the shard geometry
        # (shards / n_local / stride) needed either to re-place it
        # bit-for-bit on an equal mesh or to migrate it onto a different
        # shard count (elastic restore)
        return self.sharded.global_arrays()

    def _snapshot_meta(self) -> dict:
        s = self.sharded
        return {
            "params": dataclasses.asdict(s.params),
            "axis": s.axis,
            "shards": int(self.mesh.shape[s.axis]),
            "n_local": s.n_local,
            "n_total": s.n_total,
            "stride": s.stride,
        }

    @classmethod
    def restore(
        cls, directory: str, *, mesh: Mesh, step: int | None = None,
        migrate: bool | None = None,
    ) -> "ShardedCollection":
        """Re-place a sharded snapshot (the port's or the reference's)
        onto ``mesh``.

        On an equal shard count the persisted per-shard layout is placed
        back verbatim (bit-identical restore; the quantized blocks are
        re-derived per shard).  Onto a *different* shard count the fleet
        is elastic: live rows are extracted from the manifest,
        re-partitioned balanced over the new mesh (the same
        balanced-contiguous split compaction uses), and rebuilt per shard
        — which renumbers global ids and invalidates any fitted
        calibration.  ``migrate=True`` forces the migration path even at
        equal shard counts (a rebalancing restore); ``migrate=False``
        demands the bit-identical path and raises on a shard-count
        mismatch."""
        tree, meta = Checkpointer(directory).restore(step, keys=_snapshot_keys)
        if meta.get("placement", "local") != "sharded":
            raise ValueError(
                f"snapshot at {directory!r} is local: restore it with "
                "Collection.restore() or repro_torch.store.restore_collection()"
            )
        axis = meta["axis"]
        pn = int(meta["shards"])
        if migrate is None:
            migrate = int(mesh.shape[axis]) != pn
        if migrate:
            return cls._restore_migrated(tree, meta, mesh)
        if mesh.shape[axis] != pn:
            raise ValueError(
                f"snapshot was taken on {pn} shards over {axis!r} but the "
                f"mesh has {mesh.shape[axis]} and migrate=False: the "
                "per-shard layout is P-specific — allow migration or "
                "restore onto an equal mesh"
            )
        n_local = int(meta["n_local"])
        sharded = from_global_arrays(
            tree, meta["params"], mesh, axis=axis, n_total=int(meta["n_total"]),
            n_local=n_local,
            # pre-stride snapshots carry dense ids
            stride=int(meta.get("stride", n_local)),
        )
        return cls(meta["name"], sharded, mesh, **cls._common_restore_kwargs(tree, meta))

    @classmethod
    def _restore_migrated(cls, tree, meta, mesh: Mesh) -> "ShardedCollection":
        """Elastic restore: manifest rows -> balanced rebuild on ``mesh``.

        Survivor extraction and re-partitioning run on the host from the
        manifest; the balanced split is the one :func:`compact_sharded`
        uses, so the restored fleet meets the same imbalance bound
        (counts differ by at most 1).  Global ids are renumbered; payload
        rows follow their points through the old->new gid map.  The new
        hash functions are drawn from the advanced compaction key."""
        axis = meta["axis"]
        pn_old = int(meta["shards"])
        n_local = int(meta["n_local"])
        stride_old = int(meta.get("stride", n_local))
        pn = int(mesh.shape[axis])
        p_old = DBLSHParams(**meta["params"])
        # live (local id, data row, gid) per old shard, from table 0 of
        # the persisted blocks — ascending gid order, like compaction
        blocks = np.asarray(tree["ids_blocks"])[0].reshape(pn_old, -1)
        data = np.asarray(tree["data"]).reshape(pn_old, n_local, -1)
        rows, old_gids = [], []
        for r in range(pn_old):
            loc = np.unique(blocks[r])
            loc = loc[loc < n_local]
            rows.append(data[r, loc])
            old_gids.append(loc + r * stride_old)
        surv = np.concatenate(rows)
        old_gids = np.concatenate(old_gids)
        total = int(surv.shape[0])
        if total == 0:
            raise ValueError("restore: snapshot holds no live points")
        targets, _, dst_off = balanced_split(np.array([total]), pn)
        n_keep = int(targets.max())
        kw = cls._common_restore_kwargs(tree, meta)
        stride = id_stride(n_keep, cls._headroom(kw["policy"]))
        padded = np.zeros((pn * n_keep, surv.shape[1]), np.float32)
        new_gids = np.empty(total, np.int64)
        for r in range(pn):
            seg = surv[dst_off[r]:dst_off[r + 1]]
            padded[r * n_keep:r * n_keep + seg.shape[0]] = seg
            new_gids[dst_off[r]:dst_off[r + 1]] = r * stride + np.arange(seg.shape[0])
        params = DBLSHParams.derive(
            n=n_keep, d=p_old.d, c=p_old.c, w0=p_old.w0, t=p_old.t,
            k=p_old.k, block_size=p_old.block_size,
            inline_vectors=p_old.inline_vectors,
            quant_dtype=p_old.quant_dtype,
        )
        kw["key"], seed = split_key(kw["key"])
        gen = torch.Generator(device=mesh.merge_device).manual_seed(seed)
        sharded = build_sharded(gen, padded, params, mesh, axis=axis, stride=stride)
        pad_gids = np.concatenate([
            r * stride + np.arange(int(targets[r]), n_keep) for r in range(pn)
        ])
        if pad_gids.size:
            sharded = delete_sharded(sharded, pad_gids.astype(np.int32), mesh=mesh)
        if kw["payload"] is not None:
            pay = np.asarray(kw["payload"])
            buf = np.zeros((pn * stride,) + pay.shape[1:], pay.dtype)
            buf[new_gids] = pay[old_gids]
            kw["payload"] = buf
        # the geometry changed: the old growth baseline and fitted
        # schedule table describe an index that no longer exists
        kw["built_n"] = pn * n_keep
        kw["calibration"] = None
        return cls(meta["name"], sharded, mesh, **kw)


def open_collection(
    name: str,
    generator: torch.Generator,
    data,
    *,
    mesh: Mesh | None = None,
    axis: str = "data",
    max_points_per_shard: int = 1_000_000,
    payload=None,
    policy: CompactionPolicy | None = None,
    engine: str | None = None,
    search_policy=None,
    device=None,
    **derive_kw,
):
    """Route a dataset to local or sharded placement.

    Local :class:`Collection` when ``data`` fits one device (or no mesh
    given) — on ``device``, else the mesh's first device, else the CUDA
    device; :class:`ShardedCollection` fan-out over ``mesh`` when it has
    more than one shard and ``n > max_points_per_shard``.  The lifecycle
    options apply to either placement.  ``engine`` must be None or
    'torch' on the sharded path (per-shard verification is pinned to
    torch) — it is validated, never silently dropped."""
    # the shape alone routes: nothing is moved to the host to count it
    n = data.shape[0]
    if mesh is not None and mesh.shape[axis] > 1 and n > max_points_per_shard:
        return ShardedCollection.create(
            name, generator, data, mesh, axis=axis, payload=payload, policy=policy,
            engine=engine, search_policy=search_policy, **derive_kw
        )
    if device is None and mesh is not None:
        device = mesh.merge_device
    return Collection.create(
        name, generator, data, payload=payload, policy=policy, engine=engine,
        search_policy=search_policy, device=device, **derive_kw
    )
