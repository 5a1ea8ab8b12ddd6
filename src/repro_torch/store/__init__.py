"""repro_torch.store — the vector-store service layer over the DB-LSH core.

Module map (and how it relates to the rest of the package):

* ``lifecycle``   — :class:`CollectionLifecycle`: the placement-
  independent mutable-collection protocol (version bumping, the
  auto-compaction policy, payload ride-along, calibration invalidation +
  auto re-fit, snapshot/restore plumbing); :func:`restore_collection`
  dispatches a snapshot directory from its manifest.

* ``collection``  — :class:`Collection`: the local placement — a named
  DB-LSH index + aligned payload on one device.  Wraps
  ``core.index.build`` / ``core.updates`` (insert/delete/compact) behind
  the lifecycle hooks and persists through ``checkpoint.Checkpointer``
  (``snapshot`` / ``restore``), in the reference's layout.

* ``service``     — :class:`StoreService`: the request scheduler.
  Per-tenant admission queues (token-bucket quotas, weighted
  round-robin draining) coalesce single queries into micro-batches
  padded to a fixed menu of batch shapes, issued *overlapped* — the card
  executes batch i while the host pads batch i+1, up to
  ``inflight_depth`` deep, each batch's results coming back through
  page-locked host copies behind a CUDA event — through
  ``core.serve_search.search_batch_fixed`` with engine selection
  (``torch`` | ``kernel`` | ``inline``).  Aggregates per-collection QPS /
  latency-percentile / probe-effort / cache / overlap stats and
  per-tenant admission stats.

* ``cache``       — :class:`QueryResultCache`: LRU over
  (collection, version, query, k, engine, r0, steps), rows kept as numpy
  on the host.  Collection mutations bump the version, so invalidation is
  by construction; see DESIGN.md §6 for the contract.

* ``router``      — :class:`ShardedCollection`: the same lifecycle over
  ``core.distributed`` — a fleet of per-shard indices on a single-
  controller mesh (``core.distributed.make_mesh``; shards may share a
  card), queries replicated and merged on the mesh's first device,
  strided global ids, least-loaded inserts, rebalancing compaction and
  elastic restore; :func:`open_collection` picks the placement from the
  data's size (``max_points_per_shard``).

Relation to neighbors: ``repro_torch.tune`` supplies query *planning*:
a Collection carries a ``search_policy`` and a persisted calibration
table (``Collection.calibrate``), and the service resolves submit-time
policies / ``recall_target=`` through the planner into a concrete (r0,
steps, adaptive-termination) plan per request — request > collection >
service, like engine defaults (DESIGN.md §8).

Typical use::

    from repro_torch.store import Collection, StoreService, restore_collection

    gen = torch.Generator("cuda").manual_seed(0)
    col = Collection.create("docs", gen, data, c=1.5, k=10,
                            inline_vectors=True, engine="inline")
    svc = StoreService(batch_shapes=(1, 4, 16, 64), default_k=10, r0=0.5)
    svc.attach(col)
    ticket = svc.submit("docs", q)     # single query -> micro-batched
    svc.flush()
    print(ticket.dists, ticket.ids, svc.stats("docs"))
    dists, ids, tickets = svc.serve("docs", queries)  # a matrix, row by row
    col.add(more_points)               # new version: cached rows stop matching
    col.snapshot("snapshots/docs")
    col2 = restore_collection("snapshots/docs")

    from repro_torch.core.distributed import make_mesh
    fleet = open_collection("big", gen, big_data, mesh=make_mesh(4),
                            max_points_per_shard=1_000_000, c=1.5, k=10)
    fleet.snapshot("snapshots/big")
    fleet2 = restore_collection("snapshots/big", mesh=make_mesh(2))  # elastic
"""

from .cache import CachedResult, QueryResultCache
from .collection import Collection
from .lifecycle import (
    CollectionLifecycle,
    CollectionStats,
    CompactionPolicy,
    restore_collection,
    version_clock,
)
from .router import ShardedCollection, open_collection
from .service import (
    BrownoutShed,
    DeadlineExceeded,
    DispatchFailed,
    QueryRequest,
    QuotaExceeded,
    StoreService,
    TenantQuota,
)

__all__ = [
    "BrownoutShed",
    "CachedResult",
    "Collection",
    "CollectionLifecycle",
    "CollectionStats",
    "CompactionPolicy",
    "DeadlineExceeded",
    "DispatchFailed",
    "QueryRequest",
    "QueryResultCache",
    "QuotaExceeded",
    "ShardedCollection",
    "StoreService",
    "TenantQuota",
    "open_collection",
    "restore_collection",
    "version_clock",
]
