"""repro_torch.store — the vector-store layer over the DB-LSH core.

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

The request scheduler (``StoreService``), its result cache and the
sharded placement (``ShardedCollection``, ``open_collection``) are not
ported yet.

Typical use::

    from repro_torch.store import Collection, restore_collection
    from repro_torch.tune import RecallTarget

    gen = torch.Generator("cuda").manual_seed(0)
    col = Collection.create("docs", gen, data, c=1.5, k=10,
                            inline_vectors=True, engine="inline")
    dists, ids = col.search(queries, k=10, r0=0.5, steps=8)
    new_ids = col.add(more_points)
    col.remove(new_ids[:10])
    col.calibrate(held_out, steps_max=8)
    plan = col.plan(RecallTarget(0.9))
    dists, ids = col.search(queries, r0=plan.r0, steps=plan.steps,
                            termination=plan.termination)
    col.snapshot("snapshots/docs")
    col2 = restore_collection("snapshots/docs")
"""

from .collection import Collection
from .lifecycle import (
    CollectionLifecycle,
    CollectionStats,
    CompactionPolicy,
    restore_collection,
    version_clock,
)

__all__ = [
    "Collection",
    "CollectionLifecycle",
    "CollectionStats",
    "CompactionPolicy",
    "restore_collection",
    "version_clock",
]
