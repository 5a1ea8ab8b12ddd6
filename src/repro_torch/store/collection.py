"""Named vector collections: the local placement of the store lifecycle.

A :class:`Collection` owns one :class:`~repro_torch.core.index.DBLSHIndex`
plus an optional *payload* tensor aligned row-for-row with the indexed
vectors (token ids, document ids, metadata rows — anything that should
ride along with a returned neighbor id), both on one device.

The managed lifecycle itself — version bumping, the auto-compaction
policy, payload ride-along, calibration invalidation, snapshot/restore
plumbing — lives in
:class:`~repro_torch.store.lifecycle.CollectionLifecycle`.  This class
supplies the single-device mechanics over ``core.updates``:

* ``add`` / ``remove`` delegate to ``core.updates.insert`` / ``delete``;
* ``compact`` rebuilds through ``core.updates.compact`` with freshly
  derived K/L (K ~ log n was sized for the build-time ``n``, see
  DESIGN.md §3-§4);
* ``snapshot`` / ``restore`` persist the index arrays through
  ``checkpoint.Checkpointer``'s atomic step directories, in the
  reference's layout: a snapshot written by ``repro.store.Collection``
  restores here.

Every mutation advances a **version** drawn from a process-wide
monotonic clock — the cache-invalidation token for the store layer
(DESIGN.md §6); ``restore`` deliberately assigns a *fresh* version so
diverged histories can never alias each other's cache entries.

Repeated small ``add`` calls append padded STR blocks per call; the waste
is bounded by ``block_size - 1`` slots per add per table and is reclaimed
at the next compaction.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..checkpoint import Checkpointer
from ..core import DBLSHParams, build, from_arrays, search_batch_fixed, validate_engine
from ..core import updates as _updates
from ..core.index import DBLSHIndex
from ..device import as_tensor, resolve_device
from ..tune import planner as _planner
from .lifecycle import (
    _INDEX_ARRAY_FIELDS,
    CollectionLifecycle,
    CollectionStats,
    CompactionPolicy,
    version_clock,
)

__all__ = ["CompactionPolicy", "CollectionStats", "Collection", "version_clock"]


def _snapshot_keys(meta: dict, n_leaves: int) -> list[str]:
    """The leaves of a local snapshot whose manifest names none (one the
    reference wrote): the index fields, the key and, with
    ``meta["has_payload"]``, the payload.  Snapshots from before the norm
    cache have one leaf fewer and no ``norm_blocks``."""
    keys = [*_INDEX_ARRAY_FIELDS, "prng_key"]
    if meta.get("has_payload"):
        keys.append("payload")
    if n_leaves == len(keys) - 1:
        keys.remove("norm_blocks")
    return keys


class Collection(CollectionLifecycle):
    """A named DB-LSH index + payload with a managed lifecycle."""

    placement = "local"

    def __init__(self, name: str, index: DBLSHIndex, **kw):
        self.index = index
        super().__init__(name, **kw)

    @property
    def device(self) -> torch.device:
        return self.index.device

    def _validate_default_engine(self, engine: str | None) -> str | None:
        if engine is not None:
            validate_engine(engine)
            if engine == "inline" and not self.index.params.inline_vectors:
                raise ValueError(
                    f"collection {self.name!r}: engine='inline' needs an index "
                    "built with inline_vectors=True (the fused kernel streams "
                    "the per-table vector copy)"
                )
        return engine

    # ------------------------------------------------------------ construction
    @classmethod
    def create(
        cls,
        name: str,
        generator: torch.Generator,
        data,
        *,
        params: DBLSHParams | None = None,
        payload=None,
        policy: CompactionPolicy | None = None,
        engine: str | None = None,
        search_policy=None,
        device=None,
        **derive_kw,
    ) -> "Collection":
        """Build a fresh index over ``data`` on ``device`` (the CUDA device
        when None; params derived if omitted).  The hash functions are
        drawn from ``generator``, then the collection's compaction key
        (two 32-bit words, see ``store.lifecycle``).  ``engine`` sets the
        collection's default verify engine; ``search_policy`` its default
        query-planning policy (a ``repro_torch.tune`` ``RecallTarget`` /
        ``LatencyBudget`` / ``FixedSchedule`` — run :meth:`calibrate` to
        back the outcome-level policies with a measured table)."""
        device = resolve_device(device)
        data = as_tensor(data, device)
        if params is None:
            params = DBLSHParams.derive(
                n=data.shape[0], d=data.shape[1], **derive_kw
            )
        index = build(data, params, generator=generator, device=device)
        key = torch.randint(0, 1 << 32, (2,), generator=generator,
                            device=generator.device)
        return cls(name, index, payload=payload, policy=policy, key=key,
                   engine=engine, search_policy=search_policy)

    @classmethod
    def from_index(
        cls, name: str, index: DBLSHIndex, *, payload=None,
        policy: CompactionPolicy | None = None, key=None,
        engine: str | None = None,
    ) -> "Collection":
        """Wrap an already-built index (it stays on its device)."""
        return cls(name, index, payload=payload, policy=policy, key=key,
                   engine=engine)

    # -------------------------------------------------------------- properties
    @property
    def n(self) -> int:
        """Indexed rows including tombstones and pre-compaction growth."""
        return self.index.n

    @property
    def d(self) -> int:
        return self.index.data.shape[1]

    def live_count(self) -> int:
        return _updates.live_count(self.index)

    # -------------------------------------------------------- placement hooks
    def _insert(self, points, payload) -> np.ndarray:
        m = points.shape[0]
        # int32 end to end: search results, id maps, and delete all speak
        # int32, so returned ids round-trip without re-casting
        ids = np.arange(self.n, self.n + m, dtype=np.int32)
        self.index = _updates.insert(self.index, points)
        if payload is not None:
            self.payload = torch.cat([self.payload, payload.to(self.payload.dtype)])
        return ids

    def _delete(self, ids) -> None:
        self.index = _updates.delete(self.index, ids)

    def _compact_impl(self, generator) -> torch.Tensor:
        self.index, id_map = _updates.compact(self.index, generator=generator)
        return id_map

    def _calibrate_impl(self, queries, *, k, r0, steps_max, engine, measure_ms):
        # ground the oracle on live rows only: tombstoned rows cannot be
        # returned, so leaving them in would under-measure recall
        ids0 = self.index.ids_blocks[0]
        live = torch.unique(ids0[ids0 < self.index.n])
        return _planner.calibrate(
            self.index, queries, k=k, r0=r0, steps_max=steps_max,
            engine=engine or self.default_engine or "torch",
            measure_ms=measure_ms,
            oracle_rows=None if live.numel() == self.index.n else live,
        )

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
        """Batched (c,k)-ANN through the fixed-schedule serving path, on
        the collection's device.

        ``engine=None`` resolves to the collection's ``default_engine``
        (falling back to 'torch'). ``rows`` is the number of *real* query
        rows when ``Q`` carries padding; the query counter advances by
        ``rows``, not the padded shape.  The returned tensors may still
        be computing on the card — nothing here waits, so a caller may
        overlap host work with the search (DESIGN.md §6).
        ``with_explain`` (implies ``with_stats``) appends the per-query
        per-step EXPLAIN arrays — see
        :func:`~repro_torch.core.serve_search.search_batch_fixed`.
        ``dtype`` ('fp32'/'bf16'/'int8') selects the distance precision;
        the quantized paths need an index built with the matching
        ``quant_dtype`` and are a shortlist + exact fp32 re-rank, so the
        returned distances are always exact fp32.
        """
        Q = torch.atleast_2d(as_tensor(Q, self.device))
        self._count_queries(Q, rows)
        return search_batch_fixed(
            self.index, Q, k=k, r0=r0, steps=steps,
            engine=engine or self.default_engine or "torch",
            with_stats=with_stats, exact=exact, termination=termination,
            with_explain=with_explain, dtype=dtype, device=self.device,
        )

    # ------------------------------------------------------------ persistence
    def _snapshot_arrays(self) -> dict:
        return {
            f: getattr(self.index, f).cpu().numpy() for f in _INDEX_ARRAY_FIELDS
        }

    def _snapshot_meta(self) -> dict:
        return {"params": dataclasses.asdict(self.index.params)}

    @classmethod
    def restore(cls, directory: str, step: int | None = None, *,
                device=None) -> "Collection":
        """Restore a local snapshot (the port's or the reference's) onto
        ``device`` (the CUDA device when None).  The quantized blocks are
        derived state, never persisted: they are re-quantized from the
        float32 truth; a snapshot from before the norm cache gets its
        ``norm_blocks`` rebuilt."""
        device = resolve_device(device)
        tree, meta = Checkpointer(directory).restore(step, keys=_snapshot_keys)
        if meta.get("placement", "local") != "local":
            raise NotImplementedError(
                f"snapshot at {directory!r} is {meta['placement']!r}: the "
                "sharded placement is not ported to repro_torch yet "
                "(ROADMAP item A15)"
            )
        index = from_arrays(
            {f: tree[f] for f in _INDEX_ARRAY_FIELDS if f in tree},
            meta["params"], device=device,
        )
        return cls(meta["name"], index,
                   **cls._common_restore_kwargs(tree, meta))
