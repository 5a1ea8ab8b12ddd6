"""The collection lifecycle protocol: one mutable contract for every placement.

:class:`CollectionLifecycle` holds the placement-independent machinery
of a mutable collection; :class:`~repro_torch.store.collection.Collection`
(the local placement) implements its hooks:

* **version bumping** — every mutation draws a fresh version from the
  process-wide :data:`version_clock`, the cache-invalidation token a
  serving layer keys on (DESIGN.md §6);
* **compaction accounting** — :class:`CompactionPolicy` triggers
  (growth past the built K/L sizing, hollowness from tombstones) and the
  ``add``/``remove``/``compact`` templates that apply them;
* **payload ride-along** — payload rows stay aligned through inserts
  and are permuted through the compaction id map (scatter by new id);
* **calibration** — :meth:`calibrate` fits and stores the
  ``repro_torch.tune`` schedule table; ``compact`` *invalidates* it (the
  rebuild re-derives K/L and reshapes the recall/cost curves) and
  auto-refits when the calibration queries were retained
  (``calibrate(..., retain=True)``);
* **snapshot / restore plumbing** — the reference's manifest layout
  (``meta["placement"]`` tags the placement), persisting index arrays,
  payload, the compaction key, policy, counters, version, engine
  default, search policy, and schedule table through
  ``checkpoint.Checkpointer``'s atomic step directories.

**The compaction key.**  The reference keeps a ``jax.random`` key,
splits it at each compaction and persists its ``key_data`` (``uint32[2]``)
as the snapshot's ``prng_key``.  The port keeps a ``uint32[2]`` state of
the same shape and dtype: at each compaction it advances the state as a
SplitMix64 counter (the state, read as one 64-bit integer, plus the
golden-ratio increment) and seeds the compaction's ``torch.Generator``
with the mixed state.  A restored snapshot's key, the reference's
included, therefore makes the next compactions deterministic; it does
not reproduce JAX's random projections, which no ``torch.Generator``
can.

Placements supply only the index mechanics, via the ``_insert`` /
``_delete`` / ``_compact_impl`` / ``_calibrate_impl`` /
``_snapshot_arrays`` / ``_snapshot_meta`` hooks plus the ``n`` / ``d`` /
``live_count`` / ``search`` surface.  :func:`restore_collection`
dispatches a snapshot directory to its placement from the manifest
alone.  The sharded placement is not ported yet: a sharded snapshot
raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..checkpoint import Checkpointer, CorruptSnapshot
from ..core import validate_engine
from ..device import as_tensor
from ..obs.trace import get_tracer
from ..tune import planner as _planner
from ..tune.planner import ScheduleTable
from ..tune.policy import (
    ResolvedPlan,
    policy_from_dict,
    policy_to_dict,
    resolve_policy,
)

__all__ = [
    "CollectionLifecycle",
    "CompactionPolicy",
    "CollectionStats",
    "restore_collection",
    "version_clock",
]


class _VersionClock:
    """Process-wide monotonic source of collection versions.

    A plain per-collection counter would alias: two collections restored
    from the same snapshot both sit at version v yet may diverge, and a
    cache keyed on (name, v) would serve one the other's results.  A
    single process-wide clock makes every (mutation, restore) event
    globally unique, so version equality implies state equality.
    """

    def __init__(self):
        self._v = 0

    def next(self) -> int:
        self._v += 1
        return self._v

    def advance_past(self, v: int) -> int:
        """A fresh version strictly greater than both ``v`` and anything
        already handed out (used by restore)."""
        self._v = max(self._v, int(v))
        return self.next()


version_clock = _VersionClock()

_INDEX_ARRAY_FIELDS = (
    "proj_vecs",
    "proj_blocks",
    "ids_blocks",
    "mbr_lo",
    "mbr_hi",
    "data",
    "vec_blocks",
    "norm_blocks",
)

_M64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15


def _mix64(z: int) -> int:
    """SplitMix64's output function."""
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def split_key(key) -> tuple[np.ndarray, int]:
    """``(next key, seed)`` from a ``uint32[2]`` key: the state advanced
    by one SplitMix64 step, and the 63-bit seed it yields (see the module
    docstring)."""
    k = np.asarray(key, np.uint32).reshape(2)
    state = (((int(k[0]) << 32) | int(k[1])) + _GOLDEN) & _M64
    nxt = np.array([state >> 32, state & 0xFFFFFFFF], np.uint32)
    return nxt, _mix64(state) >> 1


def _key_from(key) -> np.ndarray:
    """A key as the ``uint32[2]`` state (``None``: zeros, the key data of
    the reference's default ``jax.random.key(0)``)."""
    if key is None:
        return np.zeros(2, np.uint32)
    if isinstance(key, torch.Tensor):
        key = key.cpu().numpy()
    return np.asarray(key).astype(np.uint32).reshape(2)


@dataclasses.dataclass(frozen=True)
class CompactionPolicy:
    """When to rebuild. ``auto=False`` disables the triggers (manual
    ``compact()`` still works)."""

    growth_ratio: float = 2.0    # compact when n >= ratio * last-built n
    min_live_ratio: float = 0.5  # compact when live/n drops below this
    auto: bool = True


@dataclasses.dataclass
class CollectionStats:
    inserted: int = 0
    deleted: int = 0
    compactions: int = 0
    queries: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class CollectionLifecycle:
    """Placement-independent collection lifecycle (see module doc).

    Subclasses set their index state *before* calling ``__init__`` (the
    payload-alignment check reads ``self.n``, the payload lands on
    ``self.device``) and implement the placement hooks listed in the
    module docstring.
    """

    #: manifest tag restore dispatches on
    placement = "local"

    def __init__(
        self,
        name: str,
        *,
        payload=None,
        policy: CompactionPolicy | None = None,
        key=None,
        built_n: int | None = None,
        stats: CollectionStats | None = None,
        version: int | None = None,
        engine: str | None = None,
        search_policy=None,
        calibration: ScheduleTable | None = None,
    ):
        if payload is not None:
            payload = self._payload_tensor(payload)
            if payload.shape[0] != self.id_space:
                raise ValueError(
                    f"collection {name!r}: payload has {payload.shape[0]} rows, "
                    f"the index {self.id_space}"
                )
        self.name = name
        self.payload = payload
        self.policy = policy or CompactionPolicy()
        self._key = _key_from(key)
        self.built_n = self.n if built_n is None else built_n
        self.stats = stats or CollectionStats()
        self.version = version_clock.next() if version is None else version
        # per-collection verify-engine default: used whenever a search
        # doesn't name one explicitly (None = defer to the caller's
        # default); validation is placement-specific
        self.default_engine = self._validate_default_engine(engine)
        # per-collection query-planning default (repro_torch.tune policy):
        # the calibration table backs RecallTarget/LatencyBudget planning
        # and persists through snapshot/restore.
        self.search_policy = search_policy
        self.calibration = calibration
        self._calib_queries: np.ndarray | None = None
        self._calib_kw: dict = {}

    # -------------------------------------------------------- placement hooks
    @property
    def device(self) -> torch.device:
        raise NotImplementedError

    def _validate_default_engine(self, engine: str | None) -> str | None:
        if engine is not None:
            validate_engine(engine)
        return engine

    def _insert(self, points, payload) -> np.ndarray:
        """Grow the index (and payload) by ``points``; return their
        global ids (pre-compaction)."""
        raise NotImplementedError

    def _delete(self, ids) -> None:
        """Tombstone global ``ids`` in the index."""
        raise NotImplementedError

    def _compact_impl(self, generator: torch.Generator) -> torch.Tensor:
        """Rebuild the index from survivors, drawing the new hash
        functions from ``generator``; return the global id map (n_old,)
        on the index's device: old id -> new id, or -1 if deleted.  New
        ids must ascend with old ids so the payload permute in
        :meth:`compact` stays order-preserving."""
        raise NotImplementedError

    def _calibrate_impl(self, queries, **kw) -> ScheduleTable:
        raise NotImplementedError

    def _snapshot_arrays(self) -> dict:
        """Host copies of the index arrays, keyed by field name."""
        raise NotImplementedError

    def _snapshot_meta(self) -> dict:
        """Placement-specific manifest entries (params + layout)."""
        raise NotImplementedError

    def live_count(self) -> int:
        raise NotImplementedError

    @property
    def id_space(self) -> int:
        """Exclusive upper bound of the global id space — every id that
        ``add`` or ``search`` returns is below it, and the payload buffer
        has exactly this many rows.  The local placement's equals ``n``."""
        return self.n

    def _payload_tensor(self, payload) -> torch.Tensor:
        """A payload (tensor or array) as a tensor on the collection's
        device, keeping its dtype."""
        if isinstance(payload, torch.Tensor):
            return payload.to(self.device)
        return as_tensor(np.asarray(payload), self.device, dtype=None)

    # ----------------------------------------------------------------- writes
    def add(self, points, payload=None) -> np.ndarray:
        """Insert ``points`` (m, d); returns their ids (post-compaction
        ids if the policy fired)."""
        points = torch.atleast_2d(as_tensor(points, self.device))
        if (payload is None) != (self.payload is None):
            raise ValueError(
                f"collection {self.name!r}: payload must be provided iff the "
                "collection carries one"
            )
        if payload is not None:
            payload = self._payload_tensor(payload)
            if payload.shape[0] != points.shape[0]:
                raise ValueError(
                    f"collection {self.name!r}: payload rows "
                    f"({payload.shape[0]}) != inserted points "
                    f"({points.shape[0]})"
                )
        # lifecycle mutations record on the process-global trace timeline
        # (TID_LIFECYCLE lane), so a serving-stack trace shows mutations
        # interleaved with the batches they invalidate
        with get_tracer().span(
            "lifecycle.add", cat="lifecycle", collection=self.name,
            placement=self.placement, rows=int(points.shape[0]),
        ) as sp:
            ids = self._insert(points, payload)
            self.stats.inserted += int(points.shape[0])
            self.version = version_clock.next()
            sp.set(version=self.version)
            id_map = self._maybe_compact()
            if id_map is not None:
                ids = id_map[ids]
                sp.set(compacted=True)
        return ids

    def remove(self, ids) -> np.ndarray | None:
        """Tombstone ``ids``; space is reclaimed at the next compaction.

        Returns the compaction id map (old id -> new id, -1 if deleted)
        when the policy fired — every outstanding id must be remapped
        through it — or None when no compaction happened."""
        ids = as_tensor(ids, self.device, torch.int32).reshape(-1)
        with get_tracer().span(
            "lifecycle.remove", cat="lifecycle", collection=self.name,
            placement=self.placement, rows=int(ids.shape[0]),
        ) as sp:
            self._delete(ids)
            self.stats.deleted += int(ids.shape[0])
            self.version = version_clock.next()
            sp.set(version=self.version)
            id_map = self._maybe_compact()
            if id_map is not None:
                sp.set(compacted=True)
        return id_map

    # ------------------------------------------------------------- compaction
    def _occupancy(self) -> tuple[int, int]:
        """``(live, attainable_n)`` — the live point count and the
        smallest ``n`` a :meth:`compact` could reach right now (local
        compaction shrinks to the live count)."""
        live = self.live_count()
        return live, live

    def should_compact(self) -> bool:
        n = self.n
        if n >= self.policy.growth_ratio * self.built_n and n > self.built_n:
            return True
        live, attainable = self._occupancy()
        if live >= self.policy.min_live_ratio * n:
            return False
        # hollow — but only rebuild if compaction can actually shrink the
        # index
        return attainable < n

    def compact(self) -> np.ndarray:
        """Rebuild now. Returns id_map (n_old,): old id -> new id or -1.

        The rebuild re-derives K and L for the live n, as the reference
        does.  Invalidates the fitted schedule table (K/L and the block
        geometry change, which shifts the recall/cost curves) and re-fits
        it when the calibration queries were retained (``calibrate(...,
        retain=True)``)."""
        with get_tracer().span(
            "lifecycle.compact", cat="lifecycle", collection=self.name,
            placement=self.placement, n_before=int(self.n),
        ) as sp:
            id_map = self._compact_traced(sp)
        return id_map

    def _compact_traced(self, sp) -> np.ndarray:
        self._key, seed = split_key(self._key)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        id_map = self._compact_impl(gen)
        if self.payload is not None:
            live_old = torch.nonzero(id_map >= 0)[:, 0]
            pay = self.payload
            # scatter each surviving row to its new id: for the dense
            # local layout this is exactly the ascending gather
            # pay[live_old]
            buf = torch.zeros((self.id_space,) + tuple(pay.shape[1:]), dtype=pay.dtype,
                              device=pay.device)
            buf[id_map[live_old].long()] = pay[live_old]
            self.payload = buf
        self.built_n = self.n
        self.stats.compactions += 1
        self.version = version_clock.next()
        sp.set(n_after=int(self.n), version=self.version)
        if self.calibration is not None or self._calib_queries is not None:
            self.calibration = None  # stale: K/L and block geometry changed
            if self._calib_queries is not None:
                self.calibrate(self._calib_queries, retain=True,
                               **self._calib_kw)
        return id_map.cpu().numpy()

    def _maybe_compact(self) -> np.ndarray | None:
        if self.policy.auto and self.should_compact():
            return self.compact()
        return None

    # ----------------------------------------------------------- planning
    def calibrate(
        self,
        queries,
        *,
        k: int = 0,
        r0: float | None = None,
        steps_max: int = 8,
        engine: str | None = None,
        measure_ms: bool = False,
        retain: bool = False,
    ) -> ScheduleTable:
        """Fit (and store) the collection's schedule table from a
        held-out query sample — the planner backing for outcome-level
        policies.  The table persists through :meth:`snapshot` /
        :meth:`restore`.  With ``retain=True`` the queries (and fit
        settings) are kept host-side and :meth:`compact` re-fits the
        table automatically after every rebuild; without it, compaction
        just invalidates (re-run calibrate by hand).  Retained queries
        do not ride in snapshots — only the fitted table does."""
        kw = dict(k=k, r0=r0, steps_max=steps_max, engine=engine,
                  measure_ms=measure_ms)
        with get_tracer().span(
            "lifecycle.calibrate", cat="lifecycle", collection=self.name,
            placement=self.placement, steps_max=steps_max,
        ):
            table = self._calibrate_impl(queries, **kw)
        self.calibration = table
        if retain:
            if isinstance(queries, torch.Tensor):
                queries = queries.cpu().numpy()
            self._calib_queries = np.asarray(queries, np.float32)
            self._calib_kw = kw
        return table

    def plan(self, policy=None, *, default_r0: float = 1.0,
             default_steps: int = 8) -> ResolvedPlan:
        """Resolve a query-planning policy (explicit > collection
        default) against the stored calibration into the concrete
        (r0, steps, termination) the dispatch runs."""
        return _planner.plan(
            self.calibration,
            resolve_policy(policy, self.search_policy),
            default_r0=default_r0, default_steps=default_steps,
        )

    # ------------------------------------------------------------------ reads
    def _count_queries(self, Q, rows: int | None) -> None:
        self.stats.queries += int(Q.shape[0]) if rows is None else int(rows)

    def get_payload(self, ids):
        """Payload rows for returned neighbor ids.

        Out-of-range ids clamp on *both* ends: the unfilled-slot sentinel
        (``id_space``) clamps to the last payload row and a negative id
        (e.g. -1 from a compaction id map marking a deleted point) clamps
        to row 0 instead of silently wrapping to the tail.  Clamped rows
        are arbitrary, not an error — always mask on the distances (+inf
        marks unfilled slots) or on ``id_map >= 0``, not on ids."""
        if self.payload is None:
            raise ValueError(f"collection {self.name!r} has no payload")
        ids = as_tensor(ids, self.payload.device, torch.int64)
        return self.payload[torch.clamp(ids, 0, self.payload.shape[0] - 1)]

    # ------------------------------------------------------------ persistence
    def snapshot(self, directory: str, step: int | None = None) -> int:
        """Atomic checkpoint via Checkpointer; returns the step written.
        Defaults to one past the latest step already in ``directory`` so
        successive snapshots never overwrite each other (Checkpointer
        keeps the most recent few and GCs the rest)."""
        with get_tracer().span(
            "lifecycle.snapshot", cat="lifecycle", collection=self.name,
            placement=self.placement,
        ) as sp:
            step = self._snapshot_traced(directory, step, sp)
        return step

    def _snapshot_traced(self, directory, step, sp) -> int:
        ck = Checkpointer(directory)
        if step is None:
            latest = ck.latest_step()
            step = 0 if latest is None else latest + 1
        sp.set(step=step)
        tree = dict(self._snapshot_arrays())
        tree["prng_key"] = self._key.copy()
        if self.payload is not None:
            tree["payload"] = self.payload.cpu().numpy()
        meta = {
            "name": self.name,
            "placement": self.placement,
            "policy": dataclasses.asdict(self.policy),
            "built_n": self.built_n,
            "stats": self.stats.as_dict(),
            "has_payload": self.payload is not None,
            "version": self.version,
            "engine": self.default_engine,
            "search_policy": policy_to_dict(self.search_policy),
            "calibration": (
                None if self.calibration is None else self.calibration.to_dict()
            ),
            **self._snapshot_meta(),
        }
        ck.save(step, tree, meta)
        return step

    @staticmethod
    def _common_restore_kwargs(tree, meta) -> dict:
        """The lifecycle half of a restore: everything except the index
        arrays themselves (the payload stays on the host; the placement
        moves it to its device).  The version is deliberately *fresh* —
        past both the persisted one and everything the process has
        handed out — so two collections diverging from one snapshot (or
        a restore racing live updates) can never alias each other's cache
        entries (DESIGN.md §6).  The reference's pure-framework engine
        name ``"jnp"`` maps to the port's ``"torch"``."""
        engine = meta.get("engine")
        return dict(
            payload=tree["payload"] if meta["has_payload"] else None,
            policy=CompactionPolicy(**meta["policy"]),
            key=tree["prng_key"],
            built_n=meta["built_n"],
            stats=CollectionStats(**meta["stats"]),
            version=version_clock.advance_past(meta.get("version", 0)),
            engine="torch" if engine == "jnp" else engine,
            search_policy=policy_from_dict(meta.get("search_policy")),
            calibration=(
                ScheduleTable.from_dict(meta["calibration"])
                if meta.get("calibration") else None
            ),
        )


def restore_collection(directory: str, step: int | None = None, *, mesh=None,
                       device=None):
    """Restore whichever placement a snapshot holds, on ``device`` (the
    CUDA device when None).

    Reads the manifest alone (no array loads) to dispatch: local
    snapshots return a :class:`~repro_torch.store.collection.Collection`.
    The sharded placement is not ported yet (ROADMAP item A15): a sharded
    snapshot raises ``NotImplementedError``, with or without ``mesh=``,
    and is never restored locally in its place.

    Crash safety: with ``step=None`` this walks the directory's steps
    newest-first (the ``LATEST`` designee first) and falls back past any
    snapshot that fails integrity verification (torn write, bit-rot,
    garbled manifest — :class:`~repro_torch.checkpoint.CorruptSnapshot`)
    to the newest step that restores cleanly.  An explicit ``step`` is
    strict: its corruption propagates."""
    from ..device import resolve_device

    device = resolve_device(device)
    ck = Checkpointer(directory)
    candidates = ck._candidate_steps(step)
    if not candidates:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    last_err: Exception | None = None
    for s in candidates:
        try:
            meta, s = ck.read_meta(s)
            if meta.get("placement", "local") == "sharded":
                raise NotImplementedError(
                    f"snapshot at {directory!r} is sharded "
                    f"({meta.get('shards')} shards): the sharded placement is "
                    "not ported to repro_torch yet (ROADMAP item A15)"
                    + ("" if mesh is None else "; mesh= cannot place it")
                )
            from .collection import Collection

            return Collection.restore(directory, s, device=device)
        except (CorruptSnapshot, FileNotFoundError, OSError) as e:
            last_err = e
            if step is not None:
                raise
    raise last_err
