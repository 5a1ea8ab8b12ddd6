"""Query-result cache for the store layer: version-keyed LRU.

DB-LSH queries are read-mostly and heavily repeated in real serving
traffic (the same embedding re-queried across sessions, retries, or
kNN-LM decode loops), yet every repeat re-runs the full window-query
cascade.  :class:`QueryResultCache` short-circuits exact repeats at the
service frontend.

Invalidation is by **version**, not by flushing: the cache key embeds
the collection's monotonic ``version`` (bumped by ``add`` / ``remove``
/ ``compact``, refreshed on ``restore`` — see
:mod:`repro_torch.store.lifecycle`), so a mutation never has to find and
evict its stale entries — they simply stop matching and age out of the
LRU.  Version equality implies state equality (the version clock is
process-wide), which gives the contract the property tests pin down: a
cache hit is bit-identical to a fresh search at the collection's
current version.

Keys quantize the query to float32 bytes — the same dtype the dispatch
path casts to — so a hit requires a bit-exact query.  Entries are numpy
rows on the host: a hit touches neither the device nor a kernel.  Two opt-in
wideners trade exactness for hit rate on near-duplicate traffic
(re-encoded embeddings, dithered clients, retry jitter); both are **off
by default** because they break the bit-equality contract and are only
safe for readers that tolerate approximate reuse:

* ``quantize_eps`` buckets every query coordinate to a grid of pitch
  ``eps`` (``round(q / eps)`` as int64) before hashing, so any two
  queries within the same grid cell share a key — the served result is
  whichever cell member was dispatched first, i.e. *approximate* reuse
  with per-coordinate error ≤ eps/2 in the key (not in the result:
  results are always exact for the query that computed them);
* ``quantize`` (decimal places) is the older, scale-dependent variant.

Version-invalidation semantics are unchanged by either: the version sits
outside the query bytes in the key, so a collection mutation makes
bucketed entries exactly as unreachable as exact ones.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

import numpy as np

__all__ = ["CachedResult", "QueryResultCache"]


@dataclass(frozen=True)
class CachedResult:
    """One cached service-k result row (sliced to per-request k on hit)."""

    dists: np.ndarray          # (k_service,) ascending
    ids: np.ndarray            # (k_service,)
    payload: np.ndarray | None  # (k_service, ...) when the collection has one
    radius_steps: int
    candidates: int


class QueryResultCache:
    """Bounded LRU over (collection, version, query-bytes, k, engine, r0,
    steps) -> :class:`CachedResult`."""

    def __init__(self, capacity: int = 4096, quantize: int | None = None,
                 quantize_eps: float | None = None):
        assert capacity > 0
        assert quantize_eps is None or quantize_eps > 0
        assert quantize is None or quantize_eps is None, (
            "pass at most one key widener (quantize xor quantize_eps)"
        )
        self.capacity = capacity
        self.quantize = quantize
        self.quantize_eps = quantize_eps
        self._entries: OrderedDict[tuple, CachedResult] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self._m_hits = None    # registry counters, armed by bind_metrics
        self._m_misses = None
        self._m_size = None

    def bind_metrics(self, registry) -> "QueryResultCache":
        """Mirror hit/miss/size into a :class:`~repro_torch.obs.metrics.
        MetricsRegistry` (idempotent; the service binds its registry at
        construction).  The plain ``hits``/``misses`` attributes remain
        the source of truth for :meth:`stats`."""
        self._m_hits = registry.counter(
            "repro_store_result_cache_hits_total", "Result-cache key hits"
        )
        self._m_misses = registry.counter(
            "repro_store_result_cache_misses_total", "Result-cache key misses"
        )
        self._m_size = registry.gauge(
            "repro_store_result_cache_size", "Live result-cache entries"
        )
        return self

    # ------------------------------------------------------------------ keys
    def _qbytes(self, query: np.ndarray) -> bytes:
        q = np.ascontiguousarray(query, np.float32)
        if self.quantize_eps is not None:
            # grid bucketing: near-duplicate queries (same eps-cell in
            # every coordinate) collapse to one key
            return np.round(q / self.quantize_eps).astype(np.int64).tobytes()
        if self.quantize is not None:
            q = np.round(q, self.quantize)
        return q.tobytes()

    def key(
        self, collection: str, version: int, query, k: int, engine: str,
        r0: float, steps: int, termination=None,
    ) -> tuple:
        """``termination`` (a hashable ``core.serve_search.Termination``
        or None) joins the key because a planned adaptive dispatch can
        return different results than the fixed schedule at the same
        (r0, steps)."""
        return (collection, version, self._qbytes(query), k, engine, r0,
                steps, termination)

    # ---------------------------------------------------------------- access
    def get(self, key: tuple) -> CachedResult | None:
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            if self._m_misses is not None:
                self._m_misses.inc()
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        if self._m_hits is not None:
            self._m_hits.inc()
        return entry

    def put(self, key: tuple, entry: CachedResult) -> None:
        self._entries[key] = entry
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
        if self._m_size is not None:
            self._m_size.set(len(self._entries))

    def invalidate(self, collection: str | None = None) -> int:
        """Drop entries for one collection (or everything).  Only needed
        for explicit teardown — version keys already make stale entries
        unreachable after a mutation."""
        if collection is None:
            n = len(self._entries)
            self._entries.clear()
        else:
            drop = [k for k in self._entries if k[0] == collection]
            for k in drop:
                del self._entries[k]
            n = len(drop)
        if self._m_size is not None:
            self._m_size.set(len(self._entries))
        return n

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "size": len(self._entries),
            "capacity": self.capacity,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hits / total if total else 0.0,
        }
