"""StoreService: the overlapped, multi-tenant query scheduler.

Single queries arrive one at a time (``submit``) and would waste the
card if dispatched alone, so the service coalesces per-(collection,
tenant) **admission queues** into dynamic micro-batches padded to a
small fixed menu of batch shapes: the kernels then see a closed set of
shapes (and launch configurations), the precondition for capturing a
batch's search in a CUDA graph.  Three independent mechanisms:

**Overlapped dispatch.**  Dispatch is split into an *issue* stage and
a *complete* stage.  Issue pads the batch in page-locked host
memory, copies it to the card with ``non_blocking``, calls
``col.search`` (PyTorch enqueues its kernels and returns tensors the
card may still be computing), enqueues ``non_blocking`` copies of the
results (distances, ids, the two stats, the payload rows, the EXPLAIN
arrays) into page-locked host tensors on the same stream, and records
a CUDA event behind them; it never waits for the card.  Complete waits
on the event — the only host sync — and reads the host tensors as
numpy.  Issued batches sit in an in-flight ring of depth
``inflight_depth``; while the card executes batch *i*, the host pads
and issues batch *i+1*.  ``inflight_depth=0`` recovers the synchronous
behavior exactly — both paths run the same search on the same padded
batch, so results are bit-identical by construction (the scheduler
tests assert this for every batch shape, timeout drains included).
One stream carries everything, as the reference keeps one device
queue: a second stream would need ``record_stream`` on every block the
caching allocator hands the search and would buy nothing the ring does
not already give.  The pinned buffers come from torch's caching host
allocator, which keeps each block until the copy that reads or writes
it has finished, so the next batch's padding never races this one's
copy.  Two kinds of batch cannot overlap: a plan with
``Termination(early_exit=True)`` makes the search read its done mask
once a step (``core.serve_search``), so issue returns only after the
schedule's last step ran; and a collection on the CPU computes while
``col.search`` runs (its handle is ready at once).

**Query-result cache.**  An LRU (:mod:`repro_torch.store.cache`) keyed
on (collection, *version*, query bytes, k, engine, r0, steps).  The
version is the collection's monotonic mutation counter, so
``add``/``remove``/``compact``/``restore`` invalidate by construction:
stale entries stop matching rather than needing eviction.  Entries are
numpy rows on the host, and hits are served at drain time without
touching the device or launching a kernel.

**Admission control.**  Per-tenant token buckets (``set_quota``) reject
over-quota ``submit`` calls with :class:`QuotaExceeded`, and ``step``
drains the per-tenant queues weighted-round-robin so one hot tenant
cannot starve the rest of a batch.  Per-tenant served/rejected/QPS
stats sit alongside the per-collection QPS/latency/probe snapshot.

Time is read exclusively through an injectable ``clock`` (defaults to
``time.monotonic``) so quota refill, timeout drains, and latency
percentiles are deterministic under test.

Top-k is a *service-level* constant (``default_k``): per-request ``k``
may be any value up to it and is sliced from the service-k result
(cached entries store the full service-k row), which keeps the dispatch
shape set closed.  The verify engine resolves per request — explicit
``submit``/``serve`` override, else the collection's ``default_engine``,
else the service default (``"torch"``, the reference's ``"jnp"``) — is
frozen into the ticket at admission, keys the result cache, and splits
a drained batch per engine at issue time.  The *schedule* resolves the
same way through ``repro_torch.tune``: an explicit ``policy=`` /
``recall_target=`` on submit, else the collection's ``search_policy``,
else the service ``default_policy``, planned against the collection's
calibration table into a ``ResolvedPlan`` (r0, steps, adaptive
termination) that is likewise frozen into the ticket, keys the cache,
and splits batches.  Any object with ``search(Q, k=..., r0=...,
steps=..., engine=..., with_stats=..., rows=...)``, ``name``, and
``version`` can be attached; the service creates no tensor of its own
except through a collection, so it runs where each attached
collection's index lies (a collection's ``device`` attribute, when it
has one, picks the pinned upload).  The reference's ``interpret=``
(Pallas interpret mode) has no counterpart: on CPU tensors the
kernels' wrappers run their plain twins.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import time
from collections import deque

import numpy as np
import torch

from ..core.serve_search import PendingSearch, validate_engine
from ..device import upload
from ..obs import Observability
from ..obs.explain import TERM_CAUSE_NAMES, QueryExplain
from ..obs.metrics import LATENCY_MS_BUCKETS, MetricsRegistry
from ..obs.trace import TID_RING0, TID_SCHEDULER
from ..resilience import faults
from ..resilience.stragglers import StragglerMonitor
from ..tune import planner as _planner
from ..tune.policy import (
    LatencyBudget,
    RecallTarget,
    ResolvedPlan,
    resolve_policy_with_source,
)
from .cache import CachedResult, QueryResultCache

__all__ = [
    "BrownoutShed",
    "DeadlineExceeded",
    "DispatchFailed",
    "QueryRequest",
    "QuotaExceeded",
    "StoreService",
    "TenantQuota",
]


class QuotaExceeded(RuntimeError):
    """Raised by ``submit`` when the tenant's token bucket is empty."""


class BrownoutShed(QuotaExceeded):
    """Raised by ``submit`` when the brownout controller is at its
    load-shedding rung and the tenant is below the shed line.  A
    subclass of :class:`QuotaExceeded` so existing all-or-nothing /
    rejection handling applies unchanged."""


class DeadlineExceeded(RuntimeError):
    """The ticket's ``deadline_ms`` elapsed before its batch could be
    issued; the ticket terminates with ``error`` set instead of
    dispatching work nobody can use."""


class DispatchFailed(RuntimeError):
    """A batch's dispatch (or completion) raised after exhausting the
    transient-retry budget; every ticket in the batch terminates with
    ``error`` set to this, never left pending."""


@dataclasses.dataclass
class QueryRequest:
    """One in-flight query; filled in place when its batch completes."""

    uid: int
    collection: str
    query: np.ndarray  # (d,)
    k: int
    submitted: float
    tenant: str = "default"
    engine: str = "torch"             # resolved at submit (request ->
                                      # collection default -> service)
    plan: ResolvedPlan | None = None  # resolved schedule (r0, steps,
                                      # termination) — request policy >
                                      # collection search_policy >
                                      # service default_policy
    deadline_ms: float | None = None  # end-to-end budget from submit; the
                                      # scheduler fails (pre-issue) or flags
                                      # degraded (post-complete) past it
    degraded: bool = False            # served on a cut-down schedule (deadline
                                      # re-plan or brownout) or past deadline —
                                      # the result is real but reduced-recall
    error: Exception | None = None    # typed terminal error (DeadlineExceeded,
                                      # DispatchFailed); done=True either way
    done: bool = False
    traced: bool = False              # sampled into the span recorder
    cached: bool = False              # served from the query-result cache
    dists: np.ndarray | None = None   # (k,) ascending; +inf = unfilled slot
    ids: np.ndarray | None = None     # (k,) neighbor ids; index.n = sentinel
    payload: object = None            # payload rows when the collection has one
    latency_ms: float = 0.0
    radius_steps: int = 0
    candidates: int = 0
    explain: QueryExplain | None = None  # EXPLAIN ANALYZE record, present
                                         # when submit(..., explain=True)
                                         # asked or auto-sampling picked
                                         # this ticket; filled progressively
                                         # through drain/issue/complete and
                                         # whole once done=True


@dataclasses.dataclass(frozen=True)
class TenantQuota:
    """Admission policy for one tenant.

    ``rate`` is the sustained queries/second refill, ``burst`` the bucket
    capacity (defaults to ``rate``, min 1), ``weight`` the tenant's share
    when a batch drains multiple tenants round-robin."""

    rate: float = math.inf
    burst: float | None = None
    weight: int = 1

    @property
    def capacity(self) -> float:
        if self.burst is not None:
            return self.burst
        return self.rate if math.isfinite(self.rate) else math.inf


class _TokenBucket:
    def __init__(self, quota: TenantQuota, now: float):
        self.quota = quota
        self.tokens = max(1.0, quota.capacity) if math.isfinite(quota.capacity) else math.inf
        self.t_last = now

    def try_take(self, now: float) -> bool:
        if math.isinf(self.tokens):
            return True
        self.tokens = min(
            max(1.0, self.quota.capacity),
            self.tokens + (now - self.t_last) * self.quota.rate,
        )
        self.t_last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


class _WindowClock:
    """First-submit / last-completion timestamps for a QPS window,
    mirrored into registry gauges for export.  Min-merged on the start
    edge: a cache hit may record a later first-submit while an earlier
    batch still sits in the in-flight ring."""

    def __init__(self, start_gauge, end_gauge, **labels):
        self._g0 = start_gauge
        self._g1 = end_gauge
        self._labels = labels
        self.t_first: float | None = None
        self.t_last: float | None = None

    def record(self, submitted: float, now: float) -> None:
        if self.t_first is None or submitted < self.t_first:
            self.t_first = submitted
            self._g0.set(submitted, **self._labels)
        self.t_last = now
        self._g1.set(now, **self._labels)

    def span(self) -> float:
        if self.t_first is None or self.t_last <= self.t_first:
            return 0.0
        return self.t_last - self.t_first


class _TenantStats:
    """Per-tenant admission/serving view over the metrics registry —
    the mutators the scheduler calls, the snapshot ``tenant_stats()``
    returns.  All state lives in registry series labeled by tenant."""

    def __init__(self, registry: MetricsRegistry, tenant: str):
        self.tenant = tenant
        r = registry
        self._submitted = r.counter(
            "repro_store_tenant_submitted_total", "Requests admitted by tenant"
        )
        self._withdrawn = r.counter(
            "repro_store_tenant_withdrawn_total",
            "Admitted requests withdrawn by all-or-nothing serve()",
        )
        self._served = r.counter(
            "repro_store_tenant_served_total", "Requests completed by tenant"
        )
        self._rejected = r.counter(
            "repro_store_quota_rejections_total",
            "submit() calls rejected by the tenant token bucket",
        )
        self._hits = r.counter(
            "repro_store_tenant_cache_hits_total",
            "Tenant requests served from the query-result cache",
        )
        self._failed = r.counter(
            "repro_store_tenant_failed_total",
            "Tenant requests terminated with a typed error, by kind",
        )
        self._degraded = r.counter(
            "repro_store_tenant_degraded_total",
            "Tenant requests served flagged-degraded (cut schedule or "
            "past deadline)",
        )
        self._window = _WindowClock(
            r.gauge("repro_store_tenant_window_start_seconds",
                    "Earliest submit timestamp in the tenant QPS window"),
            r.gauge("repro_store_tenant_window_end_seconds",
                    "Latest completion timestamp in the tenant QPS window"),
            tenant=tenant,
        )

    def record_submitted(self):
        self._submitted.inc(tenant=self.tenant)

    def record_withdrawn(self):
        self._withdrawn.inc(tenant=self.tenant)

    def record_rejected(self):
        self._rejected.inc(tenant=self.tenant)

    def record_served(self, req: QueryRequest, now: float):
        self._served.inc(tenant=self.tenant)
        if req.cached:
            self._hits.inc(tenant=self.tenant)
        if req.degraded:
            self._degraded.inc(tenant=self.tenant)
        self._window.record(req.submitted, now)

    def record_failed(self, kind: str = "error"):
        self._failed.inc(tenant=self.tenant, kind=kind)

    def _failed_by_kind(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for labels, v in self._failed.series():
            if labels.get("tenant") == self.tenant:
                out[labels.get("kind", "error")] = \
                    out.get(labels.get("kind", "error"), 0) + int(v)
        return out

    def snapshot(self) -> dict:
        t = dict(tenant=self.tenant)
        served = self._served.value(**t)
        span = self._window.span()
        failed = self._failed_by_kind()
        return {
            "submitted": int(
                self._submitted.value(**t) - self._withdrawn.value(**t)
            ),
            "served": int(served),
            "rejected": int(self._rejected.value(**t)),
            "cache_hits": int(self._hits.value(**t)),
            "failed": sum(failed.values()),
            "deadline_exceeded": failed.get("deadline", 0),
            "degraded": int(self._degraded.value(**t)),
            "qps": served / span if span > 0 else 0.0,
        }


class _CollectionStats:
    """Per-collection serving view over the metrics registry.  Snapshot
    keys are the stable ``svc.stats()`` contract; every number behind
    them is a registry series labeled by collection, so the same
    quantities export through Prometheus/JSON and feed the SLO watch.
    Empty windows report ``0.0``, never NaN."""

    def __init__(self, registry: MetricsRegistry, name: str,
                 latency_window: int = 8192):
        self.name = name
        r = registry
        self._served = r.counter(
            "repro_store_queries_served_total", "Queries completed"
        )
        self._failed = r.counter(
            "repro_store_requests_failed_total",
            "Requests terminated with a typed error, by kind",
        )
        self._degraded = r.counter(
            "repro_store_degraded_total",
            "Requests served flagged-degraded (cut schedule or past deadline)",
        )
        self._straggler = r.counter(
            "repro_store_straggler_batches_total",
            "Completed batches the EWMA monitor flagged as stragglers",
        )
        self._batches = r.counter(
            "repro_store_batches_total", "Device batches dispatched"
        )
        self._overlapped = r.counter(
            "repro_store_batches_overlapped_total",
            "Batches issued while another batch was already in flight",
        )
        self._cache_hits = r.counter(
            "repro_store_cache_hits_total",
            "Queries served from the result cache",
        )
        self._padded = r.counter(
            "repro_store_padded_slots_total",
            "Batch slots filled with padding, not real queries",
        )
        # bounded window reservoir inside the histogram: percentiles over
        # the most recent `latency_window` queries (default 8192), so a
        # long-lived serving process doesn't grow memory per request.
        # Smaller windows make the p99 react faster — the chaos bench
        # shrinks it so brownout heal is observable within a soak.
        self._latency = r.histogram(
            "repro_store_latency_ms", "End-to-end request latency (ms)",
            buckets=LATENCY_MS_BUCKETS, window=latency_window,
        )
        self._fill = r.histogram(
            "repro_store_batch_fill_ratio",
            "Real rows / batch shape at dispatch",
            buckets=(0.25, 0.5, 0.75, 1.0), window=1024,
        )
        self._radius_steps = r.counter(
            "repro_store_radius_steps_total", "Schedule steps run"
        )
        self._candidates = r.counter(
            "repro_store_candidates_total", "Verified candidate slots fetched"
        )
        # per-query termination-step counters (label step=j): how much of
        # the schedule each query actually ran, which is the work the
        # planner/adaptive-termination saves — and the SLO watch's drift
        # signal.  Sharded collections feed the same counter — their
        # radius_steps arrive pmax'd across shards from the merge.
        self._steps_hist = r.counter(
            "repro_store_termination_steps_total",
            "Queries by the schedule step their termination fired at",
        )
        self._window = _WindowClock(
            r.gauge("repro_store_window_start_seconds",
                    "Earliest submit timestamp in the QPS window"),
            r.gauge("repro_store_window_end_seconds",
                    "Latest completion timestamp in the QPS window"),
            collection=name,
        )
        self._steps_fam = self._steps_hist  # series() read in snapshot

    def _record_req(self, r: QueryRequest):
        self._latency.observe(r.latency_ms, collection=self.name)
        self._radius_steps.inc(r.radius_steps, collection=self.name)
        self._candidates.inc(r.candidates, collection=self.name)
        self._steps_hist.inc(
            collection=self.name, step=int(r.radius_steps)
        )
        if r.degraded:
            self._degraded.inc(collection=self.name)

    def record_failed(self, kind: str):
        self._failed.inc(collection=self.name, kind=kind)

    def record_straggler(self):
        self._straggler.inc(collection=self.name)

    def _failed_total(self) -> int:
        total = 0
        for labels, v in self._failed.series():
            if labels.get("collection") == self.name:
                total += int(v)
        return total

    def record_batch(self, reqs, shape, now, *, overlapped: bool):
        c = dict(collection=self.name)
        self._served.inc(len(reqs), **c)
        self._batches.inc(**c)
        if overlapped:
            self._overlapped.inc(**c)
        self._padded.inc(shape - len(reqs), **c)
        self._fill.observe(len(reqs) / shape, **c)
        self._window.record(min(r.submitted for r in reqs), now)
        for r in reqs:
            self._record_req(r)

    def record_hit(self, req: QueryRequest, now: float):
        c = dict(collection=self.name)
        self._served.inc(**c)
        self._cache_hits.inc(**c)
        self._window.record(req.submitted, now)
        self._record_req(req)

    def _step_hist(self) -> dict[int, int]:
        out = {}
        for labels, v in self._steps_fam.series():
            if labels.get("collection") == self.name:
                out[int(labels["step"])] = int(v)
        return dict(sorted(out.items()))

    def snapshot(self) -> dict:
        c = dict(collection=self.name)
        served = self._served.value(**c)
        batches = self._batches.value(**c)
        hits = self._cache_hits.value(**c)
        padded = self._padded.value(**c)
        span = self._window.span()
        p50, p90, p99 = (
            float(x) for x in self._latency.percentile([50.0, 90.0, 99.0], **c)
        )
        return {
            "queries": int(served),
            "batches": int(batches),
            "qps": served / span if span > 0 else 0.0,
            "latency_ms_p50": p50,
            "latency_ms_p90": p90,
            "latency_ms_p99": p99,
            "latency_ms_mean": self._latency.mean(**c),
            "mean_radius_steps": self._radius_steps.value(**c) / max(served, 1),
            "mean_candidates": self._candidates.value(**c) / max(served, 1),
            "termination_steps_hist": self._step_hist(),
            "padding_efficiency": (
                served / (served + padded) if served else 0.0
            ),
            "cache_hits": int(hits),
            "cache_hit_rate": hits / served if served else 0.0,
            "overlap_ratio": (
                self._overlapped.value(**c) / batches if batches else 0.0
            ),
            "failed": self._failed_total(),
            "degraded": int(self._degraded.value(**c)),
            "straggler_batches": int(self._straggler.value(**c)),
        }


def _to_host(x):
    """``x`` as a host tensor: a CUDA tensor's copy into page-locked
    memory from torch's caching host allocator, enqueued on the current
    stream with ``non_blocking`` (the values are there once the stream
    has passed the copy); a CPU tensor or an array as it is."""
    t = torch.as_tensor(x)
    if not t.is_cuda:
        return t
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


def _numpy(x) -> np.ndarray:
    """A read-only numpy view of a host tensor or array: tickets on the
    miss path are views of their batch's arrays, so a caller scribbling
    on one would corrupt its neighbours (the cache stores copies)."""
    a = (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)).view()
    a.flags.writeable = False
    return a


@dataclasses.dataclass
class _InFlight:
    """One issued-but-not-completed batch in the overlap ring."""

    name: str
    reqs: list[QueryRequest]
    shape: int
    pending: PendingSearch  # host tensors, filled once its event fires
    payload: object        # host tensor (m, k, ...) or None
    version: int | None    # version the results belong to; None = uncacheable
    overlapped: bool       # issued while another batch was in flight
    engine: str            # resolved engine the batch was dispatched with
    plan: ResolvedPlan     # resolved schedule the batch was dispatched with
    seq: int = 0           # monotonic batch number (trace correlation)
    tid: int = TID_RING0   # trace lane = TID_RING0 + ring slot at issue
    t_issued: float = 0.0  # when the issue stage handed it to the device
    retries: int = 0       # transient-dispatch retries the issue burned
    fault_sites: tuple = ()  # injected fault sites the dispatch hit


class StoreService:
    """Admission control + overlapped micro-batch scheduling over
    attached collections."""

    def __init__(
        self,
        *,
        batch_shapes: tuple[int, ...] = (1, 4, 16, 64),
        max_wait_ms: float = 2.0,
        default_k: int = 10,
        r0: float = 1.0,
        steps: int = 8,
        engine: str = "torch",
        inflight_depth: int = 2,
        cache: QueryResultCache | None = None,
        cache_size: int = 1024,
        cache_quantize_eps: float | None = None,
        default_policy=None,
        clock=time.monotonic,
        obs: Observability | None = None,
        retry_limit: int = 2,
        retry_backoff_ms: float = 1.0,
        retry_backoff_cap_ms: float = 50.0,
        sleep=time.sleep,
        latency_window: int = 8192,
    ):
        assert batch_shapes == tuple(sorted(batch_shapes)) and batch_shapes
        assert inflight_depth >= 0
        self.batch_shapes = batch_shapes
        self.max_wait_ms = max_wait_ms
        self.default_k = default_k
        self.r0 = r0
        self.steps = steps
        self.engine = engine
        self.inflight_depth = inflight_depth
        # transient-dispatch retry budget: errors whose `transient`
        # attribute is true are re-issued up to retry_limit times with
        # capped exponential backoff before the batch fails typed
        self.retry_limit = retry_limit
        self.retry_backoff_ms = retry_backoff_ms
        self.retry_backoff_cap_ms = retry_backoff_cap_ms
        self._sleep = sleep
        self._latency_window = latency_window
        # a BrownoutController registers itself here (resilience.degrade);
        # None = no degradation ladder, submit-time behavior unchanged
        self.brownout = None
        self._stragglers: dict[str, StragglerMonitor] = {}
        # service-level query-planning default (repro_torch.tune policy) — the
        # lowest-precedence rung of request > collection > service
        self.default_policy = default_policy
        # observability bundle: metrics always on (the stats snapshots
        # below are views over the registry), tracing opt-in via the
        # bundle's tracer (`Observability(trace=True)`)
        self.obs = obs if obs is not None else Observability()
        self.registry = self.obs.registry
        self.tracer = self.obs.tracer
        self._g_queue = self.registry.gauge(
            "repro_store_queue_depth", "Admitted, not-yet-issued requests"
        )
        self._g_ring = self.registry.gauge(
            "repro_store_inflight_batches",
            "Issued-but-not-completed batches in the overlap ring",
        )
        if cache is not None:
            self.cache = cache
        else:
            self.cache = (
                QueryResultCache(cache_size, quantize_eps=cache_quantize_eps)
                if cache_size > 0 else None
            )
        if self.cache is not None:
            self.cache.bind_metrics(self.registry)
        self._clock = clock
        self.collections: dict[str, object] = {}
        self.quotas: dict[str, TenantQuota] = {}
        self._buckets: dict[str, _TokenBucket] = {}
        self._queues: dict[str, dict[str, deque[QueryRequest]]] = {}
        self._rr_pos: dict[str, int] = {}
        self._stats: dict[str, _CollectionStats] = {}
        self._tenant_stats: dict[str, _TenantStats] = {}
        self._inflight: deque[_InFlight] = deque()
        self._uid = 0
        self._batch_seq = 0

    def _tstats(self, tenant: str) -> _TenantStats:
        s = self._tenant_stats.get(tenant)
        if s is None:
            s = self._tenant_stats[tenant] = _TenantStats(self.registry, tenant)
        return s

    # ----------------------------------------------------------------- admin
    def attach(self, collection) -> None:
        """Register a Collection (or any search-compatible object)."""
        self.collections[collection.name] = collection
        self._queues.setdefault(collection.name, {})
        if collection.name not in self._stats:
            self._stats[collection.name] = _CollectionStats(
                self.registry, collection.name, self._latency_window
            )

    def create_collection(self, name: str, key, data, **kw):
        """Build a :class:`~repro_torch.store.collection.Collection` (``key``
        is its ``torch.Generator``; on the CUDA device unless ``kw`` has
        ``device="cpu"``) and attach it."""
        from .collection import Collection

        col = Collection.create(name, key, data, **kw)
        self.attach(col)
        return col

    def drop_collection(self, name: str) -> None:
        if any(q for q in self._queues.get(name, {}).values()):
            raise RuntimeError(f"collection {name!r} has pending requests")
        if any(b.name == name for b in self._inflight):
            raise RuntimeError(f"collection {name!r} has in-flight batches")
        self.collections.pop(name, None)
        self._queues.pop(name, None)
        self._stats.pop(name, None)
        self._rr_pos.pop(name, None)
        if self.cache is not None:
            self.cache.invalidate(name)

    def set_quota(
        self, tenant: str, *, rate: float = math.inf,
        burst: float | None = None, weight: int = 1,
    ) -> TenantQuota:
        """Install (or replace) a tenant's admission policy; the token
        bucket restarts full at the next ``submit``."""
        assert weight >= 1
        quota = TenantQuota(rate=rate, burst=burst, weight=weight)
        self.quotas[tenant] = quota
        self._buckets.pop(tenant, None)  # rebuilt lazily from the new quota
        return quota

    def __getitem__(self, name: str):
        return self.collections[name]

    # ---------------------------------------------------------------- submit
    def resolve_engine(self, collection: str, engine: str | None = None) -> str:
        """Three-level engine resolution: explicit request override, then
        the collection's ``default_engine``, then the service default.
        A collection that cannot honor engine selection (e.g. the sharded
        router, which always verifies on the plain engine) declares
        ``fixed_engine``; it wins over everything so tickets and cache
        keys name the engine that actually runs."""
        col = self.collections[collection]
        fixed = getattr(col, "fixed_engine", None)
        if fixed is not None:
            return validate_engine(fixed)
        if engine is None:
            engine = getattr(col, "default_engine", None) or self.engine
        return validate_engine(engine)

    def resolve_plan(self, collection: str, policy=None) -> ResolvedPlan:
        """Three-level policy resolution (explicit request policy, then
        the collection's ``search_policy``, then the service
        ``default_policy``), planned against the collection's calibration
        table.  No policy anywhere resolves to the service's own
        (r0, steps) with no adaptive termination — the pre-tune dispatch,
        bit-for-bit."""
        return self._resolve_plan_ex(collection, policy)[0]

    def _resolve_plan_ex(self, collection: str, policy=None):
        """:meth:`resolve_plan` plus the provenance EXPLAIN records:
        ``(plan, source, policy, table_used)`` where ``source`` names the
        resolution rung that won ("request"/"collection"/"service", or
        "default" when no rung supplied a policy)."""
        col = self.collections[collection]
        policy, source = resolve_policy_with_source(
            policy, getattr(col, "search_policy", None), self.default_policy
        )
        table = getattr(col, "calibration", None)
        plan = _planner.plan(
            table, policy, default_r0=self.r0, default_steps=self.steps,
        )
        return plan, source, policy, table is not None

    def submit(
        self, collection: str, query, k: int | None = None,
        tenant: str = "default", engine: str | None = None,
        policy=None, recall_target: float | None = None,
        deadline_ms: float | None = None,
        explain: bool | None = None,
    ) -> QueryRequest:
        """Enqueue one query; returns its ticket (filled once dispatched).
        ``engine`` overrides the collection / service engine defaults for
        this request; ``policy`` (a ``repro_torch.tune`` policy) overrides the
        collection / service planning defaults, and ``recall_target=x``
        is sugar for ``policy=RecallTarget(x)``.  ``deadline_ms`` is an
        end-to-end budget: a ticket still queued past it terminates with
        a typed :class:`DeadlineExceeded` instead of dispatching, a
        ticket that can only fit the remaining budget on a shorter
        schedule is re-planned and flagged ``degraded``.  ``explain=True``
        attaches an EXPLAIN ANALYZE record (``ticket.explain``, a
        :class:`~repro_torch.obs.explain.QueryExplain`) filled through the
        ticket's lifetime — plan provenance, queue/batch/cache story,
        the device's per-step window/slot measurements and terminate
        cause; ``explain=None`` (default) auto-samples at the bundle's
        ``explain_sample_rate``; ``explain=False`` never explains.
        Explain'd requests bypass the result-cache read (annotated, so
        the device story is always real) and batch separately — results
        stay bit-equal either way.  Raises :class:`QuotaExceeded` when
        the tenant is over quota — rejected requests are never enqueued
        — and :class:`BrownoutShed` when the degradation ladder is
        shedding this tenant's load."""
        if collection not in self.collections:
            raise KeyError(f"unknown collection {collection!r}")
        if recall_target is not None:
            if policy is not None:
                raise ValueError("pass either policy= or recall_target=, not both")
            policy = RecallTarget(recall_target)
        engine = self.resolve_engine(collection, engine)
        plan, plan_source, plan_policy, plan_table = \
            self._resolve_plan_ex(collection, policy)
        degraded = False
        replanned = None
        if self.brownout is not None:
            if self.brownout.should_shed(tenant):
                self._tstats(tenant).record_rejected()
                raise BrownoutShed(
                    f"tenant {tenant!r} shed at brownout level "
                    f"{self.brownout.level}"
                )
            plan, degraded = self.brownout.apply_plan(plan)
            if degraded:
                replanned = "brownout"
        k = self.default_k if k is None else k
        if k > self.default_k:
            raise ValueError(
                f"k={k} exceeds service default_k={self.default_k}; raise "
                "default_k at construction (k is fixed in the dispatch)"
            )
        now = self._clock()
        tstats = self._tstats(tenant)
        bucket = self._buckets.get(tenant)
        if bucket is None:
            bucket = _TokenBucket(self.quotas.get(tenant, TenantQuota()), now)
            self._buckets[tenant] = bucket
        if not bucket.try_take(now):
            tstats.record_rejected()
            if self.tracer.enabled:
                self.tracer.instant(
                    "quota.reject", cat="request", t=now,
                    tenant=tenant, collection=collection,
                )
            raise QuotaExceeded(
                f"tenant {tenant!r} over quota "
                f"(rate={bucket.quota.rate}/s, burst={bucket.quota.capacity})"
            )
        req = QueryRequest(
            uid=self._uid,
            collection=collection,
            query=np.asarray(query, np.float32).reshape(-1),
            k=k,
            submitted=now,
            tenant=tenant,
            engine=engine,
            plan=plan,
            deadline_ms=deadline_ms,
            degraded=degraded,
            traced=self.tracer.should_sample(),
        )
        if explain or (explain is None and self.obs.should_explain()):
            req.explain = QueryExplain(
                uid=req.uid, collection=collection, tenant=tenant,
                engine=engine, plan_r0=plan.r0, plan_steps=plan.steps,
                plan_termination=(
                    None if plan.termination is None
                    else repr(plan.termination)
                ),
                plan_source=plan_source,
                plan_policy=(
                    None if plan_policy is None else repr(plan_policy)
                ),
                plan_table=plan_table,
                replanned=replanned,
                brownout_level=(
                    self.brownout.level if self.brownout is not None else 0
                ),
                degraded=degraded,
                traced=req.traced,
            )
        self._uid += 1
        self._queues[collection].setdefault(tenant, deque()).append(req)
        tstats.record_submitted()
        self._g_queue.set(self.pending())
        return req

    def pending(self) -> int:
        """Queued (not yet issued) requests."""
        return sum(
            len(q) for per in self._queues.values() for q in per.values()
        )

    def in_flight(self) -> int:
        """Requests issued to the device but not yet completed."""
        return sum(len(b.reqs) for b in self._inflight)

    # -------------------------------------------------------------- dispatch
    def step(self, force: bool = False) -> int:
        """One scheduler pass.

        Retires any in-flight batches that are already ready (never
        blocks for them), then drains every collection whose queues are
        full enough (or whose oldest request timed out, or everything
        when ``force``) — serving cache hits inline and issuing the rest
        without waiting on the device, up to ``inflight_depth`` batches
        deep.  With ``force`` the pass ends fully synchronous: every
        in-flight batch is completed before returning.  Returns the
        number of requests drained (hits + issued)."""
        self.poll()
        now = self._clock()
        drained = 0
        cap = self.batch_shapes[-1]
        for name, per_tenant in self._queues.items():
            while True:
                total = sum(len(q) for q in per_tenant.values())
                if total == 0:
                    break
                oldest = min(q[0].submitted for q in per_tenant.values() if q)
                timed_out = (now - oldest) * 1e3 >= self.max_wait_ms
                if not (force or timed_out or total >= cap):
                    break
                reqs = self._drain_wrr(name, cap)
                drained += len(reqs)
                if self.tracer.enabled or \
                        any(r.explain is not None for r in reqs):
                    t_drain = self._clock()
                    for r in reqs:
                        if r.explain is not None:
                            r.explain.queue_wait_ms = \
                                (t_drain - r.submitted) * 1e3
                        if r.traced and self.tracer.enabled:
                            self.tracer.add_span(
                                "request.queue_wait", r.submitted, t_drain,
                                cat="request", uid=r.uid, tenant=r.tenant,
                                collection=name,
                            )
                reqs = self._apply_deadlines(name, reqs)
                misses = self._serve_cached(name, reqs)
                if misses:
                    # one search call per (engine, plan, explain):
                    # split mixed batches (requests resolve engines and
                    # plans at submit, so a batch is mixed only under
                    # per-request overrides / policies / sampled
                    # explains — the explain variant also returns the
                    # per-step arrays)
                    by_prog: dict[tuple, list[QueryRequest]] = {}
                    for r in misses:
                        by_prog.setdefault(
                            (r.engine, r.plan, r.explain is not None), []
                        ).append(r)
                    for (eng, plan, explained), group in by_prog.items():
                        self._issue(name, group, eng, plan,
                                    with_explain=explained)
        self._g_queue.set(self.pending())
        if force:
            self._complete_all()
        if self.obs.slo is not None:
            self.obs.slo.maybe_check(self._clock())
        return drained

    def poll(self) -> int:
        """Retire ready in-flight batches without blocking; returns the
        number of batches completed. Completion stays in issue order —
        the ring head is the only candidate."""
        done = 0
        while self._inflight and self._inflight[0].pending.ready():
            self._complete(self._inflight.popleft())
            done += 1
        return done

    def flush(self) -> int:
        """Drain and complete everything pending; returns requests served."""
        total = 0
        while self.pending():
            total += self.step(force=True)
        self._complete_all()
        return total

    def _shape_for(self, m: int) -> int:
        for s in self.batch_shapes:
            if s >= m:
                return s
        return self.batch_shapes[-1]

    def _drain_wrr(self, name: str, cap: int) -> list[QueryRequest]:
        """Pop up to ``cap`` requests across the collection's tenant
        queues, weighted round-robin: each cycle visits the non-empty
        tenants in rotated order and takes up to ``quota.weight`` from
        each, so a backlogged tenant gets its share — never the whole
        batch — while light tenants pass through untouched."""
        per_tenant = self._queues[name]
        tenants = sorted(t for t, q in per_tenant.items() if q)
        if not tenants:
            return []
        start = self._rr_pos.get(name, 0) % len(tenants)
        order = tenants[start:] + tenants[:start]
        self._rr_pos[name] = self._rr_pos.get(name, 0) + 1
        out: list[QueryRequest] = []
        while len(out) < cap and any(per_tenant[t] for t in order):
            for t in order:
                weight = max(1, self.quotas.get(t, TenantQuota()).weight)
                for _ in range(weight):
                    if len(out) >= cap or not per_tenant[t]:
                        break
                    out.append(per_tenant[t].popleft())
                if len(out) >= cap:
                    break
        return out

    # --------------------------------------------- deadlines / typed failure
    def _fail_req(self, name: str, r: QueryRequest, exc: Exception,
                  kind: str, now: float) -> None:
        """Terminate one ticket with a typed error — the ticket contract
        is that ``done`` flips exactly once, result or error, never
        neither."""
        r.error = exc
        r.done = True
        r.latency_ms = (now - r.submitted) * 1e3
        self._stats[name].record_failed(kind)
        self._tstats(r.tenant).record_failed(kind)
        if r.traced:
            self.tracer.instant(
                "request.failed", cat="request", t=now,
                uid=r.uid, collection=name, kind=kind,
            )

    def _fail_batch(self, name: str, reqs: list[QueryRequest],
                    exc: Exception, kind: str) -> None:
        now = self._clock()
        for r in reqs:
            self._fail_req(name, r, exc, kind, now)

    def _apply_deadlines(
        self, name: str, reqs: list[QueryRequest]
    ) -> list[QueryRequest]:
        """Deadline gate at drain time.  Expired tickets terminate with
        :class:`DeadlineExceeded` before any device work; tickets whose
        remaining budget no longer fits their plan are re-planned through
        ``LatencyBudget(remaining)`` — DB-LSH's schedule is the knob: a
        shorter window schedule trades recall for latency continuously —
        and flagged ``degraded``.  Re-planning needs a *measured*
        calibration table (``Collection.calibrate(measure_ms=True)``);
        without one the ticket keeps its plan and simply risks finishing
        late (flagged at completion)."""
        now = self._clock()
        out: list[QueryRequest] = []
        table = None
        if any(r.deadline_ms is not None for r in reqs):
            table = getattr(self.collections[name], "calibration", None)
            if table is not None and not any(
                math.isfinite(float(m)) for m in table.cost_ms
            ):
                table = None  # unmeasured: recall-only calibration
        for r in reqs:
            if r.deadline_ms is None:
                out.append(r)
                continue
            remaining = r.deadline_ms - (now - r.submitted) * 1e3
            if remaining <= 0:
                self._fail_req(
                    name, r,
                    DeadlineExceeded(
                        f"deadline {r.deadline_ms}ms elapsed before dispatch "
                        f"(queued {(now - r.submitted) * 1e3:.3f}ms)"
                    ),
                    "deadline", now,
                )
                continue
            if table is not None:
                tight = _planner.plan(
                    table, LatencyBudget(remaining),
                    default_r0=self.r0, default_steps=self.steps,
                )
                if tight.steps < r.plan.steps:
                    r.plan = tight
                    r.degraded = True
                    if r.explain is not None:
                        # the schedule the ticket will actually run is no
                        # longer the one resolution produced: re-stamp it
                        # and name the deadline re-plan as the cause
                        r.explain.replanned = "deadline"
                        r.explain.degraded = True
                        r.explain.plan_r0 = tight.r0
                        r.explain.plan_steps = tight.steps
                        r.explain.plan_termination = (
                            None if tight.termination is None
                            else repr(tight.termination)
                        )
            out.append(r)
        return out

    # ------------------------------------------------------------- the cache
    def _cache_key(self, name: str, version: int, query: np.ndarray,
                   engine: str, plan: ResolvedPlan):
        return self.cache.key(
            name, version, query, self.default_k, engine, plan.r0,
            plan.steps, plan.termination,
        )

    @staticmethod
    def _cache_key_str(key: tuple) -> str:
        """Human-readable form of a cache key for EXPLAIN records (the
        raw key embeds the query bytes; here they become a short
        digest)."""
        name, version, qbytes, k, engine, r0, steps, term = key
        qh = hashlib.blake2b(qbytes, digest_size=6).hexdigest()
        return (
            f"{name}@v{version}/q:{qh}/k{k}/{engine}/r0={r0:g}/s{steps}"
            + ("" if term is None else "/adaptive")
        )

    def _serve_cached(self, name: str, reqs: list[QueryRequest]):
        """Fill cache hits in place; returns the misses to dispatch.
        Explain'd requests are never cache-served silently: they bypass
        the read (annotated with the key they would have probed) so the
        EXPLAIN record always carries a real device story; their results
        are still published to the cache at completion."""
        if self.cache is None:
            for r in reqs:
                if r.explain is not None:
                    r.explain.cache_outcome = "uncached"
            return reqs
        # no version attribute -> no invalidation signal: never cache
        # (serving version-0 hits forever is exactly the staleness the
        # version contract exists to prevent)
        version = getattr(self.collections[name], "version", None)
        if version is None:
            for r in reqs:
                if r.explain is not None:
                    r.explain.cache_outcome = "uncached"
            return reqs
        misses = []
        for r in reqs:
            key = self._cache_key(name, version, r.query, r.engine, r.plan)
            if r.explain is not None:
                r.explain.cache_outcome = "bypass"
                r.explain.cache_key = self._cache_key_str(key)
                misses.append(r)
                continue
            entry = self.cache.get(key)
            if entry is None:
                misses.append(r)
                continue
            now = self._clock()
            # copies: tickets are handed to callers who may mutate them
            # in place, and the cached row must stay bit-identical
            r.dists = entry.dists[: r.k].copy()
            r.ids = entry.ids[: r.k].copy()
            if entry.payload is not None:
                r.payload = entry.payload[: r.k].copy()
            r.radius_steps = entry.radius_steps
            r.candidates = entry.candidates
            r.latency_ms = (now - r.submitted) * 1e3
            r.cached = True
            r.done = True
            if r.traced:
                self.tracer.instant(
                    "request.cache_hit", cat="request", t=now,
                    uid=r.uid, collection=name,
                )
            self._stats[name].record_hit(r, now)
            self._tstats(r.tenant).record_served(r, now)
            self.obs.exemplars.record(r.latency_ms, r.uid, name)
        return misses

    # ------------------------------------------------- issue / complete stages
    def _issue(self, name: str, reqs: list[QueryRequest],
               engine: str | None = None,
               plan: ResolvedPlan | None = None,
               with_explain: bool = False) -> None:
        """Stage 1: pad host-side and put the batch on the device without
        blocking: the padded batch goes up from page-locked memory,
        ``col.search`` enqueues its kernels, and its results come back
        into page-locked host tensors behind a CUDA event (see the module
        docstring); nothing here waits for the card.  With
        ``with_explain`` the dispatch runs the explain variant of the
        search (per-query per-step arrays ride back with the results)
        and the batch records its retry count and the fault sites its
        dispatch hit, for the tickets' EXPLAIN records."""
        col = self.collections[name]
        if engine is None:
            engine = self.resolve_engine(name)
        if plan is None:
            plan = self.resolve_plan(name)
        traced = self.tracer.enabled
        t_a0 = self._clock() if traced else 0.0
        m = len(reqs)
        shape = self._shape_for(m)
        d = reqs[0].query.shape[0]
        # a collection on the card gets the batch from page-locked memory
        # (a pageable copy would wait for the card); any other attachable
        # gets the numpy batch, as in the reference
        device = getattr(col, "device", None)
        on_card = device is not None and torch.device(device).type == "cuda"
        Qh = torch.zeros((shape, d), dtype=torch.float32, pin_memory=on_card)
        Qnp = Qh.numpy()
        for j, r in enumerate(reqs):
            Qnp[j] = r.query
        # termination= only travels when the plan carries one: a plain
        # (no-policy / FixedSchedule) dispatch keeps the documented
        # attachable search signature, so pre-tune attachables keep
        # working; an adaptive policy requires the attachable to accept
        # termination= (Collection does)
        term_kw = (
            {} if plan.termination is None
            else {"termination": plan.termination}
        )
        seq = self._batch_seq
        self._batch_seq += 1
        # lane = ring slot this batch will occupy, so a Perfetto render
        # shows overlap directly: batch N+1's issue span sits one lane up,
        # inside batch N's pending window
        tid = TID_RING0 + len(self._inflight)
        t_i0 = self._clock()
        # explain travels as an opt-in kwarg (like termination) so plain
        # attachables that predate it keep working on the default path
        explain_kw = {"with_explain": True} if with_explain else {}
        # fault-site attribution: anything the active plan fires between
        # here and a successful dispatch belongs to this batch
        fplan = faults.active_plan()
        fired0 = len(fplan.fired) if fplan is not None else 0
        attempts = 0
        explain_arrays = None
        while True:
            try:
                # fault sites (no-ops without an installed plan): an
                # injected latency spike scales with the schedule the
                # batch runs, like the real dispatch does
                faults.fire("dispatch.delay_ms", collection=name,
                            scale=plan.steps)
                faults.fire("dispatch.raise", collection=name, engine=engine)
                Q = upload(Qh, torch.device(device)) if on_card else Qnp
                out = col.search(
                    Q, k=self.default_k, r0=plan.r0, steps=plan.steps,
                    engine=engine, with_stats=True,
                    rows=m,  # only m of `shape` rows are real queries
                    **term_kw, **explain_kw,
                )
                if with_explain:
                    dists, ids, stats, explain_arrays = out
                else:
                    dists, ids, stats = out
                payload = None
                if getattr(col, "payload", None) is not None:
                    # gathered on the card, same stream
                    payload = _to_host(col.get_payload(ids[:m]))
                # the results' copies to the host, queued behind the
                # search on its stream, then the event that marks them
                event = None
                if isinstance(dists, torch.Tensor) and dists.is_cuda:
                    event = torch.cuda.Event()
                pending = PendingSearch(
                    _to_host(dists), _to_host(ids),
                    {k2: _to_host(v) for k2, v in stats.items()},
                    None if explain_arrays is None
                    else {k2: _to_host(v) for k2, v in explain_arrays.items()},
                    event=event,
                )
                if event is not None:
                    event.record(torch.cuda.current_stream(dists.device))
                break
            except Exception as e:
                attempts += 1
                transient = bool(getattr(e, "transient", False))
                if transient and attempts <= self.retry_limit:
                    self._sleep(
                        min(self.retry_backoff_cap_ms,
                            self.retry_backoff_ms * 2 ** (attempts - 1)) / 1e3
                    )
                    continue
                # exhausted (or non-transient): every ticket terminates
                # with a typed error — never parked in the ring forever
                err = DispatchFailed(
                    f"dispatch for collection {name!r} failed after "
                    f"{attempts} attempt(s): {e}"
                )
                err.__cause__ = e
                self._fail_batch(name, reqs, err, "dispatch")
                return
        t_i1 = self._clock()
        if traced:
            self.tracer.add_span(
                "batch.assemble", t_a0, t_i0, cat="batch", tid=TID_SCHEDULER,
                seq=seq, collection=name, rows=m, shape=shape,
            )
            self.tracer.add_span(
                "batch.issue", t_i0, t_i1, cat="batch", tid=tid,
                seq=seq, collection=name, rows=m, shape=shape,
                engine=engine, overlapped=len(self._inflight) > 0,
            )
        batch = _InFlight(
            name=name,
            reqs=reqs,
            shape=shape,
            pending=pending,
            payload=payload,
            version=getattr(col, "version", None),  # None = uncacheable
            overlapped=len(self._inflight) > 0,
            engine=engine,
            plan=plan,
            seq=seq,
            tid=tid,
            t_issued=t_i1,
            retries=attempts,
            fault_sites=(
                () if fplan is None
                else tuple(s for s, _ in fplan.fired[fired0:])
            ),
        )
        self._inflight.append(batch)
        self._g_ring.set(len(self._inflight))
        while len(self._inflight) > self.inflight_depth:
            self._complete(self._inflight.popleft())

    def _complete(self, batch: _InFlight) -> None:
        """Stage 2: the only host sync — wait on the batch's event (its
        results are then in the host tensors), fill the tickets, and publish cache entries under the version the
        batch was issued at (a mutation mid-flight bumps the version, so
        those entries are born unreachable rather than stale)."""
        traced = self.tracer.enabled
        t_c0 = self._clock() if traced else 0.0
        try:
            dists, ids, stats = batch.pending.result()
            dists = _numpy(dists)
            ids = _numpy(ids)
            steps_taken = _numpy(stats["radius_steps"])
            cands = _numpy(stats["candidates"])
            payloads = (
                None if batch.payload is None else _numpy(batch.payload)
            )
        except Exception as e:
            # the device-side computation died after issue: the tickets
            # still terminate, typed, instead of hanging in the ring
            err = DispatchFailed(
                f"completion for collection {batch.name!r} failed: {e}"
            )
            err.__cause__ = e
            self._fail_batch(batch.name, batch.reqs, err, "complete")
            self._g_ring.set(len(self._inflight))
            return
        now = self._clock()
        # issue->complete wall time feeds the EWMA straggler monitor —
        # in a sharded deployment a flagged batch is the signature of one
        # straggling shard holding the global merge hostage
        mon = self._stragglers.get(batch.name)
        if mon is None:
            mon = self._stragglers[batch.name] = StragglerMonitor()
        if mon.record(batch.seq, max(now - batch.t_issued, 0.0)):
            self._stats[batch.name].record_straggler()
        if traced:
            # pending window: issue handoff -> this host sync (batch N+1's
            # issue span lands inside it when the ring overlapped)
            self.tracer.add_span(
                "batch.pending", batch.t_issued, t_c0, cat="batch",
                tid=batch.tid, seq=batch.seq, collection=batch.name,
            )
            self.tracer.add_span(
                "batch.complete", t_c0, now, cat="batch", tid=batch.tid,
                seq=batch.seq, collection=batch.name, rows=len(batch.reqs),
            )
        ex = batch.pending.explain
        if ex is not None:
            ex = {k2: _numpy(v) for k2, v in ex.items()}
        for j, r in enumerate(batch.reqs):
            r.dists = dists[j, : r.k]
            r.ids = ids[j, : r.k]
            if payloads is not None:
                r.payload = payloads[j, : r.k]
            r.radius_steps = int(steps_taken[j])
            r.candidates = int(cands[j])
            r.latency_ms = (now - r.submitted) * 1e3
            if r.deadline_ms is not None and r.latency_ms > r.deadline_ms:
                r.degraded = True  # served, but past its budget — flagged
            if r.explain is not None and ex is not None:
                self._fill_explain(r, batch, ex, j, now)
            r.done = True
            if self.cache is not None and batch.version is not None:
                # copies: r.dists/r.ids above are views of the same batch
                # arrays, and callers own (and may mutate) their tickets
                self.cache.put(
                    self._cache_key(batch.name, batch.version, r.query,
                                    batch.engine, batch.plan),
                    CachedResult(
                        dists=dists[j].copy(),
                        ids=ids[j].copy(),
                        payload=None if payloads is None else payloads[j].copy(),
                        radius_steps=int(steps_taken[j]),
                        candidates=int(cands[j]),
                    ),
                )
            self._tstats(r.tenant).record_served(r, now)
            # tail-exemplar feed: every served ticket's (latency, uid)
            # lands in its latency bucket's ring; explain'd tickets keep
            # the full record so SLO breaches can render the worst-k
            self.obs.exemplars.record(
                r.latency_ms, r.uid, batch.name, r.explain
            )
        if traced and self.cache is not None and batch.version is not None:
            self.tracer.instant(
                "cache.put", cat="cache", t=now, tid=batch.tid,
                seq=batch.seq, collection=batch.name, entries=len(batch.reqs),
            )
        self._stats[batch.name].record_batch(
            batch.reqs, batch.shape, now, overlapped=batch.overlapped
        )
        self._g_ring.set(len(self._inflight))  # callers popleft before calling

    def _fill_explain(self, r: QueryRequest, batch: _InFlight,
                      ex: dict, j: int, now: float) -> None:
        """Finish one ticket's EXPLAIN record at completion: the batch's
        placement in the scheduler (seq / ring slot / fill), the device's
        per-step measurements for row ``j``, per-shard attribution when
        the sharded path gathered it, and the resilience story the issue
        stage recorded."""
        e = r.explain
        e.batch_seq = batch.seq
        e.ring_slot = batch.tid - TID_RING0
        e.batch_rows = len(batch.reqs)
        e.batch_shape = batch.shape
        e.steps_run = r.radius_steps
        e.candidates = r.candidates
        e.term_cause = TERM_CAUSE_NAMES.get(
            int(ex["term_cause"][j]), str(int(ex["term_cause"][j]))
        )
        e.final_radius = float(ex["final_radius"][j])
        e.step_half = [float(x) for x in ex["step_half"]]
        e.step_slots = [int(x) for x in ex["step_slots"][j]]
        if "shard_steps" in ex:  # sharded placement: pre-collapse view
            e.shard_steps = [int(x) for x in ex["shard_steps"][:, j]]
            e.shard_slots = [int(x) for x in ex["shard_slots"][:, j]]
            e.shard_cause = [int(x) for x in ex["shard_cause"][:, j]]
        e.degraded = r.degraded
        e.retries = batch.retries
        e.fault_sites = list(batch.fault_sites)
        e.latency_ms = r.latency_ms
        if r.traced and self.tracer.enabled:
            # instant on the request's async-span timeline: a Perfetto
            # view links the rendered explain back to the request by uid
            self.tracer.instant(
                "request.explain", cat="explain", t=now, uid=r.uid,
                collection=batch.name, term_cause=e.term_cause,
                steps_run=e.steps_run,
            )

    def _complete_all(self) -> None:
        while self._inflight:
            self._complete(self._inflight.popleft())

    # ------------------------------------------------------------ convenience
    def serve(self, collection: str, Q, k: int | None = None,
              tenant: str = "default", engine: str | None = None,
              policy=None, recall_target: float | None = None,
              deadline_ms: float | None = None,
              explain: bool | None = None):
        """Submit a whole query matrix as single requests, flush, and return
        stacked (dists, ids) — the micro-batching round trip.  All-or-
        nothing under quota: if any row is rejected, the rows already
        enqueued are withdrawn before :class:`QuotaExceeded` propagates
        (no orphaned tickets dispatching work nobody observes).  A ticket
        that terminated with a typed error (deadline, failed dispatch)
        re-raises that error here — callers driving tickets individually
        check ``req.error`` instead."""
        reqs = []
        try:
            for q in np.atleast_2d(Q):
                reqs.append(
                    self.submit(collection, q, k=k, tenant=tenant,
                                engine=engine, policy=policy,
                                recall_target=recall_target,
                                deadline_ms=deadline_ms, explain=explain)
                )
        except QuotaExceeded:
            queue = self._queues[collection].get(tenant)
            for r in reqs:
                if queue is not None and r in queue:
                    queue.remove(r)
                    # counters are monotonic: withdrawal is its own counter,
                    # and the snapshot reports submitted - withdrawn
                    self._tenant_stats[tenant].record_withdrawn()
            self._g_queue.set(self.pending())
            raise
        self.flush()
        for r in reqs:
            if r.error is not None:
                raise r.error
        return (
            np.stack([r.dists for r in reqs]),
            np.stack([r.ids for r in reqs]),
            reqs,
        )

    def stats(self, collection: str | None = None) -> dict:
        if collection is not None:
            return self._stats[collection].snapshot()
        return {name: s.snapshot() for name, s in self._stats.items()}

    def tenant_stats(self, tenant: str | None = None) -> dict:
        """Per-tenant admission/serving counters (+ QPS)."""
        if tenant is not None:
            return self._tenant_stats[tenant].snapshot()
        return {t: s.snapshot() for t, s in self._tenant_stats.items()}

    def cache_stats(self) -> dict:
        return {"size": 0, "hits": 0, "misses": 0} if self.cache is None \
            else self.cache.stats()
