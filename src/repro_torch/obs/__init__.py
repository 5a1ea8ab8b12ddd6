"""repro_torch.obs — observability for the serving stack.

Three pieces, one bundle (DESIGN.md §10):

* ``trace``   — :class:`~repro_torch.obs.trace.Tracer`: a bounded, typed span
  recorder.  Every submitted request leaves a trace across submit →
  quota admission → queue wait → batch assembly → device dispatch →
  in-flight ring pending window → host sync → cache put, and every
  collection lifecycle mutation (add/remove/compact/calibrate/snapshot,
  local and sharded) records a span on the same timeline.  Exports
  JSONL and Chrome/Perfetto ``trace_event`` JSON; the search stages'
  ``torch.profiler.record_function`` ranges (``dblsh.project`` …
  ``dblsh.merge``) let a device profile correlate with the host spans
  by name.

* ``metrics`` — :class:`~repro_torch.obs.metrics.MetricsRegistry`: counters,
  gauges, and fixed-bucket histograms (latency, queue depth, batch
  fill, ring occupancy, verified slots, termination steps, cache
  hits/misses, quota rejections, per-tenant traffic) with Prometheus
  text + JSON exporters.  ``StoreService.stats()`` /
  ``tenant_stats()`` keep their exact keys but are *views over the
  registry* — no more private stat structs.

* ``slo``     — :class:`~repro_torch.obs.slo.SLOWatch`: rolling p50/p99
  latency objectives and a ground-truth-free recall drift proxy (the
  observed termination-step distribution vs the calibrated
  ``ScheduleTable`` prediction), emitting structured
  :class:`~repro_torch.obs.slo.BreachEvent` records.

Overhead contract: tracing is **off by default** and every hot-path
site guards on one attribute read; metrics are always on (plain dict
arithmetic per request).  The reference gates the enabled stack at 5 %
of obs-off QPS (``benchmarks/store_throughput.py --obs``); the port has
no such benchmark yet.

Typical use (``StoreService`` comes with the port of ``store/service.py``;
the tracer and the registry work without it)::

    from repro_torch.store import Collection, StoreService
    from repro_torch.obs import Observability, SLOWatch

    obs = Observability(trace=True)           # or trace=False: metrics only
    svc = StoreService(batch_shapes=(1, 8), default_k=10, obs=obs)
    svc.attach(col)
    ... serve ...
    print(svc.stats("docs"))                  # same keys, registry-backed
    print(obs.registry.to_prometheus())       # /metrics scrape text
    obs.tracer.export_perfetto("trace.json")  # load in ui.perfetto.dev

    watch = SLOWatch(obs.registry, "docs", table=col.calibration,
                     latency_p99_ms=5.0, drift_threshold=0.25)
    for breach in watch.check():
        print(breach.message)                 # the drift signal
"""

from .explain import (
    DEFAULT_EXPLAIN_SAMPLE_RATE,
    ExemplarReservoir,
    QueryExplain,
    TERM_CAUSE_NAMES,
)
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    get_registry,
)
from .slo import BreachEvent, SLOWatch, expected_step_pmf
from .trace import Span, Tracer, get_tracer

__all__ = [
    "BreachEvent",
    "Counter",
    "DEFAULT_EXPLAIN_SAMPLE_RATE",
    "ExemplarReservoir",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Observability",
    "QueryExplain",
    "SLOWatch",
    "Span",
    "TERM_CAUSE_NAMES",
    "Tracer",
    "default_registry",
    "expected_step_pmf",
    "get_registry",
    "get_tracer",
]


class Observability:
    """The bundle a service consumes: one registry + one tracer (+ an
    optional SLO watch attached after construction).

    Defaults keep surprises out: a *fresh* registry (no cross-service
    bleed; pass ``repro_torch.obs.default_registry`` to share a process-wide
    scrape surface) and the *process-global* tracer (lifecycle spans
    from collections land on the same timeline as the service's batch
    spans).  ``trace=True`` enables that tracer; ``sample_rate`` thins
    per-request spans (batch spans always record while enabled).
    """

    def __init__(self, *, registry: MetricsRegistry | None = None,
                 tracer: Tracer | None = None, trace: bool = False,
                 sample_rate: float | None = None,
                 exemplars: ExemplarReservoir | None = None,
                 explain_sample_rate: float = 0.0):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else get_tracer()
        if trace:
            self.tracer.enable(sample_rate)
        self.slo: SLOWatch | None = None
        # tail-latency exemplars: every served ticket's (latency, uid)
        # lands here; explain'd tickets keep their full QueryExplain, and
        # SLO breaches pull the worst-k back out (obs.explain)
        self.exemplars = (
            exemplars if exemplars is not None else ExemplarReservoir()
        )
        # auto-explain sampling: submit(explain=None) explains 1 request
        # in round(1/rate), counter-based (deterministic under test, like
        # the tracer's sampler).  Off by default (rate 0) — explicit
        # submit(explain=True) always works; pass
        # explain_sample_rate=DEFAULT_EXPLAIN_SAMPLE_RATE to arm the
        # production tail-exemplar feed
        self.explain_sample_rate = explain_sample_rate
        self._explain_stride = (
            round(1.0 / explain_sample_rate) if explain_sample_rate > 0
            else 0
        )
        self._explain_seen = 0

    def should_explain(self) -> bool:
        """Deterministic counter-based sampler for auto-explain: true
        once per ``round(1/explain_sample_rate)`` calls (first call
        fires, so short tests and thin traffic still sample)."""
        if self._explain_stride <= 0:
            return False
        hit = self._explain_seen % self._explain_stride == 0
        self._explain_seen += 1
        return hit

    def watch(self, collection: str, **kw) -> SLOWatch:
        """Arm (and return) an :class:`SLOWatch` over ``collection`` on
        this bundle's registry/tracer; stored on ``self.slo`` so a
        service can drive ``maybe_check`` from its scheduler loop.
        The bundle's exemplar reservoir rides along by default, so
        breaches carry rendered tail explains."""
        kw.setdefault("tracer", self.tracer)
        kw.setdefault("exemplars", self.exemplars)
        self.slo = SLOWatch(self.registry, collection, **kw)
        return self.slo
