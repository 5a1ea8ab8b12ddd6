"""The port's copy of ``obs`` held to tests/test_obs.py.

Its classes that need no service, on the port's package: ``TestTracer``,
``TestMetrics``, ``TestExports``, ``TestSLOWatch`` without its service
case, ``TestExemplarReservoir`` and ``TestPrometheusHardening``
(tests/test_obs.py:103-312, :470-579, :744-798), each case as the
reference has it; and the lifecycle spans of :407 on the port's
``Collection``.  The service cases on the port's ``StoreService`` over
the reference fixture's index carried across (``from_arrays``):
``TestServiceIntegration`` (:313), ``test_obs_on_off_bit_equal`` (:431)
and ``TestExplainDevice`` (:580) on every engine,
``TestSLOWatch::test_service_drives_slo_from_step`` (:563) and
``TestExplainService`` (:617).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
R = pytest.importorskip("_torch_parity")

from repro_torch.core import (  # noqa: E402
    DBLSHParams,
    Termination,
    from_arrays,
    search_batch_fixed,
)
from repro_torch.obs import (  # noqa: E402
    BreachEvent,
    ExemplarReservoir,
    MetricsRegistry,
    Observability,
    QueryExplain,
    SLOWatch,
    Tracer,
    expected_step_pmf,
    get_tracer,
)
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.obs.trace import (  # noqa: E402
    TID_LIFECYCLE,
    TID_RING0,
    TID_SCHEDULER,
    TID_SEARCH,
)
from repro_torch.store import (  # noqa: E402
    Collection,
    DeadlineExceeded,
    QuotaExceeded,
    StoreService,
)
from repro_torch.tune import ScheduleTable  # noqa: E402

ENGINES = ("torch", "kernel", "inline")


class FakeClock:
    """Injectable monotonic clock: time only moves when told to."""

    def __init__(self, start: float = 0.0):
        self.now = start

    def __call__(self) -> float:
        return self.now

    def advance(self, seconds: float) -> float:
        self.now += seconds
        return self.now


@pytest.fixture(scope="module")
def setup():
    return R.obs_fixture()


@pytest.fixture(scope="module")
def col(setup):
    """tests/test_obs.py's collection: the reference builds it, the port
    takes its arrays."""
    data, _, kb = setup
    params = R.DBLSHParams.derive(
        n=256, d=12, c=1.5, w0=3.6, t=12, k=8, inline_vectors=True
    )
    _, arrays, ref_params = R.ref_collection_arrays("obscol", kb, data, params=params)
    return Collection.from_index("obscol", from_arrays(arrays, ref_params, device="cpu"))


@pytest.fixture(autouse=True)
def _global_tracer_clean():
    """Tests that enable the process-global tracer must not leak state
    into each other."""
    tr = get_tracer()
    yield
    tr.disable()
    tr.clear()




# --------------------------------------------------------------- tracer units
class TestTracer:
    def test_disabled_records_nothing(self):
        clk = FakeClock()
        tr = Tracer(clock=clk)
        tr.add_span("a", 0.0, 1.0)
        tr.instant("b")
        with tr.span("c") as sp:
            sp.set(x=1)  # nop handle
        assert not tr.events
        assert not tr.should_sample()

    def test_two_phase_spans_and_ordering(self):
        clk = FakeClock()
        tr = Tracer(enabled=True, clock=clk)
        tr.add_span("late", 5.0, 7.0, tid=TID_RING0 + 1, seq=2)
        tr.add_span("early", 1.0, 6.0, tid=TID_RING0, seq=1)
        # export order is by start time, not insertion order
        names = [s.name for s in sorted(tr.events, key=lambda s: s.ts)]
        assert names == ["early", "late"]
        early = next(s for s in tr.events if s.name == "early")
        assert early.dur == pytest.approx(5.0)
        assert early.args["seq"] == 1

    def test_nesting_parents(self):
        clk = FakeClock()
        tr = Tracer(enabled=True, clock=clk)
        with tr.span("outer"):
            clk.advance(1.0)
            with tr.span("inner") as sp:
                clk.advance(0.5)
                sp.set(rows=3)
        inner = next(s for s in tr.events if s.name == "inner")
        outer = next(s for s in tr.events if s.name == "outer")
        assert inner.parent == outer.sid
        assert outer.parent is None
        assert inner.args == {"rows": 3}
        assert inner.dur == pytest.approx(0.5)
        assert outer.dur == pytest.approx(1.5)

    def test_deterministic_sampling(self):
        tr = Tracer(enabled=True, sample_rate=0.5)
        fired = [tr.should_sample() for _ in range(10)]
        assert sum(fired) == 5
        # counter-based, not random: a fresh tracer fires identically
        tr_again = Tracer(enabled=True, sample_rate=0.5)
        assert [tr_again.should_sample() for _ in range(10)] == fired
        tr2 = Tracer(enabled=True, sample_rate=1.0)
        assert all(tr2.should_sample() for _ in range(5))

    def test_bounded_ring(self):
        tr = Tracer(enabled=True, maxlen=4)
        for i in range(10):
            tr.add_span(f"s{i}", float(i), float(i) + 0.5)
        assert len(tr.events) == 4
        assert [s.name for s in tr.events] == ["s6", "s7", "s8", "s9"]


# -------------------------------------------------------------- metrics units
class TestMetrics:
    def test_counter_and_gauge(self):
        reg = MetricsRegistry()
        c = reg.counter("t_total", "help")
        c.inc(tenant="a")
        c.inc(2.0, tenant="a")
        c.inc(tenant="b")
        assert c.value(tenant="a") == 3.0
        assert c.value(tenant="b") == 1.0
        assert c.value(tenant="zzz") == 0.0
        g = reg.gauge("depth")
        g.set(4.0)
        g.inc(-1.0)
        assert g.value() == 3.0
        # get-or-create returns the same family; kind mismatch raises
        assert reg.counter("t_total") is c
        with pytest.raises(TypeError):
            reg.gauge("t_total")

    def test_histogram_bucket_math(self):
        reg = MetricsRegistry()
        h = reg.histogram("lat", buckets=(1.0, 5.0, 10.0), window=16)
        for v in (0.5, 1.0, 1.01, 7.0, 100.0):
            h.observe(v)
        # Prometheus le (≤) semantics: 1.0 lands in the le="1" bucket
        cum = h.cumulative_buckets()
        assert [(ub, n) for ub, n in cum] == [
            (1.0, 2), (5.0, 3), (10.0, 4), (float("inf"), 5),
        ]
        assert h.count() == 5
        assert h.sum() == pytest.approx(109.51)
        assert h.mean() == pytest.approx(109.51 / 5)

    def test_exact_window_percentiles(self):
        reg = MetricsRegistry()
        h = reg.histogram("lat", window=8)
        vals = [40.0, 30.0, 20.0, 10.0]
        for v in vals:
            h.observe(v, collection="c")
        p50, p99 = h.percentile([50.0, 99.0], collection="c")
        np.testing.assert_allclose(
            [p50, p99], np.percentile(vals, [50, 99])
        )
        # window is a ring: old observations age out
        for v in [1.0] * 8:
            h.observe(v, collection="c")
        assert h.percentile(99.0, collection="c") == pytest.approx(1.0)

    def test_empty_reads_are_zero(self):
        reg = MetricsRegistry()
        h = reg.histogram("lat", window=8)
        assert h.percentile(50.0) == 0.0
        assert list(h.percentile([50.0, 99.0])) == [0.0, 0.0]
        assert h.mean() == 0.0
        assert h.count() == 0


# ------------------------------------------------------------------- exports
class TestExports:
    def test_prometheus_text(self):
        reg = MetricsRegistry()
        reg.counter("repro_q_total", "queries").inc(3, collection="a")
        h = reg.histogram("repro_lat", "ms", buckets=(1.0, 10.0))
        h.observe(0.5, collection="a")
        h.observe(5.0, collection="a")
        text = reg.to_prometheus()
        assert "# TYPE repro_q_total counter" in text
        assert 'repro_q_total{collection="a"} 3' in text
        assert '# TYPE repro_lat histogram' in text
        assert 'repro_lat_bucket{collection="a",le="1"} 1' in text
        assert 'repro_lat_bucket{collection="a",le="10"} 2' in text
        assert 'repro_lat_bucket{collection="a",le="+Inf"} 2' in text
        assert 'repro_lat_sum{collection="a"} 5.5' in text
        assert 'repro_lat_count{collection="a"} 2' in text

    def test_registry_json_roundtrip(self, tmp_path):
        reg = MetricsRegistry()
        reg.counter("c_total").inc(7, tenant="t")
        reg.histogram("h", buckets=(1.0,)).observe(2.0)
        path = tmp_path / "metrics.json"
        reg.export_json(str(path))
        blob = json.loads(path.read_text())
        assert blob["c_total"]["type"] == "counter"
        assert blob["c_total"]["series"][0] == {
            "labels": {"tenant": "t"}, "value": 7.0,
        }
        hist = blob["h"]["series"][0]
        assert hist["count"] == 1
        assert hist["buckets"][-1] == {"le": "+Inf", "count": 1}

    def test_jsonl_roundtrip(self, tmp_path):
        clk = FakeClock()
        tr = Tracer(enabled=True, clock=clk)
        tr.add_span("b", 2.0, 3.0, cat="batch", seq=1)
        tr.add_span("a", 0.0, 1.0, cat="batch", seq=0)
        path = tmp_path / "spans.jsonl"
        assert tr.export_jsonl(str(path)) == 2
        rows = [json.loads(l) for l in path.read_text().splitlines()]
        assert [r["name"] for r in rows] == ["a", "b"]  # time-sorted
        assert rows[0]["dur"] == pytest.approx(1.0)
        assert rows[1]["args"]["seq"] == 1

    def test_perfetto_timeline(self, tmp_path):
        clk = FakeClock()
        tr = Tracer(enabled=True, clock=clk)
        # overlapping request spans -> async pairs; batch span on a ring
        # lane; one instant
        tr.add_span("request.queue_wait", 0.0, 2.0, cat="request", uid=1)
        tr.add_span("request.queue_wait", 1.0, 3.0, cat="request", uid=2)
        tr.add_span("batch.pending", 1.0, 2.5, cat="batch",
                    tid=TID_RING0, seq=0)
        tr.instant("cache.put", t=2.5, entries=4)
        path = tmp_path / "trace.json"
        tr.export_perfetto(str(path))
        blob = json.loads(path.read_text())
        ev = blob["traceEvents"]
        # ring lane got a thread_name metadata record
        meta = [e for e in ev if e["ph"] == "M"]
        assert any(e["tid"] == TID_RING0 and "ring slot 0" in
                   e["args"]["name"] for e in meta)
        # request spans became b/e async pairs keyed on uid
        pairs = [e for e in ev if e["ph"] in ("b", "e")]
        assert len(pairs) == 4
        b1 = next(e for e in pairs if e["ph"] == "b" and e["id"] == "1")
        e1 = next(e for e in pairs if e["ph"] == "e" and e["id"] == "1")
        # starts on the profiler's base (µs of the Unix epoch)
        assert b1["ts"] == pytest.approx(tr.to_trace_ns(0.0) / 1e3, abs=1.0)
        assert e1["ts"] - b1["ts"] == pytest.approx(2.0 * 1e6, abs=1.0)  # µs
        # the batch span is a complete X slice with µs duration
        x = next(e for e in ev if e["ph"] == "X")


# ------------------------------------------------------------------ SLO watch
def _feed_latency(reg, values, collection="c"):
    h = reg.histogram(
        "repro_store_latency_ms", window=8192
    )
    for v in values:
        h.observe(v, collection=collection)


def _feed_steps(reg, pmf_counts, collection="c"):
    c = reg.counter("repro_store_termination_steps_total")
    for step, n in pmf_counts.items():
        c.inc(n, collection=collection, step=step)


class TestSLOWatch:
    def test_expected_pmf_from_table(self):
        table = ScheduleTable(
            r0=1.0, c=1.5, k=8, recall=(0.5, 0.8, 0.9),
            cost_slots=(1.0, 2.0, 3.0),
            cost_ms=(float("nan"),) * 3, n_sample=64,
        )
        pmf = expected_step_pmf(table)
        # recall increments normalized by final recall; residual
        # (never-certified) mass folds into the tail bin
        np.testing.assert_allclose(
            [pmf[1], pmf[2], pmf[3]],
            [0.5 / 0.9, 0.3 / 0.9, 0.1 / 0.9 + 0.0],
        )
        assert sum(pmf.values()) == pytest.approx(1.0)
        # plan_steps caps the support
        pmf2 = expected_step_pmf(table, steps=2)
        assert set(pmf2) == {1, 2}
        assert sum(pmf2.values()) == pytest.approx(1.0)

    def test_latency_breach_fires(self):
        clk = FakeClock()
        reg = MetricsRegistry()
        _feed_latency(reg, [1.0] * 40 + [50.0] * 24)
        seen = []
        watch = SLOWatch(
            reg, "c", latency_p99_ms=20.0, latency_p50_ms=100.0,
            min_samples=32, clock=clk, on_breach=seen.append,
        )
        events = watch.check()
        assert [e.kind for e in events] == ["latency_p99"]
        assert isinstance(events[0], BreachEvent)
        assert events[0].observed > 20.0
        assert seen == events
        assert reg.get("repro_store_slo_breaches_total").value(
            collection="c", kind="latency_p99"
        ) == 1
        # below min_samples: silent
        reg2 = MetricsRegistry()
        _feed_latency(reg2, [50.0] * 10)
        assert not SLOWatch(
            reg2, "c", latency_p99_ms=20.0, min_samples=32, clock=clk
        ).check()

    def test_scripted_drift_breach(self):
        clk = FakeClock()
        reg = MetricsRegistry()
        table = ScheduleTable(
            r0=1.0, c=1.5, k=8, recall=(0.6, 0.85, 0.95),
            cost_slots=(1.0, 2.0, 3.0),
            cost_ms=(float("nan"),) * 3, n_sample=64,
        )
        watch = SLOWatch(
            reg, "c", table=table, drift_threshold=0.25, min_samples=32,
            window_s=60.0, clock=clk,
        )
        # phase 1: traffic matches the calibrated prediction -> no breach
        exp = expected_step_pmf(table)
        _feed_steps(reg, {s: int(round(p * 200)) for s, p in exp.items()})
        assert watch.check(clk.advance(1.0)) == []
        drift0 = reg.get("repro_store_termination_drift").value(
            collection="c"
        )
        assert drift0 < 0.25
        # phase 2: the workload hardens — everything terminates at the
        # final step, far from the prediction -> drift breach
        _feed_steps(reg, {3: 400})
        events = watch.check(clk.advance(1.0))
        assert [e.kind for e in events] == ["termination_drift"]
        ev = events[0]
        assert ev.observed > 0.25
        assert ev.detail["expected_pmf"] == exp
        assert "re-calibrate" in ev.message
        # the rolling window forgets: after window_s of healthy traffic
        # the drift clears
        clk.advance(120.0)
        _feed_steps(reg, {s: int(round(p * 400)) for s, p in exp.items()})
        assert watch.check(clk.advance(1.0)) == []

    def test_maybe_check_rate_limits(self):
        clk = FakeClock()
        reg = MetricsRegistry()
        _feed_latency(reg, [50.0] * 64)
        watch = SLOWatch(
            reg, "c", latency_p99_ms=1.0, min_samples=32,
            check_interval_s=1.0, clock=clk,
        )
        assert watch.maybe_check()          # first call evaluates
        assert watch.maybe_check() == []    # inside the interval: skipped
        clk.advance(1.5)
        assert watch.maybe_check()          # interval elapsed: breach again
        assert len(watch.events) == 2

    def test_service_drives_slo_from_step(self, setup, col):
        _, queries, _ = setup
        clk = FakeClock()
        svc = _service(col, clk, cache_size=0, max_wait_ms=1e9)
        seen = []
        svc.obs.watch(
            "obscol", latency_p99_ms=0.5, min_samples=1,
            check_interval_s=0.0, clock=clk, on_breach=seen.append,
        )
        for q in queries[:4]:
            svc.submit("obscol", q)
        clk.advance(0.01)  # 10 ms of queue wait: p99 >> the 0.5 ms objective
        svc.step(force=True)
        assert seen and seen[0].kind == "latency_p99"


class TestExemplarReservoir:
    def test_worst_walks_tail_first(self):
        res = ExemplarReservoir(buckets=(1.0, 10.0), per_bucket=4)
        for uid, lat in enumerate([0.5, 5.0, 50.0, 2.0]):
            res.record(lat, uid, "c")
        worst = res.worst(3)
        assert [w["uid"] for w in worst] == [2, 1, 3]
        assert worst[0]["latency_ms"] == 50.0
        # collection filter
        res.record(99.0, 7, "other")
        assert [w["uid"] for w in res.worst(1, collection="c")] == [2]

    def test_explain_store_is_bounded(self):
        res = ExemplarReservoir(buckets=(1.0,), per_bucket=2, max_explains=3)
        for uid in range(6):
            res.record(0.5, uid, "c", QueryExplain(uid=uid, collection="c"))
        assert len(res.explains()) == 3
        assert res.explain_for(5) is not None  # newest kept
        assert res.explain_for(0) is None      # oldest evicted
        # rings are bounded too
        blob = res.to_json()
        assert len(blob["exemplars"]) <= 2 * 2  # per_bucket x (buckets+inf)

    def test_export_json(self, tmp_path):
        res = ExemplarReservoir()
        res.record(3.0, 1, "c", QueryExplain(uid=1, collection="c"))
        path = str(tmp_path / "explains.json")
        assert res.export_json(path) == 1
        blob = json.loads(open(path).read())
        assert blob["explains"][0]["uid"] == 1
        assert blob["exemplars"][0]["latency_ms"] == 3.0


class TestPrometheusHardening:
    def test_label_values_escaped(self):
        """Satellite: text-format escaping for quotes, backslashes, and
        newlines in label values."""
        reg = MetricsRegistry()
        c = reg.counter("esc_total", "escaping")
        c.inc(path='say "hi"\\now', msg="line1\nline2")
        text = reg.to_prometheus()
        assert 'path="say \\"hi\\"\\\\now"' in text
        assert 'msg="line1\\nline2"' in text
        # round-trip sanity: exactly one sample line, parseable shape
        sample = [l for l in text.splitlines() if l.startswith("esc_total{")]
        assert len(sample) == 1 and sample[0].endswith(" 1")

    def test_empty_registry_exports_valid_empty_text(self):
        assert MetricsRegistry().to_prometheus() == ""

    def test_json_export_unaffected(self):
        reg = MetricsRegistry()
        reg.counter("c_total").inc(v='a"b')
        blob = reg.to_json()
        assert blob["c_total"]["series"][0]["labels"] == {"v": 'a"b'}


# -------------------------------------------------------- lifecycle spans
def test_lifecycle_spans_on_global_tracer():
    """tests/test_obs.py:407 on the port's Collection: add, remove,
    compact, calibrate and snapshot record on the global tracer's
    lifecycle lane."""
    data, _, _ = R.resilience_fixture()
    data = data[:240]
    params = DBLSHParams.derive(
        n=240, d=12, c=1.5, w0=3.6, t=12, k=8, inline_vectors=True
    )
    c2 = Collection.create("mut", torch.Generator().manual_seed(31), data,
                           params=params, device="cpu")
    tr = get_tracer()
    tr.enable()
    try:
        ids = c2.add(data[:3] + 0.5)
        c2.remove(ids[:1])
        c2.compact()
    finally:
        tr.disable()
    by_name = {s.name: s for s in tr.events}
    assert {"lifecycle.add", "lifecycle.remove",
            "lifecycle.compact"} <= set(by_name)
    add = by_name["lifecycle.add"]
    assert add.tid == TID_LIFECYCLE
    assert add.args["rows"] == 3 and "version" in add.args
    assert by_name["lifecycle.compact"].args["n_after"] > 0


# ------------------------------------------------------- service integration
EXPECTED_STATS_KEYS = {
    "queries", "batches", "qps", "latency_ms_p50", "latency_ms_p90",
    "latency_ms_p99", "latency_ms_mean", "mean_radius_steps",
    "mean_candidates", "termination_steps_hist", "padding_efficiency",
    "cache_hits", "cache_hit_rate", "overlap_ratio",
    "failed", "degraded", "straggler_batches",
}


def _service(col, clk, **kw):
    kw.setdefault("batch_shapes", (1, 4, 8))
    kw.setdefault("default_k", 8)
    kw.setdefault("steps", 4)
    svc = StoreService(clock=clk, **kw)
    svc.attach(col)
    return svc


class TestServiceIntegration:
    def test_stats_keys_and_registry_backing(self, setup, col):
        _, queries, _ = setup
        clk = FakeClock()
        svc = _service(col, clk)
        svc.serve("obscol", queries[:4])
        s = svc.stats("obscol")
        assert set(s.keys()) == EXPECTED_STATS_KEYS
        reg = svc.registry
        assert reg.get("repro_store_queries_served_total").value(
            collection="obscol"
        ) == s["queries"] == 4
        assert reg.get("repro_store_latency_ms").count(
            collection="obscol"
        ) == 4
        # p90/mean agree with exact numpy over the same window
        lat = reg.get("repro_store_latency_ms")
        win = np.asarray(
            lat._series[(("collection", "obscol"),)].window, np.float64
        )
        np.testing.assert_allclose(s["latency_ms_p90"], np.percentile(win, 90))
        np.testing.assert_allclose(s["latency_ms_mean"], win.mean())

    def test_empty_snapshot_is_zero_safe(self, col):
        svc = _service(col, FakeClock())
        s = svc.stats("obscol")
        for key, v in s.items():
            if key == "termination_steps_hist":
                assert v == {}
            else:
                assert v == 0 or v == 0.0, (key, v)
        t = StoreService(batch_shapes=(1,), default_k=8)
        # no tenants served yet -> no entries, and cache stats are 0-safe
        assert t.cache_stats()["hit_rate"] == 0.0

    def test_gauges_track_queue_and_ring(self, setup, col):
        _, queries, _ = setup
        clk = FakeClock()
        svc = _service(col, clk, inflight_depth=2, max_wait_ms=1e9)
        for q in queries[:3]:
            svc.submit("obscol", q)
        assert svc.registry.get("repro_store_queue_depth").value() == 3
        svc.flush()
        assert svc.registry.get("repro_store_queue_depth").value() == 0
        assert svc.registry.get("repro_store_inflight_batches").value() == 0

    def test_quota_withdrawal_counters(self, setup, col):
        _, queries, _ = setup
        clk = FakeClock()
        svc = _service(col, clk)
        svc.set_quota("t", rate=1.0, burst=2)
        with pytest.raises(QuotaExceeded):
            svc.serve("obscol", queries[:4], tenant="t")
        ts = svc.tenant_stats("t")
        assert ts["submitted"] == 0          # snapshot: submitted - withdrawn
        assert ts["rejected"] == 1
        reg = svc.registry
        assert reg.get("repro_store_tenant_submitted_total").value(
            tenant="t"
        ) == 2                               # the raw counter stays monotonic
        assert reg.get("repro_store_tenant_withdrawn_total").value(
            tenant="t"
        ) == 2
        assert reg.get("repro_store_quota_rejections_total").value(
            tenant="t"
        ) == 1

    def test_cache_metrics_bound(self, setup, col):
        _, queries, _ = setup
        svc = _service(col, FakeClock(), cache_size=64)
        svc.serve("obscol", queries[:2])
        svc.serve("obscol", queries[:2])
        reg = svc.registry
        assert reg.get("repro_store_result_cache_hits_total").value() == 2
        assert reg.get("repro_store_result_cache_misses_total").value() == 2
        assert reg.get("repro_store_result_cache_size").value() == 2
        assert svc.stats("obscol")["cache_hit_rate"] == pytest.approx(0.5)

    def test_request_and_batch_spans(self, setup, col):
        _, queries, _ = setup
        clk = FakeClock()
        obs = Observability(tracer=Tracer(enabled=True, clock=clk))
        svc = _service(col, clk, obs=obs)
        svc.serve("obscol", queries[:4])
        names = {s.name for s in obs.tracer.events}
        assert {"request.queue_wait", "batch.assemble", "batch.issue",
                "batch.pending", "batch.complete"} <= names
        issue = next(s for s in obs.tracer.events if s.name == "batch.issue")
        assert issue.tid >= TID_RING0
        assemble = next(
            s for s in obs.tracer.events if s.name == "batch.assemble"
        )
        assert assemble.tid == TID_SCHEDULER


# ---------------------------------------------------------------- bit-equality
@pytest.mark.parametrize(
    "path,engine",
    [pytest.param("service", e, id=e) for e in ENGINES]
    + [pytest.param("batch", e, id=f"batch-{e}") for e in ENGINES],
)
def test_obs_on_off_bit_equal(setup, col, path, engine):
    """The whole observability stack enabled (tracing, sampling 1.0)
    must not change a single output bit vs obs-off, per engine: through
    the service, and through ``Collection.search`` with the process
    tracer recording its search spans."""
    _, queries, _ = setup

    def run(obs):
        if path == "batch":
            d, i = col.search(queries[:8], k=8, steps=4, engine=engine)
            return d.numpy(), i.numpy()
        svc = StoreService(
            batch_shapes=(1, 4, 8), default_k=8, steps=4, engine=engine,
            inflight_depth=2, obs=obs,
        )
        svc.attach(col)
        d, i, _ = svc.serve("obscol", queries[:8])
        return np.asarray(d), np.asarray(i)

    d_off, i_off = run(None)
    obs = Observability(tracer=get_tracer() if path == "batch" else Tracer(),
                        trace=True)
    d_on, i_on = run(obs)
    assert obs.tracer.events  # it really traced
    np.testing.assert_array_equal(d_off, d_on)
    np.testing.assert_array_equal(i_off, i_on)


# ------------------------------------------------------------- search spans
STAGES = ("dblsh.project", "dblsh.select", "dblsh.verify", "dblsh.merge")


def test_collection_search_records_its_spans(setup, col):
    """One ``Collection.search`` with the process tracer enabled: one
    ``store.search`` span on the search lane with the call's args, the
    parent of the four stage spans; the merge's span carries the steps it
    ran and the host syncs early exit made."""
    _, queries, _ = setup
    tr = get_tracer()
    col.search(queries[:5], k=8, steps=4, engine="inline")
    assert not tr.events  # disabled: nothing recorded
    tr.enable()
    col.search(queries[:5], k=8, steps=4, engine="inline", rows=3)
    (call,) = [s for s in tr.events if s.name == "store.search"]
    assert call.tid == TID_SEARCH and call.parent is None
    assert call.args == {"collection": "obscol", "rows": 3, "k": 8, "steps": 4,
                         "engine": "inline", "dtype": "fp32"}
    stages = [s for s in tr.events if s.name != "store.search"]
    assert [s.name for s in stages] == list(STAGES)
    assert all(s.parent == call.sid and s.tid == TID_SEARCH for s in stages)
    assert all(call.ts <= s.ts and s.ts + s.dur <= call.ts + call.dur
               for s in stages)
    assert stages[-1].args == {"steps": 4, "syncs": 0}
    tr.clear()
    col.search(queries[:5], k=0, steps=6, engine="torch",
               termination=Termination(use_c1=False, c1_budget=0))
    merge = next(s for s in tr.events if s.name == "dblsh.merge")
    call = next(s for s in tr.events if s.name == "store.search")
    assert call.args["k"] == col.index.params.k
    assert 1 <= merge.args["steps"] <= 6
    # a sync before every step but the first, until the exit
    assert merge.args["syncs"] == min(merge.args["steps"], 5)


@pytest.mark.cuda
def test_search_on_the_card_merges_in_one_launch():
    """On the card a fused search with a ``Termination()`` (early exit on)
    merges through kernel M1: ``dblsh.merge`` records the schedule's
    steps, no host sync and the kernel's mark, and the call makes one
    ``merge_schedule`` launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel M1 has no CPU mode")
    from repro_torch.core import build
    from repro_torch.kernels import launches

    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    data = torch.from_numpy(rng.standard_normal((2048, 12)).astype(np.float32))
    params = DBLSHParams.derive(n=2048, d=12, k=8, K=5, L=3, inline_vectors=True)
    proj = torch.from_numpy(rng.standard_normal((params.L, params.K, 12)).astype(np.float32))
    col = Collection.from_index(
        "m1col", build(data.to(dev), params, proj_vecs=proj.to(dev), device=dev))
    tr = get_tracer()
    tr.enable()
    before = launches["merge_schedule"]
    col.search(data[:16].to(dev), k=8, steps=6, engine="inline", termination=Termination())
    torch.cuda.synchronize()
    assert launches["merge_schedule"] == before + 1
    merge = next(s for s in tr.events if s.name == "dblsh.merge")
    assert merge.args == {"steps": 6, "syncs": 0, "kernel": 1}


class _CountedRange:
    """Stands in for ``record_function``: counts the ranges opened."""

    opened = 0

    def __init__(self, name):
        type(self).opened += 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_search_off_path_opens_no_range_and_records_nothing(
        setup, col, monkeypatch):
    """Tracer and profiler both off: ``search_batch_fixed`` opens no
    profiler range, records no span and every stage gets the one shared
    no-op handle; with the tracer on and no profiler, still no range."""
    _, queries, _ = setup
    monkeypatch.setattr(obs_trace, "record_function", _CountedRange)
    _CountedRange.opened = 0
    tr = get_tracer()
    assert tr.stage("dblsh.merge") is tr.stage("dblsh.select") is obs_trace._NOP
    search_batch_fixed(col.index, queries[:4], k=8, steps=4, device="cpu")
    assert _CountedRange.opened == 0 and not tr.events
    tr.enable()
    search_batch_fixed(col.index, queries[:4], k=8, steps=4, device="cpu")
    assert _CountedRange.opened == 0
    assert [s.name for s in tr.events] == list(STAGES)


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out = {}
    for ev in prof.profiler.kineto_results.events():
        out.setdefault(ev.name(), []).append(ev.start_ns())
    return out


def test_stage_spans_land_on_the_profilers_clock(setup, col):
    """Under a CPU profiler session each span opens a range of its name,
    and its start, mapped by ``to_trace_ns``, lies within 1 ms of the
    profiler's event; with no session the profiler's next trace holds
    none of them."""
    _, queries, _ = setup
    tr = get_tracer()
    # a first session pays the ranges' one-time set-up, which is not the
    # mapping's error
    _profiled(lambda: col.search(queries[:6], k=8, steps=4, engine="inline"))
    tr.enable()
    events = _profiled(lambda: [col.search(queries[:6], k=8, steps=4,
                                           engine="inline") for _ in range(3)])
    tr.disable()
    spans = [s for s in tr.events if s.name in STAGES + ("store.search",)]
    assert len(spans) == 15
    for name in STAGES + ("store.search",):
        mine = sorted(tr.to_trace_ns(s.ts) for s in spans if s.name == name)
        theirs = sorted(events[name])
        assert len(theirs) == 3
        assert max(abs(a - b) for a, b in zip(mine, theirs)) < 1_000_000
    tr.enable()
    col.search(queries[:6], k=8, steps=4, engine="inline")
    later = _profiled(lambda: None)
    assert not set(later) & set(STAGES + ("store.search",))


def test_lifecycle_mutation_opens_a_profiler_range():
    """``Tracer.span`` carries the lifecycle spans onto a profiler trace:
    an insert under a session shows a ``lifecycle.add`` range, with the
    tracer off as on."""
    data, _, _ = R.resilience_fixture()
    params = DBLSHParams.derive(
        n=120, d=12, c=1.5, w0=3.6, t=12, k=8, inline_vectors=True
    )
    c2 = Collection.create("mut", torch.Generator().manual_seed(5), data[:120],
                           params=params, device="cpu")
    events = _profiled(lambda: c2.add(data[120:124] + 0.5))
    assert len(events["lifecycle.add"]) == 1
    assert not get_tracer().events


# --------------------------------------------------------- explain / exemplars
class TestExplainDevice:
    """Device-side with_explain: the off path must be bit-equal (it is
    the same search), and the per-step arrays must agree with the
    with_stats accounting they refine."""

    @pytest.mark.parametrize("engine", ENGINES)
    def test_explain_off_bit_equal(self, setup, col, engine):
        _, queries, _ = setup
        for term in (None, Termination()):
            kw = dict(k=8, r0=0.5, steps=4, engine=engine, device="cpu",
                      with_stats=True, termination=term)
            d0, i0, s0 = search_batch_fixed(col.index, queries[:8], **kw)
            d1, i1, s1, ex = search_batch_fixed(
                col.index, queries[:8], with_explain=True, **kw
            )
            assert torch.equal(d0, d1) and torch.equal(i0, i1)
            assert torch.equal(s0["radius_steps"], s1["radius_steps"])
            assert torch.equal(s0["candidates"], s1["candidates"])
            # contract: per-step admitted deltas partition the total
            # verified slots, causes are in vocabulary, the halfwidth
            # schedule is the geometric ladder
            slots = ex["step_slots"].numpy()
            np.testing.assert_array_equal(
                slots.sum(axis=1), s0["candidates"].numpy()
            )
            assert set(ex["term_cause"].tolist()) <= {0, 1, 2}
            half = ex["step_half"].numpy()
            assert half.shape == (4,)
            np.testing.assert_allclose(half[1:] / half[:-1], 1.5, rtol=1e-5)


class TestExplainService:
    def test_ticket_contract_and_render(self, setup, col):
        """submit(explain=True): the record's accounting matches the
        ticket's with_stats numbers, the cache read is a bypass, and the
        rendered text names the termination condition."""
        _, queries, _ = setup
        svc = _service(col, FakeClock(), max_wait_ms=1e9)
        t = svc.submit("obscol", queries[0], explain=True)
        plain = [svc.submit("obscol", q) for q in queries[1:4]]
        svc.flush()
        assert t.done and t.error is None
        e = t.explain
        assert e is not None
        assert all(p.explain is None for p in plain)
        # device accounting agrees with the ticket
        assert e.steps_run == t.radius_steps
        assert e.candidates == t.candidates == sum(e.step_slots)
        assert e.cum_slots[-1] == t.candidates
        assert len(e.step_half) == len(e.step_slots) == e.plan_steps == 4
        assert e.term_cause in (
            "schedule_exhausted", "c1_budget", "c2_certified"
        )
        # provenance: no policy anywhere -> the service's own schedule
        assert e.plan_source == "default" and e.plan_policy is None
        assert e.cache_outcome == "bypass" and "obscol@v" in e.cache_key
        assert e.queue_wait_ms >= 0.0 and e.batch_seq >= 0
        text = e.render()
        assert f"uid={t.uid}" in text
        assert "terminated: " + e.term_cause in text
        assert "admitted_slots" in text and "cache: bypass" in text
        json.dumps(e.to_dict())  # artifact shape is JSON-able

    def test_explain_dispatch_bit_equal(self, setup, col):
        """A fully-explained serve returns bit-identical results to a
        plain serve of the same queries."""
        _, queries, _ = setup

        def run(explain):
            svc = _service(col, FakeClock(), cache_size=0,
                           inflight_depth=2)
            d, i, _ = svc.serve("obscol", queries[:6], explain=explain)
            return np.asarray(d), np.asarray(i)

        d0, i0 = run(False)
        d1, i1 = run(True)
        np.testing.assert_array_equal(d0, d1)
        np.testing.assert_array_equal(i0, i1)

    def test_plan_provenance_names_request_rung(self, setup, col):
        from repro_torch.tune import FixedSchedule

        _, queries, _ = setup
        svc = _service(col, FakeClock())
        t = svc.submit("obscol", queries[0], explain=True,
                       policy=FixedSchedule(r0=0.5, steps=2))
        svc.flush()
        assert t.explain.plan_source == "request"
        assert "FixedSchedule" in t.explain.plan_policy
        assert t.explain.plan_steps == 2 and len(t.explain.step_half) == 2

    def test_auto_sampling_stride(self, setup, col):
        _, queries, _ = setup
        obs = Observability(explain_sample_rate=0.5)  # stride 2
        svc = _service(col, FakeClock(), obs=obs, cache_size=0)
        tickets = [svc.submit("obscol", queries[i % 8]) for i in range(4)]
        svc.flush()
        flags = [t.explain is not None for t in tickets]
        assert flags == [True, False, True, False]
        # explicit flags override the sampler in both directions
        assert svc.submit("obscol", queries[0], explain=True).explain
        assert svc.submit("obscol", queries[0], explain=False).explain is None
        # default bundle: sampling off, nothing explained implicitly
        svc2 = _service(col, FakeClock(), cache_size=0)
        t2 = svc2.submit("obscol", queries[0])
        svc2.flush()
        assert t2.explain is None

    def test_tenant_degraded_and_deadline_counters(self, setup, col):
        """Per-tenant degraded / deadline_exceeded surfaced from labeled
        registry series."""
        _, queries, _ = setup
        clk = FakeClock()
        svc = _service(col, clk, max_wait_ms=0.0, inflight_depth=2)
        # served past its budget: issued at t=0, completed 10ms later
        t1 = svc.submit("obscol", queries[0], deadline_ms=5.0, tenant="acme")
        svc.step()
        clk.advance(0.010)
        svc.flush()
        assert t1.done and t1.error is None and t1.degraded
        # expired while queued: typed deadline failure
        t2 = svc.submit("obscol", queries[1], deadline_ms=5.0, tenant="acme")
        clk.advance(0.010)
        svc.step()
        assert isinstance(t2.error, DeadlineExceeded) and t2.done
        ts = svc.tenant_stats("acme")
        assert ts["degraded"] == 1
        assert ts["deadline_exceeded"] == 1
        assert ts["failed"] == 1
        assert ts["served"] == 1

    def test_breach_event_carries_rendered_exemplar(self, setup, col):
        """A scripted p99 breach names actual queries — the worst
        exemplar's rendered explain includes the termination condition
        and per-step admitted slots."""
        _, queries, _ = setup
        clk = FakeClock()
        svc = _service(col, clk, max_wait_ms=1e9)
        t = svc.submit("obscol", queries[0], explain=True)
        clk.advance(0.050)  # 50 ms in queue: the latency tail
        svc.flush()
        assert t.done and t.explain is not None
        watch = svc.obs.watch(
            "obscol", latency_p99_ms=1.0, min_samples=1, clock=clk,
        )
        events = watch.check(clk.now)
        assert events and events[0].kind in ("latency_p50", "latency_p99")
        exs = events[0].detail["exemplars"]
        assert exs, "breach carried no exemplars"
        best = exs[0]
        assert best["uid"] == t.uid
        assert best["explain"]["term_cause"] == t.explain.term_cause
        assert "terminated: " + t.explain.term_cause in best["rendered"]
        assert "admitted_slots" in best["rendered"]
        # the event (exemplars included) survives JSON export
        json.dumps(events[0].to_dict())
