"""The port's copy of ``obs`` held to tests/test_obs.py.

Its classes that need no service, on the port's package: ``TestTracer``,
``TestMetrics``, ``TestExports``, ``TestSLOWatch`` without its service
case, ``TestExemplarReservoir`` and ``TestPrometheusHardening``
(tests/test_obs.py:103-312, :470-579, :744-798), each case as the
reference has it; and the lifecycle spans of :407 on the port's
``Collection``.  The service cases (``TestServiceIntegration``,
``test_obs_on_off_bit_equal``, ``TestExplainService``,
``test_service_drives_slo_from_step``) wait for the port of
``store/service.py``.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
R = pytest.importorskip("_torch_parity")

from repro_torch.core import DBLSHParams  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    BreachEvent,
    ExemplarReservoir,
    MetricsRegistry,
    QueryExplain,
    SLOWatch,
    Tracer,
    expected_step_pmf,
    get_tracer,
)
from repro_torch.obs.trace import TID_LIFECYCLE, TID_RING0  # noqa: E402
from repro_torch.store import Collection  # noqa: E402
from repro_torch.tune import ScheduleTable  # noqa: E402


class FakeClock:
    """Injectable monotonic clock: time only moves when told to."""

    def __init__(self, start: float = 0.0):
        self.now = start

    def __call__(self) -> float:
        return self.now

    def advance(self, seconds: float) -> float:
        self.now += seconds
        return self.now


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
        assert b1["ts"] == pytest.approx(0.0)
        assert e1["ts"] == pytest.approx(2.0 * 1e6)  # µs
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
