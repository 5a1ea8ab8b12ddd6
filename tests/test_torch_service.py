"""The port's ``StoreService`` held to tests/test_store_scheduler.py and
to the reference's own service.

Case for case, on the port (the twins run the kernel engines here):

* **Equivalence** — the overlapped ring (timeout drains on a fake clock)
  == the synchronous path == one direct ``search_batch_fixed`` call,
  bit for bit, at every batch shape, partial fills and the forced-timeout
  drain included, on every engine;
* **Cache freshness (property)** — interleaved add / remove / compact /
  snapshot-restore / query scripts never serve a stale hit (hypothesis,
  the reference's example count), and a restored collection never
  aliases the live one's entries;
* **Recall band** — the reference's seeded (c, t) configs and floors,
  on the reference's indexes carried across (``from_arrays``);
* **Fake-clock units** — token-bucket refill, weighted round-robin,
  deterministic latency stats, the real-row query counter, tickets that
  cannot corrupt the cache, versionless attachables never cached, and
  ``serve`` withdrawing on rejection.

``test_datastore_search_uses_cache`` waits for the port of
``serve/retrieval.py`` (ROADMAP A17).

**Parity with the reference**: one reference ``StoreService`` and one
port ``StoreService`` over the same index (the reference's arrays
carried across), each on its own fake clock advanced identically, take
the same submit/step/flush script with two tenants, quotas and the
cache: the same admissions and rejections, the same uids in every
batch (WRR order and shapes), equal id sets per ticket, distances
within the norm form's tolerance (rtol = atol = 1e-2, as
tests/test_onepass_search.py holds the reference's own engines), equal
per-ticket stats, and ``stats()``, ``tenant_stats()`` and
``cache_stats()`` equal field by field.

**No wait at issue**: on the CPU, a dispatch mode records the ops of a
fixed-schedule search that would make the host wait for the card (a
read of a value, a pageable copy to the device, a ``where`` handed a
host-made 0-dim tensor) — none; on the card (marked ``cuda``), the issue
stage runs under ``torch.cuda.set_sync_debug_mode("error")``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
R = pytest.importorskip("_torch_parity")

import repro_torch.store as port_store  # noqa: E402
from _hypothesis_compat import given, settings, st  # noqa: E402
from repro_torch.core import (  # noqa: E402
    DBLSHParams,
    Termination,
    brute_force,
    from_arrays,
    search_batch_fixed,
)
from repro_torch.store import (  # noqa: E402
    Collection,
    CompactionPolicy,
    QueryResultCache,
    QuotaExceeded,
    StoreService,
)

CPU = "cpu"
ENGINES = ("torch", "kernel", "inline")
REF_ENGINE = {"torch": "jnp", "kernel": "kernel", "inline": "inline"}
DERIVE = dict(n=400, d=16, c=1.5, w0=3.6, t=16, k=10, inline_vectors=True)
NORM_TOL = 1e-2  # the norm form's rtol = atol between the frameworks


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
    return R.scheduler_fixture()


def _gen(seed: int = 23) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _port_collection(name, arrays, params):
    return Collection.from_index(name, from_arrays(arrays, params, device=CPU))


@pytest.fixture(scope="module")
def ref_col(setup):
    """The reference's read-only collection of the equivalence and
    fake-clock suites (inline layout so every engine can verify it)."""
    data, _, kb = setup
    return R.ref_collection_arrays("sched", kb, data,
                                   params=R.DBLSHParams.derive(**DERIVE))


@pytest.fixture(scope="module")
def col(ref_col):
    """The same index in the port."""
    return _port_collection("sched", *ref_col[1:])


def _service(col, *, engine="torch", depth=2, cache_size=0, clock=None, **kw):
    kw.setdefault("batch_shapes", (1, 4, 8))
    kw.setdefault("max_wait_ms", 1e9)
    svc = StoreService(
        default_k=10, r0=0.5, steps=6, engine=engine,
        inflight_depth=depth, cache_size=cache_size,
        **({"clock": clock} if clock is not None else {}),
        **kw,
    )
    svc.attach(col)
    return svc


def _results(reqs):
    return np.stack([r.dists for r in reqs]), np.stack([r.ids for r in reqs])


def _direct(index, Q, **kw):
    d, i = search_batch_fixed(index, Q, device=CPU, **kw)
    return d.numpy(), i.numpy()


# ---------------------------------------------------------------------------
# Equivalence: overlapped async == synchronous == direct, per batch shape
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ENGINES)
def test_async_matches_sync_all_shapes(setup, col, engine):
    """Every batch shape in the menu (exact fill and partial fill): the
    overlapped path (in-flight ring, drained by fake-clock timeouts so
    every chunk dispatches at its own shape without a forced sync) and
    the synchronous path return bit-identical results, equal to one
    direct search_batch_fixed call."""
    data, queries, _ = setup
    # chunk sizes 1, 4, 8 (exact fill per shape), then 3 -> 4 and
    # 6 -> 8 (the partial-fill padded-drain paths)
    cuts = [1, 5, 13, 16, 22]

    def run(depth, force):
        clock = FakeClock()
        svc = _service(
            col, engine=engine, depth=depth, clock=clock, max_wait_ms=5.0
        )
        reqs, start, held = [], 0, []
        for cut in cuts:
            for q in queries[start:cut]:
                reqs.append(svc.submit("sched", q))
            if force:
                svc.step(force=True)  # drain + complete: fully synchronous
            else:
                clock.advance(0.006)  # > max_wait_ms: timeout drain
                svc.step()            # issue only; ring stays in flight
            held.append(svc.in_flight())
            start = cut
        svc.flush()
        assert all(r.done for r in reqs)
        stats = svc.stats("sched")
        assert stats["batches"] == len(cuts)  # one batch per chunk shape
        assert stats["queries"] == len(queries)
        return (*_results(reqs), stats, held)

    d_sync, i_sync, stats_sync, held_sync = run(depth=0, force=True)
    d_async, i_async, stats_async, held_async = run(depth=3, force=False)
    assert stats_sync["overlap_ratio"] == 0.0 and not any(held_sync)
    # the ring actually held every batch past its step; on the CPU the
    # search is done when col.search returns, so the next step's poll
    # retires it before the next issue and no issue overlaps (the card's
    # overlap: test_issue_never_waits_for_the_card, chip_smoke.py phase 14)
    assert held_async == [cut - prev for cut, prev in zip(cuts, [0] + cuts)]
    # the same search on the same padded batches both ways -> bitwise identical
    np.testing.assert_array_equal(i_async, i_sync)
    np.testing.assert_array_equal(d_async, d_sync)

    d_direct, i_direct = _direct(col.index, queries, k=10, r0=0.5, steps=6,
                                 engine=engine)
    np.testing.assert_array_equal(i_sync, i_direct)
    np.testing.assert_array_equal(d_sync, d_direct)


@pytest.mark.parametrize("engine", ENGINES)
def test_timeout_drain_matches_direct(setup, col, engine):
    """The forced-timeout partial drain (queue smaller than every batch
    shape when the clock runs out) pads and returns the same results as
    a direct call — and only fires once the fake clock actually passes
    ``max_wait_ms``."""
    data, queries, _ = setup
    clock = FakeClock()
    svc = _service(col, engine=engine, depth=2, clock=clock, max_wait_ms=5.0)
    reqs = [svc.submit("sched", q) for q in queries[:3]]  # < smallest useful fill
    assert svc.step() == 0  # not full, not timed out -> nothing drains
    clock.advance(0.006)  # 6 ms > max_wait_ms
    assert svc.step() == 3  # timeout drain: 3 real rows padded to shape 4
    svc.flush()
    assert all(r.done for r in reqs)
    d, i = _results(reqs)
    d_direct, i_direct = _direct(col.index, queries[:3], k=10, r0=0.5, steps=6,
                                 engine=engine)
    np.testing.assert_array_equal(i, i_direct)
    np.testing.assert_array_equal(d, d_direct)
    stats = svc.stats("sched")
    assert stats["batches"] == 1 and stats["queries"] == 3


# ---------------------------------------------------------------------------
# Cache freshness under interleaved updates (property test)
# ---------------------------------------------------------------------------

# Op scripts, as the reference's: 'q' serves a batch through the scheduler
# and checks it against a fresh search; 'Q' re-serves the same batch
# (cache-hit path); 'a' adds 16 points; 'r' tombstones 16; 'c' compacts;
# 's' snapshot+restore (fresh version, same state).
_SCRIPTS = [
    "qQaqQrqQcqQ",
    "aqQcqQrqQsqQ",
    "qQrqQaqQsqQcqQ",
    "sqQaqQaqQcqQ",
    "qQaqrQqcqsQq",
    "rqQcqQaqQQ",
]


@pytest.fixture(scope="module")
def prop_points():
    return R.scheduler_property_points()


@given(script_i=st.integers(min_value=0, max_value=len(_SCRIPTS) - 1),
       seed=st.integers(min_value=0, max_value=2**31 - 1))
@settings(max_examples=6, deadline=None)
def test_cache_never_stale_under_updates(tmp_path_factory, prop_points, script_i, seed):
    """Interleaved add/remove/compact/snapshot-restore/query sequences:
    every result the scheduler serves (cached or dispatched) is bit-equal
    to a fresh fixed-schedule search at the collection's *current*
    version — version invalidation can never serve yesterday's index."""
    rng = np.random.default_rng(seed)
    pts = prop_points
    base, pool = pts[:120], pts[120:]
    params = DBLSHParams.derive(
        n=120, d=8, c=1.5, w0=3.6, t=8, k=5, block_size=16
    )
    col = Collection.create(
        "prop", _gen(7), base, params=params, policy=CompactionPolicy(auto=False),
        device=CPU,
    )
    svc = StoreService(
        batch_shapes=(4,), max_wait_ms=1e9, default_k=5, r0=0.5, steps=4,
        inflight_depth=2, cache_size=256,
    )
    svc.attach(col)

    def check_batch(Q):
        reqs = [svc.submit("prop", q) for q in Q]
        svc.flush()
        got_d, got_i = _results(reqs)
        want_d, want_i = _direct(col.index, Q, k=5, r0=0.5, steps=4)
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_array_equal(got_d, want_d)
        return reqs

    last_Q = pts[rng.integers(0, len(pts), 4)]
    added = 0
    for op in _SCRIPTS[script_i]:
        if op == "q":
            last_Q = pts[rng.integers(0, len(pts), 4)]
            check_batch(last_Q)
        elif op == "Q":
            reqs = check_batch(last_Q)  # repeat: exercises the hit path
            assert all(r.done for r in reqs)
        elif op == "a" and added + 16 <= len(pool):
            col.add(pool[added:added + 16])
            added += 16
        elif op == "r":
            live = col.live_count()
            ids = rng.integers(0, col.n, min(16, max(1, live // 4)))
            col.remove(np.unique(ids))
        elif op == "c":
            col.compact()
        elif op == "s":
            d = tmp_path_factory.mktemp("prop_ckpt")
            step = col.snapshot(str(d))
            restored = Collection.restore(str(d), step, device=CPU)
            assert restored.version > col.version  # fresh, never aliased
            col = restored
            svc.collections["prop"] = col
    # the cache did real work across the script
    assert svc.cache.hits > 0


def test_restored_collection_does_not_alias_cache(setup, tmp_path):
    """Divergent histories from one snapshot must not share cache entries:
    a restored collection under the same name in a service whose cache
    holds entries for the live collection recomputes rather than hits."""
    data, queries, _ = setup
    col = Collection.create(
        "alias", _gen(), data[:200], c=1.5, w0=3.6, t=8, k=5,
        policy=CompactionPolicy(auto=False), device=CPU,
    )
    cache = QueryResultCache(128)
    svc = StoreService(
        batch_shapes=(4,), max_wait_ms=1e9, default_k=5, r0=0.5, steps=4,
        cache=cache,
    )
    svc.attach(col)
    step = col.snapshot(str(tmp_path))
    Q = queries[:4]
    _ = [svc.submit("alias", q) for q in Q]
    svc.flush()
    hits0 = cache.hits
    # diverge the live collection, then restore the snapshot over it
    col.add(data[200:216])
    restored = Collection.restore(str(tmp_path), step, device=CPU)
    svc.collections["alias"] = restored
    reqs = [svc.submit("alias", q) for q in Q]
    svc.flush()
    assert cache.hits == hits0  # no hit against either old version
    want_d, want_i = _direct(restored.index, Q, k=5, r0=0.5, steps=4)
    got_d, got_i = _results(reqs)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_d, want_d)


# ---------------------------------------------------------------------------
# Recall regression band
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "c,t,floor",
    [
        # the reference's floors, ~0.04 under its seeded measurement
        # (0.841 / 0.973), on its own indexes carried across
        (1.5, 32, 0.80),
        (2.0, 16, 0.90),
    ],
)
def test_recall_band_through_scheduler(setup, c, t, floor):
    """Seeded (c, t, k) configs: recall@10 vs brute force through the
    overlapped scheduler stays above a pinned floor — scheduler changes
    cannot silently trade accuracy for throughput."""
    data, queries, _ = setup
    k = 10
    _, arrays, params = R.ref_collection_arrays(
        f"rec{c}{t}", R.key(42), data, c=c, w0=3.6, t=t, k=k)
    colr = _port_collection(f"rec{c}{t}", arrays, params)
    svc = _service(colr, depth=2, cache_size=64)
    dists, ids, _ = svc.serve(colr.name, queries, k=k)
    _, gt_i = brute_force(data, queries, k=k, device=CPU)
    gt_i = gt_i.numpy()
    recall = np.mean(
        [len(set(a.tolist()) & set(b.tolist())) / k for a, b in zip(ids, gt_i)]
    )
    assert recall >= floor, (c, t, recall)


# ---------------------------------------------------------------------------
# Fake-clock units: quotas, WRR, timeout, deterministic stats
# ---------------------------------------------------------------------------


def test_token_bucket_refill(col):
    clock = FakeClock()
    svc = _service(col, clock=clock)
    q = np.zeros(16, np.float32)
    svc.set_quota("t1", rate=1.0, burst=2)
    svc.submit("sched", q, tenant="t1")
    svc.submit("sched", q, tenant="t1")
    with pytest.raises(QuotaExceeded):
        svc.submit("sched", q, tenant="t1")  # bucket empty
    clock.advance(0.4)
    with pytest.raises(QuotaExceeded):
        svc.submit("sched", q, tenant="t1")  # only 0.4 tokens back
    clock.advance(0.6)
    svc.submit("sched", q, tenant="t1")  # refilled to exactly 1
    clock.advance(10.0)
    svc.submit("sched", q, tenant="t1")
    svc.submit("sched", q, tenant="t1")
    with pytest.raises(QuotaExceeded):
        svc.submit("sched", q, tenant="t1")  # burst caps the refill at 2
    ts = svc.tenant_stats("t1")
    assert ts["submitted"] == 5 and ts["rejected"] == 3
    svc.flush()
    assert svc.tenant_stats("t1")["served"] == 5


def test_weighted_round_robin_drain(col):
    """A hot tenant cannot take the whole batch: draining interleaves
    tenants by quota weight."""
    clock = FakeClock()
    svc = _service(col, clock=clock, batch_shapes=(8,))
    svc.set_quota("heavy", weight=3)
    svc.set_quota("light", weight=1)
    q = np.zeros(16, np.float32)
    for _ in range(12):
        svc.submit("sched", q, tenant="heavy")
    for _ in range(4):
        svc.submit("sched", q, tenant="light")
    drained = svc._drain_wrr("sched", 8)
    tenants = [r.tenant for r in drained]
    # 3:1 interleave, light is never starved out of the batch
    assert tenants.count("heavy") == 6 and tenants.count("light") == 2
    # second batch keeps alternating shares
    drained2 = svc._drain_wrr("sched", 8)
    assert [r.tenant for r in drained2].count("light") == 2
    svc.flush()


def test_timeout_and_latency_stats_deterministic(col):
    """Injected clock makes the latency percentiles and QPS exact."""
    clock = FakeClock(start=100.0)
    svc = _service(col, clock=clock, max_wait_ms=50.0, batch_shapes=(4,))
    reqs = []
    for _ in range(4):
        reqs.append(svc.submit("sched", np.zeros(16, np.float32)))
        clock.advance(0.010)
    # queue full at 4 -> drains on the next step regardless of timeout
    svc.step()
    svc.flush()
    # submit times were 100.000..100.030, completion at 100.040
    lat = sorted(r.latency_ms for r in reqs)
    np.testing.assert_allclose(lat, [10.0, 20.0, 30.0, 40.0], rtol=1e-9)
    stats = svc.stats("sched")
    want = np.percentile([40.0, 30.0, 20.0, 10.0], [50, 99])
    np.testing.assert_allclose(
        [stats["latency_ms_p50"], stats["latency_ms_p99"]], want, rtol=1e-9
    )
    # QPS span: first submit (100.000) -> completion (100.040)
    np.testing.assert_allclose(stats["qps"], 4 / 0.040, rtol=1e-9)


def test_query_counter_counts_real_rows(setup):
    """The padded dispatch counts only real rows on the collection and the
    counter can never underflow, and detaching with work in flight is
    refused."""
    data, _, _ = setup
    colq = Collection.create("rows", _gen(), data[:200], c=1.5, w0=3.6, t=8, k=5,
                             device=CPU)
    svc = StoreService(
        batch_shapes=(8,), max_wait_ms=0.0, default_k=5, r0=0.5, steps=4,
        inflight_depth=2, cache_size=0,
    )
    svc.attach(colq)
    for q in data[:3]:
        svc.submit("rows", q)
    svc.step(force=True)  # issues 3 real rows padded to 8 and completes
    assert colq.stats.queries == 3  # not 8, never negative
    # detaching with work in flight is refused instead of corrupting stats
    svc.submit("rows", data[4])
    svc.step()  # issue without completing (depth 2 ring holds it)
    assert svc.in_flight() == 1
    with pytest.raises(RuntimeError):
        svc.drop_collection("rows")
    svc.flush()
    assert colq.stats.queries == 4
    svc.drop_collection("rows")


def test_cache_isolated_from_ticket_mutation(setup):
    """Callers own their tickets: mutating a returned result in place must
    not corrupt the cached row (entries are copied on put and on hit)."""
    data, queries, _ = setup
    colm = Collection.create("mut", _gen(), data[:200], c=1.5, w0=3.6, t=8, k=5,
                             device=CPU)
    svc = StoreService(
        batch_shapes=(1,), max_wait_ms=1e9, default_k=5, r0=0.5, steps=4,
        cache_size=64,
    )
    svc.attach(colm)
    r0_ = svc.submit("mut", queries[0])
    svc.flush()
    want_d, want_i = r0_.dists.copy(), r0_.ids.copy()
    # miss-path tickets are read-only views of their batch's arrays — a
    # client scribble cannot even start there
    with pytest.raises(ValueError):
        r0_.dists[:] = -1.0
    r1 = svc.submit("mut", queries[0])
    svc.flush()
    assert r1.cached
    np.testing.assert_array_equal(r1.dists, want_d)
    np.testing.assert_array_equal(r1.ids, want_i)
    r1.dists[:] = -2.0  # hit-path tickets are writable copies: scribble
    r1.ids[:] = 7
    r2 = svc.submit("mut", queries[0])
    svc.flush()
    assert r2.cached
    np.testing.assert_array_equal(r2.dists, want_d)
    np.testing.assert_array_equal(r2.ids, want_i)


def test_versionless_collection_is_never_cached(setup):
    """An attached object without a ``version`` attribute has no
    invalidation signal, so the service must bypass the cache for it
    rather than serve version-frozen results forever."""
    data, queries, _ = setup
    inner = Collection.create("nv", _gen(), data[:200], c=1.5, w0=3.6, t=8, k=5,
                              device=CPU)

    class VersionlessView:  # search + name only
        name = "nv"
        payload = None

        def search(self, *a, **kw):
            return inner.search(*a, **kw)

    svc = StoreService(
        batch_shapes=(1,), max_wait_ms=1e9, default_k=5, r0=0.5, steps=4,
        cache_size=64,
    )
    svc.attach(VersionlessView())
    for _ in range(2):  # identical repeat: would hit if it were cached
        r = svc.submit("nv", queries[0])
        svc.flush()
        assert r.done and not r.cached
    assert svc.cache.hits == 0 and len(svc.cache) == 0


def test_serve_withdraws_queue_on_quota_rejection(col):
    """serve() is all-or-nothing under quota: a mid-matrix rejection
    leaves no orphaned tickets behind in the queue."""
    clock = FakeClock()
    svc = _service(col, clock=clock)
    svc.set_quota("t", rate=1.0, burst=2)
    Q = np.zeros((5, 16), np.float32)
    with pytest.raises(QuotaExceeded):
        svc.serve("sched", Q, tenant="t")
    assert svc.pending() == 0 and svc.in_flight() == 0
    assert svc.tenant_stats("t")["submitted"] == 0
    assert svc.tenant_stats("t")["rejected"] == 1


def test_payload_rows_ride_with_tickets(setup):
    """A collection with a payload: every ticket (dispatched or cached)
    carries its ids' payload rows, equal to ``get_payload``."""
    data, queries, _ = setup
    colp = Collection.create("pay", _gen(), data[:200], c=1.5, w0=3.6, t=8, k=5,
                             payload=np.arange(200) * 3, device=CPU)
    svc = StoreService(batch_shapes=(1, 4), max_wait_ms=1e9, default_k=5, r0=0.5,
                       steps=4, cache_size=64)
    svc.attach(colp)
    for expect_cached in (False, True):
        _, _, reqs = svc.serve("pay", queries[:3])
        for r in reqs:
            assert r.cached == expect_cached and r.payload.shape == (5,)
            np.testing.assert_array_equal(
                r.payload, colp.get_payload(r.ids).numpy())


# ---------------------------------------------------------------------------
# Parity with the reference's service
# ---------------------------------------------------------------------------

# (tenant, query row) per submit; the two tenants' quotas reject some of
# them, and the script's second half repeats rows for cache hits
_TENANT_SCRIPT = [("gold" if j % 3 else "bronze", j % 22) for j in range(30)]


def _drive(store, svc, clock, queries, force: bool):
    """The parity script on one package's service: returns the outcome of
    every submit (ticket or None when rejected) and the uids and shape of
    every issued batch."""
    batches = []
    issue = svc._issue

    def logged(name, reqs, *a, **kw):
        batches.append(([r.uid for r in reqs], svc._shape_for(len(reqs))))
        return issue(name, reqs, *a, **kw)

    svc._issue = logged
    svc.set_quota("gold", rate=200.0, burst=6, weight=3)
    svc.set_quota("bronze", rate=50.0, burst=2, weight=1)
    outcomes = []
    for j, (tenant, row) in enumerate(_TENANT_SCRIPT):
        try:
            outcomes.append(svc.submit("sched", queries[row], tenant=tenant))
        except store.QuotaExceeded:
            outcomes.append(None)
        clock.advance(0.002)
        if j % 4 == 3:
            svc.step(force=force)
        if j == 14:
            clock.advance(0.05)
            svc.flush()
    clock.advance(0.01)
    svc.flush()
    return outcomes, batches


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("engine", ENGINES)
def test_service_matches_reference(setup, ref_col, col, engine, depth):
    """The same script through both packages' services: the same batches,
    admissions, id sets, per-ticket stats and service-level snapshots.
    Depth 2 steps with ``force`` (the reference's ring retires a batch at
    whatever poll finds its futures ready, which a fake clock cannot
    fix); depth 0 takes the timeout and fill drains of a plain step."""
    _, queries, _ = setup
    ref_store = R.ref_modules().store
    runs = {}
    for side, store, c, eng, extra in (
        ("ref", ref_store, ref_col[0], REF_ENGINE[engine],
         {"interpret": True} if engine != "torch" else {}),
        ("port", port_store, col, engine, {}),
    ):
        clock = FakeClock(start=10.0)
        svc = store.StoreService(
            batch_shapes=(1, 4, 8), max_wait_ms=5.0, default_k=10, r0=0.5, steps=6,
            engine=eng, inflight_depth=depth, cache_size=64, clock=clock, **extra)
        svc.attach(c)
        runs[side] = (svc, *_drive(store, svc, clock, queries, force=depth > 0))

    (rsvc, r_out, r_batches), (psvc, p_out, p_batches) = runs["ref"], runs["port"]
    assert p_batches == r_batches and len(p_batches) >= 4
    assert [t is None for t in p_out] == [t is None for t in r_out]
    assert any(t is None for t in p_out) and any(t is not None and t.cached for t in p_out)
    for pt, rt in zip(p_out, r_out):
        if pt is None:
            continue
        assert (pt.uid, pt.tenant, pt.cached, pt.done) == (rt.uid, rt.tenant, rt.cached, rt.done)
        fin = np.isfinite(rt.dists)
        assert set(pt.ids[np.isfinite(pt.dists)].tolist()) == set(rt.ids[fin].tolist())
        np.testing.assert_allclose(pt.dists, rt.dists, rtol=NORM_TOL, atol=NORM_TOL)
        assert (pt.radius_steps, pt.candidates, pt.latency_ms) == \
            (rt.radius_steps, rt.candidates, rt.latency_ms)
    assert psvc.stats() == rsvc.stats()
    assert psvc.tenant_stats() == rsvc.tenant_stats()
    assert psvc.cache_stats() == rsvc.cache_stats()


_HostWaits = R.HostWaits


@pytest.mark.parametrize("engine", ENGINES)
def test_fixed_schedule_search_never_waits(setup, col, engine):
    """What the issue stage runs — ``Collection.search`` of a fixed
    schedule, plain or C2-only without early exit — reads nothing back
    from the tensors it computes and copies nothing to the device from
    pageable memory, so on the card it returns before the card is done.
    ``Termination(early_exit=True)`` reads the done mask once a step: the
    one documented wait, seen by the same detector."""
    _, queries, _ = setup
    Q = torch.from_numpy(np.ascontiguousarray(queries[:8]))
    for term in (None, Termination(use_c1=False, early_exit=False)):
        with _HostWaits() as mode:
            col.search(Q, k=10, r0=0.5, steps=6, engine=engine, with_stats=True,
                       termination=term)
        assert mode.found == [], (term, mode.found)
    with _HostWaits() as mode:
        col.search(Q, k=10, r0=0.5, steps=6, engine=engine, termination=Termination())
    assert "aten._local_scalar_dense.default" in mode.found


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ENGINES)
def test_issue_never_waits_for_the_card(setup, ref_col, engine):
    """On the card, issuing a fixed-schedule batch makes no host sync:
    ``_issue`` runs under ``set_sync_debug_mode("error")``, at depth 2,
    and the results still equal the synchronous path's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sync check reads the CUDA stream")
    _, queries, _ = setup
    colc = Collection.from_index("sched", from_arrays(*ref_col[1:], device="cuda"))
    runs = []
    for depth in (0, 2):
        svc = StoreService(batch_shapes=(1, 4, 8), default_k=10, r0=0.5, steps=6,
                           engine=engine, inflight_depth=depth, cache_size=0)
        svc.attach(colc)
        issue, complete = svc._issue, svc._complete

        def strict(*a, **kw):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return issue(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)

        def lax(batch):  # a ring overflow completes inside issue: it may wait
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            try:
                return complete(batch)
            finally:
                torch.cuda.set_sync_debug_mode(mode)

        svc._issue, svc._complete = strict, lax
        d, i, tickets = svc.serve("sched", queries)
        assert all(t.error is None for t in tickets), tickets[0].error
        runs.append((d, i))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
