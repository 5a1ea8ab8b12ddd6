"""The port's fault plans and checkpointer, held to tests/test_resilience.py.

* **FaultPlan units** — tests/test_resilience.py:132's cases on the
  port's copy of ``resilience.faults``;
* **Checkpointer integrity** — :207's cases (crc32 verify-on-restore,
  fallback to the newest verified step, garbled manifests, stranded
  ``LATEST``, GC skipping a step mid-restore, tmp salvage and torn-tmp GC,
  ``save_async`` errors at ``wait()``, v1 manifests), plus the port's
  key-path manifests;
* **Crash consistency** — the local property of :375: whatever site the
  writer dies at, ``restore_collection`` lands on a committed snapshot
  whose searches are bit-equal to one the writer reached;
* **Across the packages** — a checkpoint written by the reference's
  ``Checkpointer`` restores in the port from its key names; the port's
  manifests carry no JAX ``treedef``, so the reference cannot read them
  (the one-way limit, pinned).

* **The service** — :449-682's ``TestDeadlines``, ``TestDispatchFailure``,
  ``TestBrownout`` and the service half of ``TestStragglers`` on the
  port's ``StoreService`` over the reference fixture's index carried
  across (``from_arrays``), every engine where the reference
  parametrizes; the sharded straggler case waits for the port of
  ``store/router.py`` (ROADMAP A15).
"""

import json
import math
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
R = pytest.importorskip("_torch_parity")

from _hypothesis_compat import given, settings, st  # noqa: E402
from repro_torch.checkpoint import Checkpointer, CorruptSnapshot  # noqa: E402
from repro_torch.core import DBLSHParams, from_arrays  # noqa: E402
from repro_torch.obs import MetricsRegistry, SLOWatch  # noqa: E402
from repro_torch.resilience import (  # noqa: E402
    SNAPSHOT_CRASH_STAGES,
    BrownoutController,
    FaultPlan,
    SimulatedCrash,
    StragglerMonitor,
    faults,
)
from repro_torch.store import (  # noqa: E402
    BrownoutShed,
    Collection,
    DeadlineExceeded,
    DispatchFailed,
    StoreService,
    restore_collection,
)
from repro_torch.tune.planner import ScheduleTable  # noqa: E402

CPU = "cpu"
ENGINES = ("torch", "kernel", "inline")


@pytest.fixture(scope="module")
def setup():
    return R.resilience_fixture()[:2]


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    """Every test starts and ends with no installed fault plan."""
    faults.uninstall()
    yield
    faults.uninstall()


# ---------------------------------------------------------------------------
# FaultPlan units
# ---------------------------------------------------------------------------


class TestFaultPlan:
    def test_noop_without_install(self):
        assert faults.fire("dispatch.raise") is None
        assert faults.fire("snapshot.write.torn", file="arr_0.npy") is None

    def test_at_count_window(self):
        plan = FaultPlan().add("dispatch.raise", at=2, count=2)
        with faults.active(plan):
            faults.fire("dispatch.raise")  # hit 0: before window
            faults.fire("dispatch.raise")  # hit 1
            for _ in range(2):             # hits 2, 3: inside
                with pytest.raises(faults.FaultError):
                    faults.fire("dispatch.raise")
            faults.fire("dispatch.raise")  # hit 4: past window
        assert len(plan.fired) == 2

    def test_ctx_match_filters_hits(self):
        plan = FaultPlan().add(
            "snapshot.write.torn", arg=7, file="arr_1.npy", count=math.inf
        )
        with faults.active(plan):
            assert faults.fire("snapshot.write.torn", file="arr_0.npy") is None
            assert faults.fire("snapshot.write.torn", file="arr_1.npy") == 7
        # non-matching hits never consumed the window
        assert [c["file"] for _, c in plan.fired] == ["arr_1.npy"]

    def test_transient_flag_travels(self):
        plan = FaultPlan().add("dispatch.raise", transient=False)
        with faults.active(plan), pytest.raises(faults.FaultError) as ei:
            faults.fire("dispatch.raise")
        assert ei.value.transient is False
        assert isinstance(SimulatedCrash("x"), faults.FaultError)
        assert SimulatedCrash("x").transient is False

    def test_delay_site_uses_injected_sleep_and_scale(self):
        slept = []
        plan = FaultPlan(sleep=slept.append).add(
            "dispatch.delay_ms", arg=20.0, count=math.inf
        )
        with faults.active(plan):
            assert faults.fire("dispatch.delay_ms", scale=3) == 60.0
        assert slept == [0.06]

    def test_active_nesting_restores_previous(self):
        outer, inner = FaultPlan(), FaultPlan()
        with faults.active(outer):
            with faults.active(inner):
                assert faults._ACTIVE is inner
            assert faults._ACTIVE is outer
        assert faults._ACTIVE is None

    def test_reset_rewinds_counters(self):
        plan = FaultPlan().add("dispatch.raise")
        with faults.active(plan):
            with pytest.raises(faults.FaultError):
                faults.fire("dispatch.raise")
            faults.fire("dispatch.raise")  # window spent
            plan.reset()
            with pytest.raises(faults.FaultError):
                faults.fire("dispatch.raise")

    def test_stragglers_and_brownout_copies_load(self):
        """The jax-free copies ride along: the EWMA monitor flags a step
        past 2x its baseline, and the brownout ladder starts healthy."""
        mon = StragglerMonitor(threshold=2.0, warmup=2)
        assert [mon.record(i, t) for i, t in enumerate((1.0, 1.0, 1.0, 5.0))] == [
            False, False, False, True]
        assert mon.flagged == [(3, 5.0)]
        svc = types.SimpleNamespace(registry=MetricsRegistry(), brownout=None)
        ctl = BrownoutController(svc)
        assert ctl.level == 0 and svc.brownout is ctl
        assert svc.registry.gauge("repro_store_brownout_level").value() == 0


# ---------------------------------------------------------------------------
# Checkpointer integrity + recovery
# ---------------------------------------------------------------------------


def _tree(seed: int):
    rng = np.random.default_rng(seed)
    return {
        "a": rng.standard_normal(32).astype(np.float32),
        "b": rng.integers(0, 100, (4, 4)),
    }


class TestCheckpointerIntegrity:
    def test_crc_roundtrip_and_manifest_v2(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        ck.save(1, _tree(1), meta={"k": 1})
        manifest = ck._load_manifest(1)
        assert manifest["manifest_version"] == 2
        assert all("crc32" in spec for spec in manifest["leaves"])
        assert manifest["keys"] == [["a"], ["b"]]
        tree, meta = ck.restore()
        np.testing.assert_array_equal(tree["a"], _tree(1)["a"])
        assert meta == {"k": 1}

    def test_nested_tree_and_tensor_leaves(self, tmp_path):
        """Nested dicts flatten depth first in sorted-key order (JAX's
        order for dicts); tensor leaves are saved as their host arrays."""
        ck = Checkpointer(str(tmp_path))
        tree = {"z": torch.arange(6, dtype=torch.int32).reshape(2, 3),
                "m": {"y": np.ones(3, np.float32), "b": torch.zeros(2)}}
        ck.save(0, tree)
        assert ck._load_manifest(0)["keys"] == [["m", "b"], ["m", "y"], ["z"]]
        got, meta = ck.restore()
        assert meta == {}
        np.testing.assert_array_equal(got["z"], np.arange(6, dtype=np.int32).reshape(2, 3))
        np.testing.assert_array_equal(got["m"]["y"], np.ones(3, np.float32))
        np.testing.assert_array_equal(got["m"]["b"], np.zeros(2, np.float32))
        # a bfloat16 tensor is stored bit for bit and restored as bfloat16
        q = torch.tensor([1.0, -2.5, 3.1415926, 1e-30, float("inf")]).to(torch.bfloat16)
        ck.save(1, {"q": q})
        assert ck._load_manifest(1)["leaves"][0]["dtype"] == "bfloat16"
        got, _ = ck.restore()
        assert got["q"].dtype == torch.bfloat16 and torch.equal(got["q"], q)

    def test_corrupt_leaf_raises_typed_and_falls_back(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        ck.save(1, _tree(1), meta={"k": 1})
        ck.save(2, _tree(2), meta={"k": 2})
        p = tmp_path / "step_00000002" / "arr_0.npy"
        blob = p.read_bytes()
        p.write_bytes(blob[:-3] + b"zzz")
        # explicit step: strict, typed, names the step and file
        with pytest.raises(CorruptSnapshot) as ei:
            ck.restore(step=2)
        assert ei.value.step == 2 and ei.value.file == "arr_0.npy"
        # step=None: falls back to the newest step that verifies
        tree, meta = ck.restore()
        assert meta == {"k": 1}
        np.testing.assert_array_equal(tree["a"], _tree(1)["a"])

    def test_injected_read_corruption_caught_by_crc(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        ck.save(1, _tree(1), meta={"k": 1})
        ck.save(2, _tree(2), meta={"k": 2})
        plan = FaultPlan().add(
            "snapshot.read.corrupt", arg=10, count=math.inf, step=2
        )
        with faults.active(plan):
            tree, meta = ck.restore()
        assert meta == {"k": 1}  # step 2's flipped byte failed its crc
        assert plan.fired

    def test_garbled_manifest_read_meta_typed(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        ck.save(3, _tree(3), meta={"k": 3})
        (tmp_path / "step_00000003" / "manifest.json").write_text("{tor")
        with pytest.raises(CorruptSnapshot) as ei:
            ck.read_meta(3)
        assert ei.value.step == 3 and "manifest.json" in ei.value.file

    def test_stranded_latest_falls_back(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        ck.save(1, _tree(1), meta={"k": 1})
        ck.save(2, _tree(2), meta={"k": 2})
        # LATEST names a step whose dir is gone
        (tmp_path / "LATEST").write_text("7")
        assert ck.latest_step() == 2
        _, meta = ck.restore()
        assert meta == {"k": 2}
        # torn LATEST content
        (tmp_path / "LATEST").write_text("st")
        assert ck.latest_step() == 2
        _, meta = ck.restore()
        assert meta == {"k": 2}

    def test_missing_latest_file_falls_back(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        ck.save(1, _tree(1), meta={"k": 1})
        (tmp_path / "LATEST").unlink()
        assert ck.latest_step() == 1
        _, meta = ck.restore()
        assert meta == {"k": 1}

    def test_gc_skips_step_mid_restore(self, tmp_path):
        ck = Checkpointer(str(tmp_path), keep=1)
        ck.save(1, _tree(1), meta={"k": 1})
        with ck._reading_lock:
            ck._reading.add(1)  # a concurrent restore() holds step 1
        ck.save(2, _tree(2), meta={"k": 2})
        assert (tmp_path / "step_00000001").exists()
        with ck._reading_lock:
            ck._reading.discard(1)
        ck.save(3, _tree(3), meta={"k": 3})
        assert not (tmp_path / "step_00000001").exists()

    def test_tmp_salvage_and_torn_tmp_gc(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        ck.save(1, _tree(1), meta={"k": 1})
        # crash after the tmp dir is complete but before the rename:
        # the next Checkpointer salvages it into a real step
        plan = FaultPlan().add("snapshot.write.crash", stage="pre_rename")
        with faults.active(plan), pytest.raises(SimulatedCrash):
            ck.save(2, _tree(2), meta={"k": 2})
        ck2 = Checkpointer(str(tmp_path))
        assert not [n for n in os.listdir(tmp_path) if ".tmp." in n]
        _, meta = ck2.restore()
        assert meta == {"k": 2}
        # a torn leaf leaves an unverifiable tmp: swept, not salvaged
        plan = FaultPlan().add("snapshot.write.torn", file="arr_0.npy", arg=9)
        with faults.active(plan), pytest.raises(SimulatedCrash):
            ck2.save(3, _tree(3), meta={"k": 3})
        ck3 = Checkpointer(str(tmp_path))
        assert not [n for n in os.listdir(tmp_path) if ".tmp" in n]
        _, meta = ck3.restore()
        assert meta == {"k": 2}

    def test_tmp_of_a_live_writer_is_left_alone(self, tmp_path):
        """The owner-pid check: a tmp dir named after a live process other
        than this one is a concurrent write, never swept."""
        ck = Checkpointer(str(tmp_path))
        ck.save(1, _tree(1), meta={"k": 1})
        live = tmp_path / f"step_00000002.tmp.{os.getppid()}"
        live.mkdir()
        Checkpointer(str(tmp_path))
        assert live.exists()

    def test_save_async_error_surfaces_at_wait(self, tmp_path):
        ck = Checkpointer(str(tmp_path))
        faults.install(
            FaultPlan().add("snapshot.write.crash", stage="pre_manifest")
        )
        try:
            ck.save_async(1, _tree(1), meta={"k": 1})
            with pytest.raises(SimulatedCrash):
                ck.wait()
        finally:
            faults.uninstall()
        # the recovery path drains without re-raising
        faults.install(
            FaultPlan().add("snapshot.write.crash", stage="pre_manifest")
        )
        try:
            ck.save_async(2, _tree(2), meta={"k": 2})
            ck.wait(reraise=False)
        finally:
            faults.uninstall()

    def test_v1_manifest_backward_compat(self, tmp_path):
        """A pre-checksum manifest restores: verification is simply
        skipped for leaves with no crc32."""
        ck = Checkpointer(str(tmp_path))
        ck.save(1, _tree(1), meta={"k": 1})
        mpath = tmp_path / "step_00000001" / "manifest.json"
        manifest = json.loads(mpath.read_text())
        manifest.pop("manifest_version")
        for spec in manifest["leaves"]:
            spec.pop("crc32")
        mpath.write_text(json.dumps(manifest))
        tree, meta = ck.restore()
        assert meta == {"k": 1}
        np.testing.assert_array_equal(tree["a"], _tree(1)["a"])


# ---------------------------------------------------------------------------
# Across the packages
# ---------------------------------------------------------------------------


class TestReferenceCheckpoints:
    def test_reference_checkpoint_restores_from_key_names(self, tmp_path):
        """A v2 checkpoint the reference wrote (a JAX treedef, no key
        paths) restores from the key names its reader expects, matched to
        the leaves in sorted order; without them it raises, never guesses."""
        RM = R.ref_modules()
        tree = {"b": _tree(1)["b"], "a": _tree(1)["a"],
                "m": {"y": np.arange(3, dtype=np.int32), "x": np.ones(2, np.float32)}}
        RM.checkpoint.Checkpointer(str(tmp_path)).save(4, tree, meta={"k": 4})
        ck = Checkpointer(str(tmp_path))
        assert "keys" not in ck._load_manifest(4)
        with pytest.raises(ValueError, match="keys"):
            ck.restore()
        got, meta = ck.restore(keys=lambda meta, n: [["m", "y"], "a", ["m", "x"], "b"])
        assert meta == {"k": 4}
        for k in ("a", "b"):
            np.testing.assert_array_equal(got[k], tree[k])
        for k in ("x", "y"):
            np.testing.assert_array_equal(got["m"][k], tree["m"][k])
        got2, _ = ck.restore(keys=lambda meta, n: ["a", "b", ["m", "x"], ["m", "y"]])
        np.testing.assert_array_equal(got2["m"]["y"], tree["m"]["y"])
        with pytest.raises(ValueError, match="3 key paths for 4 leaves"):
            ck.restore(keys=lambda meta, n: ["a", "b", ["m", "x"]])

    def test_port_manifest_is_one_way(self, tmp_path):
        """The reference parses only its own treedef proto: a port
        manifest (key paths, no treedef) is a corrupt snapshot to it."""
        Checkpointer(str(tmp_path)).save(1, _tree(1), meta={"k": 1})
        RM = R.ref_modules()
        with pytest.raises(RM.checkpoint.CorruptSnapshot):
            RM.checkpoint.Checkpointer(str(tmp_path)).restore()


# ---------------------------------------------------------------------------
# Crash-consistency property: kill the writer at every snapshot-lane site
# ---------------------------------------------------------------------------

# scenario space: 4 crash stages, torn leaf, torn manifest, read corruption
_N_SCENARIOS = len(SNAPSHOT_CRASH_STAGES) + 3


def _snapshot_fault_plan(scenario: int, byte: int, step: int) -> FaultPlan:
    plan = FaultPlan()
    if scenario < len(SNAPSHOT_CRASH_STAGES):
        plan.add(
            "snapshot.write.crash",
            stage=SNAPSHOT_CRASH_STAGES[scenario], step=step,
        )
    elif scenario == len(SNAPSHOT_CRASH_STAGES):
        plan.add("snapshot.write.torn", file="arr_0.npy", arg=byte, step=step)
    elif scenario == len(SNAPSHOT_CRASH_STAGES) + 1:
        plan.add(
            "snapshot.write.torn", file="manifest.json", arg=byte, step=step
        )
    # scenario _N_SCENARIOS-1: no write fault — bit-rot at restore time
    return plan


class TestCrashConsistency:
    @given(
        scenario=st.integers(min_value=0, max_value=_N_SCENARIOS - 1),
        byte=st.integers(min_value=1, max_value=160),
    )
    @settings(max_examples=8, deadline=None)
    def test_restore_always_lands_on_committed_state(
        self, setup, tmp_path_factory, scenario, byte
    ):
        """Whatever site the writer dies at, ``restore_collection`` must
        recover a committed snapshot: its search results are bit-equal
        to the state at one of the snapshots the writer attempted, and
        the directory sweeps clean of tmp dirs."""
        data, queries = setup
        directory = str(tmp_path_factory.mktemp(f"crash_{scenario}_{byte}"))
        params = DBLSHParams.derive(
            n=200, d=12, c=1.5, w0=3.6, t=16, k=10, inline_vectors=True
        )
        col = Collection.create("cc", torch.Generator().manual_seed(31), data[:200],
                                params=params, device=CPU)
        kw = dict(k=10, r0=0.5, steps=6, engine="torch")
        ref1 = col.search(queries, **kw)
        step1 = col.snapshot(directory)
        col.add(data[200:240])
        ref2 = col.search(queries, **kw)

        read_fault = scenario == _N_SCENARIOS - 1
        step2 = step1 + 1
        plan = _snapshot_fault_plan(scenario, byte, step2)
        try:
            with faults.active(plan):
                col.snapshot(directory)
        except SimulatedCrash:
            pass

        if read_fault:
            # the write committed clean; rot step2's bytes at read time
            faults.install(FaultPlan().add(
                "snapshot.read.corrupt", arg=byte, count=math.inf, step=step2,
            ))
        try:
            restored = restore_collection(directory, device=CPU)
        finally:
            faults.uninstall()
        got = restored.search(queries, **kw)
        matches_1 = all(torch.equal(g, r) for g, r in zip(got, ref1))
        matches_2 = all(torch.equal(g, r) for g, r in zip(got, ref2))
        assert matches_1 or matches_2, (
            f"scenario={scenario} byte={byte}: restored state matches "
            "neither attempted snapshot"
        )
        if read_fault:
            assert matches_1  # step2 failed its crc: fell back to step1
        # a fresh Checkpointer sweeps the wreckage
        Checkpointer(directory)
        assert not [n for n in os.listdir(directory) if ".tmp" in n]


# ---------------------------------------------------------------------------
# The service: deadlines, dispatch failure, brownout, stragglers
# ---------------------------------------------------------------------------


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
def col():
    """tests/test_resilience.py's collection: the reference builds it, the
    port takes its arrays."""
    data, _, kb = R.resilience_fixture()
    params = R.DBLSHParams.derive(
        n=240, d=12, c=1.5, w0=3.6, t=16, k=10, inline_vectors=True
    )
    _, arrays, ref_params = R.ref_collection_arrays("res", kb, data, params=params)
    return Collection.from_index("res", from_arrays(arrays, ref_params, device=CPU))


def _service(col, *, engine="torch", depth=2, clock=None, **kw):
    kw.setdefault("batch_shapes", (1, 4, 8))
    kw.setdefault("max_wait_ms", 1e9)
    kw.setdefault("cache_size", 0)
    svc = StoreService(
        default_k=10, r0=0.5, steps=6, engine=engine,
        inflight_depth=depth,
        **({"clock": clock} if clock is not None else {}),
        **kw,
    )
    svc.attach(col)
    return svc


def _measured_table() -> ScheduleTable:
    # schedule length j+1 costs 2^j ms; recall climbs toward 1
    return ScheduleTable(
        r0=0.5, c=1.5, k=10,
        recall=(0.55, 0.7, 0.82, 0.9, 0.95, 0.98),
        cost_slots=(8.0, 16.0, 32.0, 64.0, 128.0, 256.0),
        cost_ms=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0),
        n_sample=64,
    )


class TestDeadlines:
    def test_expired_deadline_fails_typed(self, setup, col):
        _, queries = setup
        clk = FakeClock()
        svc = _service(col, clock=clk)
        r = svc.submit("res", queries[0], deadline_ms=10.0)
        clk.advance(0.02)  # 20ms in the queue
        svc.step(force=True)
        assert r.done and isinstance(r.error, DeadlineExceeded)
        assert r.dists is None
        s = svc.stats("res")
        assert s["failed"] == 1 and s["queries"] == 0
        assert svc.tenant_stats("default")["failed"] == 1
        assert svc.pending() == 0 and svc.in_flight() == 0

    def test_deadline_replans_through_measured_table(self, setup, col):
        """A ticket whose remaining budget cannot fit the resolved plan
        is re-planned via LatencyBudget over the measured calibration
        table — shorter schedule, flagged degraded — instead of either
        blowing the deadline or failing outright."""
        _, queries = setup
        clk = FakeClock()
        svc = _service(col, clock=clk)
        old_table = col.calibration
        col.calibration = _measured_table()
        try:
            r = svc.submit("res", queries[0], deadline_ms=10.0)
            assert r.plan.steps == 6  # service default at submit
            clk.advance(0.005)  # 5ms gone -> ~5ms budget -> 3 steps (4ms)
            svc.step(force=True)
        finally:
            col.calibration = old_table
        assert r.done and r.error is None
        assert r.degraded and r.plan.steps == 3
        assert r.dists is not None
        assert svc.stats("res")["degraded"] == 1

    def test_late_completion_flags_degraded(self, setup, col):
        """No calibration: the plan cannot shrink, but a result landing
        past its deadline is still flagged, never silently on-time."""
        _, queries = setup
        clk = FakeClock()
        svc = _service(col, clock=clk, depth=1, max_wait_ms=0.0)
        old_table = col.calibration
        col.calibration = None
        try:
            r = svc.submit("res", queries[0], deadline_ms=10.0)
            svc.step()          # issued within budget
            clk.advance(0.05)   # device "takes" 50ms
            svc.flush()
        finally:
            col.calibration = old_table
        assert r.done and r.error is None and r.degraded
        assert r.plan.steps == 6  # plan untouched — only the flag


class TestDispatchFailure:
    @pytest.mark.parametrize("engine", ENGINES)
    def test_transient_raise_retried_bit_equal(self, setup, col, engine):
        _, queries = setup
        ref = _service(col, engine=engine).serve("res", queries[:4])
        svc = _service(col, engine=engine, sleep=lambda s: None)
        plan = FaultPlan().add("dispatch.raise", count=2, transient=True)
        with faults.active(plan):
            d, i, reqs = svc.serve("res", queries[:4])
        assert len(plan.fired) == 2  # both transient raises were consumed
        np.testing.assert_array_equal(d, ref[0])
        np.testing.assert_array_equal(i, ref[1])
        assert all(r.error is None and not r.degraded for r in reqs)

    def test_backoff_is_capped_exponential(self, setup, col):
        _, queries = setup
        slept = []
        svc = _service(
            col, sleep=slept.append, retry_limit=3,
            retry_backoff_ms=4.0, retry_backoff_cap_ms=10.0,
        )
        plan = FaultPlan().add("dispatch.raise", count=3, transient=True)
        with faults.active(plan):
            svc.serve("res", queries[:1])
        assert slept == [0.004, 0.008, 0.010]  # 4, 8, min(16, cap=10) ms

    def test_persistent_raise_fails_every_ticket_typed(self, setup, col):
        _, queries = setup
        svc = _service(col, sleep=lambda s: None)
        reqs = [svc.submit("res", q) for q in queries[:4]]
        plan = FaultPlan().add(
            "dispatch.raise", count=math.inf, transient=True
        )
        with faults.active(plan):
            svc.flush()
        assert all(r.done for r in reqs)
        assert all(isinstance(r.error, DispatchFailed) for r in reqs)
        assert svc.pending() == 0 and svc.in_flight() == 0
        assert svc.stats("res")["failed"] == 4
        # serve() surfaces the typed error to synchronous callers
        with faults.active(plan.reset()), pytest.raises(DispatchFailed):
            svc.serve("res", queries[:2])

    def test_nontransient_raise_fails_without_retry(self, setup, col):
        _, queries = setup
        slept = []
        svc = _service(col, sleep=slept.append)
        plan = FaultPlan().add("dispatch.raise", transient=False)
        r = svc.submit("res", queries[0])
        with faults.active(plan):
            svc.flush()
        assert isinstance(r.error, DispatchFailed)
        assert slept == []  # no backoff spent on a non-transient error
        assert len(plan.fired) == 1

    def test_completion_failure_fails_the_batch_typed(self, setup, col):
        """A batch whose wait raises after issue (a device fault that
        surfaces at its event) terminates every ticket with
        DispatchFailed: nothing is swallowed, no ticket hangs in the
        ring."""
        _, queries = setup
        svc = _service(col, depth=2)
        reqs = [svc.submit("res", q) for q in queries[:3]]
        svc._issue("res", svc._drain_wrr("res", 8))  # in the ring, not completed
        assert svc.in_flight() == 3

        class Broken:
            def ready(self):
                return False

            def result(self):
                raise RuntimeError("an illegal memory access was encountered")

        svc._inflight[-1].pending = Broken()
        svc.flush()
        assert all(r.done and isinstance(r.error, DispatchFailed) for r in reqs)
        assert isinstance(reqs[0].error.__cause__, RuntimeError)
        assert svc.in_flight() == 0 and svc.stats("res")["failed"] == 3

    @pytest.mark.parametrize("engine", ENGINES)
    def test_no_faults_bit_equal_pin(self, setup, col, engine):
        """With faults disabled — no plan installed, or an installed-but-
        empty plan — the stack serves bit-identically to the plain
        dispatch (a direct collection search), across the engines."""
        _, queries = setup
        direct = col.search(queries[:8], k=10, r0=0.5, steps=6, engine=engine)
        d0, i0, reqs = _service(col, engine=engine).serve("res", queries[:8])
        with faults.active(FaultPlan()):  # installed, but scripts nothing
            d1, i1, _ = _service(col, engine=engine).serve("res", queries[:8])
        np.testing.assert_array_equal(d0, direct[0].numpy()[:, :10])
        np.testing.assert_array_equal(i0, direct[1].numpy()[:, :10])
        np.testing.assert_array_equal(d0, d1)
        np.testing.assert_array_equal(i0, i1)
        assert all(
            r.done and r.error is None and not r.degraded for r in reqs
        )


class TestBrownout:
    def _svc_with_bc(self, col, clk, **bc_kw):
        svc = _service(col, clock=clk, latency_window=4)
        bc = BrownoutController(svc, **bc_kw)
        assert svc.brownout is bc
        return svc, bc

    def test_ladder_escalates_and_heals(self, col):
        clk = FakeClock()
        svc, bc = self._svc_with_bc(col, clk, heal_after=2)
        breach = ["b"]  # any non-empty event list
        bc.observe(breach, clk.advance(1))
        assert bc.level == 1
        bc.observe(breach, clk.advance(1))
        bc.observe(breach, clk.advance(1))
        bc.observe(breach, clk.advance(1))
        assert bc.level == 3  # capped at max_level
        for _ in range(2):
            bc.observe([], clk.advance(1))
        assert bc.level == 2  # one rung per heal_after clean checks
        for _ in range(4):
            bc.observe([], clk.advance(1))
        assert bc.level == 0
        assert svc.registry.get("repro_store_brownout_level").value() == 0

    def test_hold_rate_limits_escalation(self, col):
        clk = FakeClock()
        _, bc = self._svc_with_bc(col, clk, hold_s=10.0)
        bc.observe(["b"], clk.advance(1))
        bc.observe(["b"], clk.advance(1))  # only 1s after the last rung
        assert bc.level == 1
        bc.observe(["b"], clk.advance(20))
        assert bc.level == 2

    def test_plans_degrade_per_rung(self, setup, col):
        _, queries = setup
        clk = FakeClock()
        svc, bc = self._svc_with_bc(col, clk, step_cap_frac=0.5)
        r0 = svc.submit("res", queries[0])
        assert r0.plan.steps == 6 and not r0.degraded
        bc.observe(["b"], clk.advance(1))           # level 1: cap steps
        r1 = svc.submit("res", queries[1])
        assert r1.plan.steps == 3 and r1.degraded
        bc.observe(["b"], clk.advance(1))           # level 2: fixed floor
        r2 = svc.submit("res", queries[2])
        assert r2.plan.steps == 1 and r2.plan.termination is None
        assert r2.degraded
        svc.flush()
        assert all(r.done and r.error is None for r in (r0, r1, r2))
        assert svc.stats("res")["degraded"] == 2

    def test_shed_by_quota_weight(self, setup, col):
        _, queries = setup
        clk = FakeClock()
        svc, bc = self._svc_with_bc(col, clk)
        svc.set_quota("gold", weight=5)
        svc.set_quota("bronze", weight=1)
        for _ in range(3):
            bc.observe(["b"], clk.advance(1))
        assert bc.level == 3
        with pytest.raises(BrownoutShed):
            svc.submit("res", queries[0], tenant="bronze")
        r = svc.submit("res", queries[0], tenant="gold")  # kept, degraded
        assert r.degraded
        assert svc.tenant_stats("bronze")["rejected"] == 1
        # equal weights shed nobody
        svc.set_quota("gold", weight=1)
        svc.submit("res", queries[1], tenant="bronze")
        svc.flush()

    def test_slo_watch_integration_escalates_then_heals(self, setup, col):
        """End to end: slow served traffic breaches the p99 ceiling via
        SLOWatch.check -> on_check -> escalate; once the (small) latency
        window refills with fast queries, clean checks heal the ladder
        back to healthy."""
        _, queries = setup
        clk = FakeClock()
        svc, bc = self._svc_with_bc(col, clk, heal_after=2)
        slo = SLOWatch(
            svc.registry, "res", latency_p99_ms=10.0, min_samples=2,
            clock=clk,
        )
        bc.attach(slo)
        for q in queries[:4]:
            svc.submit("res", q)
        clk.advance(0.05)  # 50ms in queue -> p99 ~50ms
        svc.flush()
        assert slo.check(clk()) and bc.level == 1
        # traffic fast again: the 4-sample window forgets the spike
        for q in queries[:4]:
            svc.submit("res", q)
            svc.step(force=True)
        for _ in range(2):
            assert slo.check(clk.advance(1)) == []
        assert bc.level == 0


class TestStragglers:
    def test_runtime_reexport_identity(self):
        from repro_torch.runtime.fault_tolerance import (
            StragglerMonitor as RuntimeMonitor,
        )

        assert RuntimeMonitor is StragglerMonitor

    def test_monitor_flags_outlier_without_folding_it(self):
        mon = StragglerMonitor(alpha=0.5, threshold=2.0, warmup=3)
        assert not any(mon.record(i, 1.0) for i in range(4))
        assert mon.record(4, 10.0)
        assert mon.flagged == [(4, 10.0)]
        assert mon.ewma == 1.0  # the outlier never polluted the baseline

    def test_service_flags_slow_batch(self, setup, col):
        """Issue->complete wall time feeds the per-collection monitor: a
        batch 10x the EWMA baseline lands in straggler_batches."""
        _, queries = setup
        clk = FakeClock()
        svc = _service(col, clock=clk, depth=1, max_wait_ms=0.0)
        for i in range(5):
            svc.submit("res", queries[i % len(queries)])
            svc.step()  # issues batch i; poll() completes batch i-1
            clk.advance(10.0 if i == 4 else 1.0)
        svc.flush()
        assert svc.stats("res")["straggler_batches"] == 1
