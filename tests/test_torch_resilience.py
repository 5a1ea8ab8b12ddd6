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

The service cases (deadlines, dispatch failure, brownout, stragglers)
wait for the port of ``store/service.py``.
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
from repro_torch.core import DBLSHParams  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402
from repro_torch.resilience import (  # noqa: E402
    SNAPSHOT_CRASH_STAGES,
    BrownoutController,
    FaultPlan,
    SimulatedCrash,
    StragglerMonitor,
    faults,
)
from repro_torch.store import Collection, restore_collection  # noqa: E402

CPU = "cpu"


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
        with pytest.raises(TypeError, match="bfloat16"):
            ck.save(1, {"q": torch.zeros(2, dtype=torch.bfloat16)})

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
