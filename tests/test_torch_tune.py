"""The port's ``tune`` package held to tests/test_tune.py and the reference.

* the planner cases of tests/test_tune.py:200-272 (table shape and
  monotonicity, RecallTarget minimality, fixed and fallback planning,
  LatencyBudget, policy resolution) on the port's ``calibrate``;
* :356, the search policy and calibration table through a
  ``Collection`` snapshot and restore;
* ``calibrate``'s table against the reference's on the tune fixture's
  arrays carried across (``from_arrays``), engine for engine: with the
  reference's ``r0`` the whole table is equal (``recall`` and
  ``cost_slots``); the derived ``r0`` is a quantile of brute-force
  distances in the norm form ||q||² − 2q·x + ||x||², whose float32
  cancellation each framework rounds its own way (4.5e-4 relative on
  this fixture), so it is held to the norm form's tolerance of
  tests/test_onepass_search.py:91 (rtol 1e-2);
* ``ScheduleTable.to_dict``/``from_dict`` cross between the packages.

tests/test_torch_termination.py holds the C2 property and the
Termination cases; the service cases wait for the port of
``store/service.py``.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
R = pytest.importorskip("_torch_parity")

from repro_torch.core import ENGINES, Termination, from_arrays, search_batch_fixed  # noqa: E402
from repro_torch.store import Collection  # noqa: E402
from repro_torch.tune import (  # noqa: E402
    FixedSchedule,
    LatencyBudget,
    RecallTarget,
    ResolvedPlan,
    ScheduleTable,
    calibrate,
    certified_c2_mask,
    plan,
    policy_from_dict,
    policy_to_dict,
    resolve_policy,
    search_batch_adaptive,
    termination_step_histogram,
)

K_TEST = 8
CPU = "cpu"
REF_ENGINE = {"torch": "jnp", "kernel": "kernel", "inline": "inline"}
R0_RTOL = 1e-2  # r0: a quantile of norm-form brute-force distances


@pytest.fixture(scope="module")
def setup():
    data, queries, ref = R.tune_fixture()
    index = from_arrays(R.index_arrays(ref), R.index_params(ref), device=CPU)
    return data, queries, ref, index


# ------------------------------------------------------------------- planner
def test_calibration_table_shape_and_monotonicity(setup):
    data, queries, _, index = setup
    table = calibrate(index, queries[:16], k=K_TEST, steps_max=6)
    assert table.max_steps == 6
    assert table.c == index.params.c
    # windows nest: longer schedules only add candidates, so expected
    # recall and verified-slot cost are non-decreasing in steps
    assert all(
        b >= a - 1e-9 for a, b in zip(table.recall, table.recall[1:])
    )
    assert all(
        b >= a - 1e-9 for a, b in zip(table.cost_slots, table.cost_slots[1:])
    )
    assert all(math.isnan(m) for m in table.cost_ms)


def test_recall_target_planning(setup):
    data, queries, _, index = setup
    table = calibrate(index, queries[:16], k=K_TEST, steps_max=8)
    achievable = max(table.recall)
    target = min(0.8, achievable)
    p = plan(table, RecallTarget(target))
    # minimal: meets the target, and one step fewer would miss it
    assert table.recall[p.steps - 1] >= target
    if p.steps > 1:
        assert table.recall[p.steps - 2] < target
    assert p.r0 == table.r0
    assert p.termination == Termination()
    # an unreachable target degrades to the best the table achieved,
    # capped by max_steps
    p_hi = plan(table, RecallTarget(2.0, max_steps=5))
    assert p_hi.steps == 5


def test_fixed_schedule_and_fallback_planning():
    p = plan(None, FixedSchedule(), default_r0=0.7, default_steps=6)
    assert p == ResolvedPlan(r0=0.7, steps=6, termination=None)
    p2 = plan(None, FixedSchedule(r0=0.2, steps=3))
    assert (p2.r0, p2.steps) == (0.2, 3)
    # RecallTarget without calibration: full default schedule + adaptive
    p3 = plan(None, RecallTarget(0.9), default_r0=0.7, default_steps=6)
    assert (p3.r0, p3.steps) == (0.7, 6)
    assert p3.termination is not None
    # ...still capped by the policy's max_steps latency guard
    assert plan(None, RecallTarget(0.9, max_steps=2),
                default_steps=8).steps == 2
    # LatencyBudget refuses to plan without measured milliseconds
    with pytest.raises(ValueError):
        plan(None, LatencyBudget(1.0))
    with pytest.raises(ValueError):
        plan(
            ScheduleTable(
                r0=0.5, c=1.5, k=8, recall=(1.0,), cost_slots=(10.0,),
                cost_ms=(float("nan"),), n_sample=4,
            ),
            LatencyBudget(1.0),
        )


def test_latency_budget_planning():
    table = ScheduleTable(
        r0=0.5, c=1.5, k=8,
        recall=(0.5, 0.8, 0.9, 0.95),
        cost_slots=(100.0, 200.0, 300.0, 400.0),
        cost_ms=(0.2, 0.5, 1.1, 2.4),
        n_sample=8,
    )
    assert plan(table, LatencyBudget(1.2)).steps == 3
    assert plan(table, LatencyBudget(0.1)).steps == 1   # floor: always search
    assert plan(table, LatencyBudget(10.0)).steps == 4
    assert plan(table, LatencyBudget(10.0, max_steps=2)).steps == 2


def test_measured_table_plans_a_latency_budget(setup):
    """``measure_ms=True`` times every length (finite, positive), and
    the measured table backs a LatencyBudget."""
    data, queries, _, index = setup
    table = calibrate(index, queries[:8], k=K_TEST, steps_max=3, measure_ms=True,
                      repeats=1)
    assert all(np.isfinite(m) and m > 0 for m in table.cost_ms)
    assert 1 <= plan(table, LatencyBudget(1e9)).steps == 3


def test_policy_resolution_order():
    assert resolve_policy(None, None, None) is None
    svc_p = RecallTarget(0.5)
    col_p = FixedSchedule(steps=2)
    req_p = FixedSchedule(steps=3)
    assert resolve_policy(None, None, svc_p) is svc_p
    assert resolve_policy(None, col_p, svc_p) is col_p
    assert resolve_policy(req_p, col_p, svc_p) is req_p


# ----------------------------------------------------- against the reference
@pytest.fixture(scope="module")
def ref_tables(setup):
    """The reference's calibration per engine (Pallas in interpret mode)."""
    _, queries, ref, _ = setup
    RM = R.ref_modules()
    return {e: RM.tune.calibrate(ref, queries[:16], k=K_TEST, steps_max=6,
                                 engine=REF_ENGINE[e],
                                 interpret=True if e != "torch" else None)
            for e in ENGINES}


@pytest.mark.parametrize("engine", ENGINES)
def test_calibrate_matches_reference(setup, ref_tables, engine):
    """Same arrays, same sample, the reference's r0: the recall and
    slot-cost curves are equal (the searches return the reference's id
    sets and stats).  The r0 the port derives is the reference's to the
    norm form's rounding."""
    _, queries, _, index = setup
    want = ref_tables[engine]
    got = calibrate(index, queries[:16], k=K_TEST, r0=want.r0, steps_max=6, engine=engine)
    assert got.r0 == want.r0
    assert got.recall == want.recall
    assert got.cost_slots == want.cost_slots
    assert (got.c, got.k, got.n_sample) == (want.c, want.k, want.n_sample)
    derived = calibrate(index, queries[:16], k=K_TEST, steps_max=1, engine=engine)
    np.testing.assert_allclose(derived.r0, want.r0, rtol=R0_RTOL)


def test_tables_and_policies_cross_between_packages(setup, ref_tables):
    """``to_dict``/``from_dict`` keep the reference's keys, and the
    policies' dict forms are the reference's."""
    RM = R.ref_modules()
    want = ref_tables["torch"]
    got = ScheduleTable.from_dict(want.to_dict())
    assert got.to_dict().keys() == want.to_dict().keys()
    assert got.recall == want.recall and got.r0 == want.r0
    back = RM.tune.ScheduleTable.from_dict(got.to_dict())
    assert back.cost_slots == want.cost_slots
    for pol, ref_pol in ((RecallTarget(0.8, max_steps=9), RM.tune.RecallTarget(0.8, max_steps=9)),
                         (LatencyBudget(2.5), RM.tune.LatencyBudget(2.5)),
                         (FixedSchedule(r0=0.3, steps=4), RM.tune.FixedSchedule(r0=0.3, steps=4))):
        assert policy_to_dict(pol) == RM.tune.policy_to_dict(ref_pol)
        assert policy_from_dict(RM.tune.policy_to_dict(ref_pol)) == pol
    assert plan(got, RecallTarget(0.5)).steps == RM.tune.plan(want, RM.tune.RecallTarget(0.5)).steps


# ------------------------------------------------------------------ adaptive
def test_adaptive_helpers_match_reference(setup):
    """``search_batch_adaptive`` is the fixed schedule under
    ``Termination()``; the stats helpers (jax-free copies) agree with the
    reference's on the same stats."""
    _, queries, _, index = setup
    kw = dict(k=K_TEST, r0=0.3, steps=6)
    got = search_batch_adaptive(index, queries, engine="kernel", device=CPU, **kw)
    want = search_batch_fixed(index, queries, engine="kernel", with_stats=True,
                              termination=Termination(), device=CPU, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got[:2], want[:2]))
    stats = {k: v.numpy() for k, v in got[2].items()}
    RM = R.ref_modules()
    np.testing.assert_array_equal(termination_step_histogram(stats, 6),
                                  RM.tune.termination_step_histogram(stats, 6))
    mask_kw = dict(r0=0.3, c=index.params.c, k=K_TEST, steps=6)
    np.testing.assert_array_equal(certified_c2_mask(got[0].numpy(), stats, **mask_kw),
                                  RM.tune.certified_c2_mask(got[0].numpy(), stats, **mask_kw))


# ---------------------------------------------------------------- persistence
def test_search_policy_and_calibration_snapshot_roundtrip(setup, tmp_path):
    data, queries, _, index = setup
    c3 = Collection.from_index("c3", index, key=np.array([0, 7], np.uint32))
    c3.search_policy = RecallTarget(0.8, max_steps=9)
    table = c3.calibrate(queries[:12], k=K_TEST, steps_max=5)
    c3.snapshot(str(tmp_path))
    r = Collection.restore(str(tmp_path), device=CPU)
    assert r.search_policy == c3.search_policy
    assert r.calibration.r0 == table.r0
    assert r.calibration.recall == table.recall
    assert r.calibration.cost_slots == table.cost_slots
    # NaN-aware: unmeasured cost_ms round-trips as NaN
    np.testing.assert_array_equal(
        np.isnan(r.calibration.cost_ms), np.isnan(table.cost_ms)
    )
    # the restored table plans identically
    assert plan(r.calibration, r.search_policy) == plan(
        table, c3.search_policy
    )
