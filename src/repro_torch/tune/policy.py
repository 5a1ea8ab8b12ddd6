"""Query-planning policies: ask for outcomes, not radii.

The serving core takes mechanism-level knobs — initial radius ``r0``,
schedule length ``steps``, a :class:`~repro_torch.core.serve_search.Termination`
— but callers think in outcomes: "95% recall", "under 2 ms", "exactly
the schedule I measured".  A *policy* names the outcome; the planner
(:mod:`repro_torch.tune.planner`) resolves it against a collection's
calibration table into a :class:`ResolvedPlan`, the concrete (r0, steps,
termination) triple the dispatch actually runs.

Three policies:

* :class:`FixedSchedule` — pin the mechanism directly.  The default
  ``FixedSchedule()`` resolves to the caller's own (r0, steps) with no
  adaptive termination, which makes it *bit-equal* to a plain
  ``search_batch_fixed`` call (the tune test suite asserts this).
* :class:`RecallTarget` — the planner picks the shortest calibrated
  schedule whose expected recall meets the target, and runs it with
  adaptive termination so easy queries still stop early.
* :class:`LatencyBudget` — the planner picks the longest calibrated
  schedule whose measured per-query latency fits the budget.

**Resolution order** mirrors the engine-default resolution from the
store layer (request > collection > service): :func:`resolve_policy`
returns the first non-``None`` of the explicit request policy, the
collection's ``search_policy``, and the service default.  ``None``
everywhere means "no planning" — the service dispatches its own
(r0, steps) with no termination, exactly the pre-tune behavior.

Policies and plans are frozen dataclasses: hashable (a ResolvedPlan is
part of a dispatch's fixed signature and of the result-cache key)
and serializable (:func:`policy_to_dict` / :func:`policy_from_dict` ride
in collection snapshots).
"""

from __future__ import annotations

import dataclasses

from ..core.serve_search import Termination

__all__ = [
    "FixedSchedule",
    "LatencyBudget",
    "POLICY_SOURCES",
    "RecallTarget",
    "ResolvedPlan",
    "policy_from_dict",
    "policy_to_dict",
    "resolve_policy",
    "resolve_policy_with_source",
]


@dataclasses.dataclass(frozen=True)
class FixedSchedule:
    """Run exactly this schedule.  ``None`` fields defer to the caller's
    defaults (the service's r0/steps).  ``termination=None`` (default)
    keeps the plain fixed path — bit-equal to ``search_batch_fixed``;
    supplying one layers adaptive termination on a pinned schedule."""

    r0: float | None = None
    steps: int | None = None
    termination: Termination | None = None


@dataclasses.dataclass(frozen=True)
class RecallTarget:
    """Meet an expected recall@k.  Needs a calibrated collection to pick
    the schedule; uncalibrated it falls back to the full default
    schedule (never *shorter* than asked) with adaptive termination.
    ``max_steps`` caps the planner even when the table says recall is
    still below target (the calibration reports what was achieved)."""

    recall: float = 0.95
    max_steps: int = 12
    termination: Termination = Termination()


@dataclasses.dataclass(frozen=True)
class LatencyBudget:
    """Fit a per-query latency budget (milliseconds).  Requires a
    calibration table measured with ``measure_ms=True`` — the planner
    refuses to guess device speed.  A budget no measured schedule fits
    floors at ``steps=1`` (the cheapest valid search): the service
    always answers, it never refuses a query at admission time."""

    ms: float = 1.0
    max_steps: int = 12
    termination: Termination = Termination()


@dataclasses.dataclass(frozen=True)
class ResolvedPlan:
    """The concrete schedule a policy resolved to: what the dispatch
    runs, what the result cache keys on, and what batches group by."""

    r0: float
    steps: int
    termination: Termination | None = None


def resolve_policy(*candidates):
    """First non-``None`` of (request, collection, service) — the same
    three-level precedence as the store layer's engine resolution."""
    for c in candidates:
        if c is not None:
            return c
    return None


#: provenance names for the three resolution rungs, by candidate index;
#: past the end (all ``None``) the plan came from the service's raw
#: (r0, steps) with no policy at all.
POLICY_SOURCES = ("request", "collection", "service")


def resolve_policy_with_source(*candidates):
    """Like :func:`resolve_policy` but also names the rung that won —
    ``(policy, "request"|"collection"|"service")``, or
    ``(None, "default")`` when no rung supplied a policy.  This is what
    the EXPLAIN path records as the plan-resolution chain."""
    for c, source in zip(candidates, POLICY_SOURCES):
        if c is not None:
            return c, source
    return None, "default"


# --------------------------------------------------------------- persistence
_POLICY_TYPES = {
    "FixedSchedule": FixedSchedule,
    "RecallTarget": RecallTarget,
    "LatencyBudget": LatencyBudget,
}


def policy_to_dict(policy) -> dict | None:
    """JSON-able form for snapshot metadata (None passes through)."""
    if policy is None:
        return None
    d = dataclasses.asdict(policy)
    return {"type": type(policy).__name__, **d}


def policy_from_dict(d: dict | None):
    if d is None:
        return None
    d = dict(d)
    cls = _POLICY_TYPES[d.pop("type")]
    t = d.get("termination")
    if t is not None:
        d["termination"] = Termination(**t)
    return cls(**d)
