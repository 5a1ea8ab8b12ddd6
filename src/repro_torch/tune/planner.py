"""Offline schedule calibration: measure once, plan every query after.

DB-LSH's radius schedule has two free knobs — the initial radius ``r0``
and the schedule length ``steps`` — and both are properties of the
*collection* (its distance scale, its density), not of the query.  The
calibrator probes a held-out query sample against the index and fits a
:class:`ScheduleTable`: for every schedule length ``j = 1..steps_max``,
the expected recall@k (against a brute-force oracle on the sample), the
mean verified-slot cost, and optionally the measured per-query latency.

With a table in hand, :func:`plan` resolves an outcome-level policy
(:mod:`repro_torch.tune.policy`) into the concrete
:class:`~repro.tune.policy.ResolvedPlan` the dispatch runs:

* ``RecallTarget(0.95)`` → the *shortest* calibrated schedule whose
  expected recall meets the target (adaptive termination rides along so
  easy queries still exit earlier than the planned worst case);
* ``LatencyBudget(ms)`` → the *longest* schedule whose measured
  per-query latency fits;
* ``FixedSchedule(...)`` → passthrough (no table needed).

**r0 derivation.**  When not given, ``r0`` comes from the sample's true
NN distances: ``r0 = q10(nn) / c``.  The first probe then lands just
under the easy decile's NN distance, so C2 (k-th ≤ c·r) can fire within
a step or two for easy queries, while ``steps_max`` radii of geometric
growth still cover the hard tail.  This is the "query-based" part of
the paper made operational: the schedule is anchored to the data's
distance scale instead of a hand-picked constant.

**Contract.**  Calibration is advisory, never load-bearing for
correctness: a plan only chooses (r0, steps, termination), and every
choice is a valid search.  Tables are sampled estimates — recall on
future queries is expected, not guaranteed; re-calibrate after heavy
updates (compaction changes K/L and block geometry).  Tables serialize
to plain dicts and ride in collection snapshots
(:meth:`repro_torch.store.Collection.snapshot`).

The port runs on the index's device: the oracle, the probes and the
timings all run where the index lies, and a timing waits for the card
(``torch.cuda.synchronize``) before it reads the clock.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..core import brute_force, search_batch_fixed
from ..device import as_tensor
from .policy import (
    FixedSchedule,
    LatencyBudget,
    RecallTarget,
    ResolvedPlan,
)

__all__ = ["ScheduleTable", "calibrate", "plan"]


@dataclasses.dataclass(frozen=True)
class ScheduleTable:
    """Per-collection calibration: schedule length -> expected outcome.

    Entry ``j`` (0-based) describes the schedule of length ``j + 1``
    starting at ``r0``: ``recall[j]`` expected recall@k on the sample,
    ``cost_slots[j]`` mean verified candidate slots per query (the
    ``with_stats`` candidates counter), ``cost_ms[j]`` measured mean
    per-query milliseconds (``nan`` when not measured)."""

    r0: float
    c: float
    k: int
    recall: tuple[float, ...]
    cost_slots: tuple[float, ...]
    cost_ms: tuple[float, ...]
    n_sample: int

    @property
    def max_steps(self) -> int:
        return len(self.recall)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ScheduleTable":
        return cls(
            r0=float(d["r0"]), c=float(d["c"]), k=int(d["k"]),
            recall=tuple(float(x) for x in d["recall"]),
            cost_slots=tuple(float(x) for x in d["cost_slots"]),
            cost_ms=tuple(float(x) for x in d["cost_ms"]),
            n_sample=int(d["n_sample"]),
        )


def _np(x) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _sync(device: torch.device) -> None:
    """Wait for the card's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _recall_at(ids, gt_ids, k: int) -> float:
    ids = _np(ids)[:, :k]
    gt = _np(gt_ids)[:, :k]
    return float(np.mean([
        len(set(a.tolist()) & set(b.tolist())) / k for a, b in zip(ids, gt)
    ]))


def derive_r0(nn_dists, c: float, quantile: float = 0.10) -> float:
    """Data-scale initial radius: the sample NN-distance ``quantile``
    divided by ``c`` (see module doc)."""
    nn = _np(nn_dists).astype(np.float64).reshape(-1)
    nn = nn[np.isfinite(nn) & (nn > 0)]
    if nn.size == 0:
        return 1.0
    return float(max(np.quantile(nn, quantile) / c, 1e-6))


def calibrate(
    index,
    queries,
    *,
    k: int = 0,
    r0: float | None = None,
    steps_max: int = 8,
    engine: str = "torch",
    measure_ms: bool = False,
    repeats: int = 2,
    search_fn=None,
    oracle_rows=None,
    oracle_ids=None,
) -> ScheduleTable:
    """Probe ``queries`` (m, d) against ``index`` and fit the table.

    One fixed-schedule search per length ``1..steps_max`` (keep the
    sample small; tens of queries estimate recall to a few points, which
    is all planning needs).
    ``measure_ms=True`` additionally times each length (min over
    ``repeats`` post-warmup runs) so :class:`LatencyBudget` can plan.

    ``search_fn(Q, r0, steps, with_stats=False)`` overrides the dispatch
    (default: ``search_batch_fixed`` on ``index``) so non-local
    placements calibrate through their own search path — e.g. a sharded
    collection probes ``search_sharded`` while ``index`` still supplies
    the params and the (global) data for the brute-force oracle.

    ``oracle_rows`` restricts the brute-force ground truth to the rows
    the search can actually return.  Without it a mutated index
    under-measures: tombstoned rows — including the per-shard dead
    replicas a sharded insert leaves behind at identical coordinates —
    would occupy ground-truth top-k slots no search result can ever
    match.  ``oracle_ids`` (same length) supplies the id each oracle row
    is *returned as* when the search's id space is not the data-row
    space — e.g. strided sharded gids — so recall overlap compares like
    with like; it defaults to ``oracle_rows`` (dense layouts, where row
    index == id).
    """
    p = index.params
    k = k or p.k
    dev = index.device
    Q = as_tensor(queries, dev)
    if search_fn is None:
        def search_fn(Qs, r0, steps, with_stats=False):
            return search_batch_fixed(
                index, Qs, k=k, r0=r0, steps=steps, engine=engine,
                with_stats=with_stats, device=dev,
            )

    if oracle_rows is None:
        gt_d, gt_i = brute_force(index.data, Q, k=k, device=dev)
    else:
        rows = as_tensor(_np(oracle_rows), dev, torch.int64)
        gt_d, gt_i = brute_force(index.data[rows], Q, k=k, device=dev)
        ids_src = (
            rows if oracle_ids is None
            else as_tensor(_np(oracle_ids), dev, torch.int64)
        )
        gt_i = ids_src[gt_i]
    if r0 is None:
        r0 = derive_r0(_np(gt_d)[:, 0], p.c)

    recalls, slots, ms = [], [], []
    for j in range(1, steps_max + 1):
        _, ids, stats = search_fn(Q, r0, j, with_stats=True)
        _sync(dev)
        recalls.append(_recall_at(ids, gt_i, k))
        slots.append(float(_np(stats["candidates"]).mean()))
        if measure_ms:
            best = np.inf
            for _ in range(max(1, repeats)):
                t0 = time.perf_counter()
                search_fn(Q, r0, j)
                _sync(dev)
                best = min(best, time.perf_counter() - t0)
            ms.append(best * 1e3 / Q.shape[0])
        else:
            ms.append(float("nan"))

    return ScheduleTable(
        r0=float(r0), c=float(p.c), k=k,
        recall=tuple(recalls), cost_slots=tuple(slots), cost_ms=tuple(ms),
        n_sample=int(Q.shape[0]),
    )


def plan(
    table: ScheduleTable | None,
    policy,
    *,
    default_r0: float = 1.0,
    default_steps: int = 8,
) -> ResolvedPlan:
    """Resolve ``policy`` against ``table`` into a concrete plan.

    ``policy=None`` and ``FixedSchedule`` need no table.  ``RecallTarget``
    without a table degrades safely to the default schedule capped at
    ``max_steps`` — adaptive termination still trims easy queries, so the
    fallback can only over-probe, never under-recall vs the default.
    ``LatencyBudget`` raises without a measured table: guessing device
    speed would silently violate the budget it exists to honor.  With a
    measured table whose cheapest length still misses the budget, it
    floors at ``steps=1`` — the service always answers a query it
    admitted.
    """
    if policy is None:
        return ResolvedPlan(r0=default_r0, steps=default_steps)

    if isinstance(policy, FixedSchedule):
        return ResolvedPlan(
            r0=default_r0 if policy.r0 is None else float(policy.r0),
            steps=default_steps if policy.steps is None else int(policy.steps),
            termination=policy.termination,
        )

    if isinstance(policy, RecallTarget):
        if table is None:
            return ResolvedPlan(
                r0=default_r0,
                steps=max(1, min(default_steps, policy.max_steps)),
                termination=policy.termination,
            )
        steps = None
        for j, rec in enumerate(table.recall):
            if rec >= policy.recall:
                steps = j + 1
                break
        if steps is None:
            steps = table.max_steps  # best the calibration achieved
        return ResolvedPlan(
            r0=table.r0,
            steps=min(steps, policy.max_steps),
            termination=policy.termination,
        )

    if isinstance(policy, LatencyBudget):
        if table is None or not any(np.isfinite(m) for m in table.cost_ms):
            raise ValueError(
                "LatencyBudget needs a calibration table measured with "
                "measure_ms=True (Collection.calibrate(..., measure_ms=True))"
            )
        steps = 0
        for j, m in enumerate(table.cost_ms):
            if np.isfinite(m) and m <= policy.ms:
                steps = j + 1
        steps = max(1, min(steps or 1, policy.max_steps))
        return ResolvedPlan(
            r0=table.r0, steps=steps, termination=policy.termination,
        )

    raise TypeError(f"unknown policy {policy!r}")
