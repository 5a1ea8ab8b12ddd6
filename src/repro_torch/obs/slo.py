"""SLO drift watch: turn the metrics registry into breach events.

Consumes the registry the serving stack already feeds (latency
histograms, termination-step counters) and emits structured
:class:`BreachEvent` records when the served traffic leaves its
objectives:

* **latency** — rolling p50 / p99 over the latency histogram's exact
  sample window vs configured ceilings;
* **recall proxy (drift)** — the paper's C1/C2 termination makes
  per-query work observable: each query reports the schedule step its
  terminate condition fired at.  The calibrated
  :class:`~repro_torch.tune.planner.ScheduleTable` *predicts* that
  distribution (the recall curve is, normalized, the fraction of sample
  queries already certified by step j), so the total-variation distance
  between the rolling observed termination-step distribution and the
  table's prediction is a recall drift signal that needs **no ground
  truth at serving time**.  When the workload hardens (queries terminate
  later than calibration predicted) or the index decays (compaction
  debt, distribution shift), the divergence grows before recall can be
  measured — exactly the trigger an online re-calibration loop
  needs.

The watch is pull-based and deterministic: :meth:`SLOWatch.check` reads
the registry with an injectable clock (tests script a drift and assert
the breach), :meth:`SLOWatch.maybe_check` rate-limits it for serving
loops.  Breaches append to :attr:`SLOWatch.events` (bounded), count in
the registry (``repro_store_slo_breaches_total``), mark the trace
timeline, and invoke an optional callback.

When an :class:`~repro_torch.obs.explain.ExemplarReservoir` is attached
(``exemplars=``), each breach additionally carries the worst-k
tail-latency exemplars in ``detail["exemplars"]`` — ticket uid, latency,
and (for sampled/explain'd queries) the *rendered*
:class:`~repro_torch.obs.explain.QueryExplain` — so a p99 page names actual
queries and their per-step window/slot story, not just a percentile.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque

from .metrics import MetricsRegistry
from .trace import Tracer, get_tracer

__all__ = ["BreachEvent", "SLOWatch", "expected_step_pmf"]


@dataclasses.dataclass(frozen=True)
class BreachEvent:
    """One SLO violation observed at ``t`` (watch-clock seconds)."""

    kind: str          # "latency_p50" | "latency_p99" | "termination_drift"
    collection: str
    t: float
    observed: float    # the measured value (ms, or TV distance)
    threshold: float   # the objective it crossed
    detail: dict       # supporting numbers (window size, distributions)
    message: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def expected_step_pmf(table, steps: int | None = None) -> dict[int, float]:
    """The schedule table's predicted termination-step distribution.

    ``recall[j-1]`` estimates the fraction of queries whose true
    neighbors are already in hand after ``j`` steps; normalized by the
    final achieved recall it is the predicted CDF of the C2 certificate
    firing.  Queries the schedule never certifies run to the end and
    record the final step, which normalization folds into the last bin.
    ``steps`` caps the support when the plan runs a shorter schedule
    than the table measured (mass beyond folds into the cap)."""
    rec = list(table.recall)
    s_max = len(rec) if steps is None else max(1, min(int(steps), len(rec)))
    total = rec[s_max - 1]
    if not math.isfinite(total) or total <= 0:
        return {j: 1.0 / s_max for j in range(1, s_max + 1)}  # no signal
    pmf = {}
    prev = 0.0
    for j in range(1, s_max + 1):
        cur = min(rec[j - 1] / total, 1.0)
        pmf[j] = max(cur - prev, 0.0)
        prev = cur
    # normalization put all residual (never-certified) mass in the tail
    pmf[s_max] += max(1.0 - prev, 0.0)
    return pmf


def _tv_distance(p: dict[int, float], q: dict[int, float]) -> float:
    keys = set(p) | set(q)
    return 0.5 * sum(abs(p.get(k, 0.0) - q.get(k, 0.0)) for k in keys)


class SLOWatch:
    """Rolling SLO evaluation over one collection's registry series.

    Objectives are opt-in: pass ``latency_p50_ms`` / ``latency_p99_ms``
    ceilings and/or a calibrated ``table`` (+ ``drift_threshold``) to
    arm the corresponding checks.  ``window_s`` bounds the rolling
    termination window; ``min_samples`` suppresses verdicts on thin
    evidence."""

    def __init__(
        self,
        registry: MetricsRegistry,
        collection: str,
        *,
        table=None,
        plan_steps: int | None = None,
        latency_p50_ms: float | None = None,
        latency_p99_ms: float | None = None,
        drift_threshold: float = 0.25,
        min_samples: int = 32,
        window_s: float = 60.0,
        check_interval_s: float = 1.0,
        max_events: int = 256,
        clock=time.monotonic,
        tracer: Tracer | None = None,
        on_breach=None,
        on_check=None,
        exemplars=None,
        exemplar_k: int = 3,
    ):
        self.registry = registry
        self.collection = collection
        self.table = table
        self.plan_steps = plan_steps
        self.latency_p50_ms = latency_p50_ms
        self.latency_p99_ms = latency_p99_ms
        self.drift_threshold = drift_threshold
        self.min_samples = min_samples
        self.window_s = window_s
        self.check_interval_s = check_interval_s
        self.clock = clock
        self.tracer = tracer if tracer is not None else get_tracer()
        self.on_breach = on_breach
        # unlike on_breach (fired per event), on_check sees every check's
        # full outcome — `([], now)` for a clean window — which is what a
        # consumer that must *heal* (resilience.BrownoutController) needs
        self.on_check = on_check
        # tail-latency exemplar reservoir (repro_torch.obs.explain): breaches
        # attach the worst-k sampled tickets with rendered explains
        self.exemplars = exemplars
        self.exemplar_k = exemplar_k
        self.events: deque[BreachEvent] = deque(maxlen=max_events)
        self._breaches = registry.counter(
            "repro_store_slo_breaches_total", "SLO breach events by kind"
        )
        self._drift_gauge = registry.gauge(
            "repro_store_termination_drift",
            "TV distance: observed vs calibrated termination-step pmf",
        )
        self._snapshots: deque[tuple[float, dict[int, int]]] = deque()
        self._last_check: float | None = None

    # ------------------------------------------------------------ readings
    def _step_counts(self) -> dict[int, int]:
        fam = self.registry.get("repro_store_termination_steps_total")
        if fam is None:
            return {}
        out = {}
        for labels, v in fam.series():
            if labels.get("collection") == self.collection:
                out[int(labels["step"])] = int(v)
        return out

    def observed_step_pmf(self, now: float) -> tuple[dict[int, float], int]:
        """Rolling-window termination distribution: the cumulative step
        counters now minus their oldest in-window snapshot."""
        cur = self._step_counts()
        self._snapshots.append((now, dict(cur)))
        while len(self._snapshots) > 1 and \
                self._snapshots[1][0] <= now - self.window_s:
            self._snapshots.popleft()
        base = self._snapshots[0][1]
        delta = {
            s: cur.get(s, 0) - base.get(s, 0)
            for s in set(cur) | set(base)
        }
        total = sum(max(v, 0) for v in delta.values())
        if total == 0:
            return {}, 0
        return {s: max(v, 0) / total for s, v in delta.items() if v > 0}, total

    # ------------------------------------------------------------- checking
    def _emit(self, kind: str, now: float, observed: float, threshold: float,
              detail: dict, message: str) -> BreachEvent:
        if self.exemplars is not None:
            # prefer sampled exemplars whose full explain is in hand; fall
            # back to bare (uid, latency) pairs only when nothing sampled
            worst = self.exemplars.worst(
                self.exemplar_k, collection=self.collection,
                with_explain_only=True,
            ) or self.exemplars.worst(
                self.exemplar_k, collection=self.collection
            )
            detail = dict(
                detail,
                exemplars=[
                    {
                        "uid": w["uid"],
                        "latency_ms": w["latency_ms"],
                        "explain": (
                            None if w["explain"] is None
                            else w["explain"].to_dict()
                        ),
                        "rendered": (
                            None if w["explain"] is None
                            else w["explain"].render()
                        ),
                    }
                    for w in worst
                ],
            )
        ev = BreachEvent(
            kind=kind, collection=self.collection, t=now, observed=observed,
            threshold=threshold, detail=detail, message=message,
        )
        self.events.append(ev)
        self._breaches.inc(collection=self.collection, kind=kind)
        self.tracer.instant(
            f"slo.breach.{kind}", cat="slo", collection=self.collection,
            t=now, observed=observed, threshold=threshold,
        )
        if self.on_breach is not None:
            self.on_breach(ev)
        return ev

    def check(self, now: float | None = None) -> list[BreachEvent]:
        """Evaluate every armed objective once; returns the new breaches
        (also appended to :attr:`events`)."""
        now = self.clock() if now is None else now
        self._last_check = now
        out: list[BreachEvent] = []

        lat = self.registry.get("repro_store_latency_ms")
        if lat is not None and (
            self.latency_p50_ms is not None or self.latency_p99_ms is not None
        ):
            n = lat.count(collection=self.collection)
            if n >= self.min_samples:
                p50, p99 = lat.percentile(
                    [50.0, 99.0], collection=self.collection
                )
                for kind, obs, thr in (
                    ("latency_p50", float(p50), self.latency_p50_ms),
                    ("latency_p99", float(p99), self.latency_p99_ms),
                ):
                    if thr is not None and obs > thr:
                        out.append(self._emit(
                            kind, now, obs, thr, {"samples": n},
                            f"{self.collection}: {kind.split('_')[1]} "
                            f"{obs:.2f}ms > {thr:.2f}ms over last {n} queries",
                        ))

        if self.table is not None:
            obs_pmf, n = self.observed_step_pmf(now)
            if n >= self.min_samples:
                exp_pmf = expected_step_pmf(self.table, self.plan_steps)
                tv = _tv_distance(obs_pmf, exp_pmf)
                self._drift_gauge.set(tv, collection=self.collection)
                if tv > self.drift_threshold:
                    out.append(self._emit(
                        "termination_drift", now, tv, self.drift_threshold,
                        {"samples": n, "observed_pmf": obs_pmf,
                         "expected_pmf": exp_pmf},
                        f"{self.collection}: termination-step distribution "
                        f"drifted TV={tv:.3f} > {self.drift_threshold:.3f} "
                        f"from the calibrated prediction over {n} queries — "
                        "re-calibrate",
                    ))
        if self.on_check is not None:
            self.on_check(out, now)
        return out

    def maybe_check(self, now: float | None = None) -> list[BreachEvent]:
        """Rate-limited :meth:`check` for serving loops (at most one
        evaluation per ``check_interval_s``)."""
        now = self.clock() if now is None else now
        if self._last_check is not None and \
                now - self._last_check < self.check_interval_s:
            return []
        return self.check(now)
