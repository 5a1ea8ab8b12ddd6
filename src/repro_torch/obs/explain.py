"""Per-query EXPLAIN ANALYZE for the serving stack.

DB-LSH is *query-based* by construction — every query gets its own
hypercubic buckets, schedule, and C1/C2 termination point — yet the
aggregate observability of ``repro_torch.obs`` (histograms, step pmfs, breach
counters) cannot name a single offending query.  This module is the
database-style answer:

* :class:`QueryExplain` — the structured record a ``submit(...,
  explain=True)`` ticket carries once served: the plan-resolution chain
  (request > collection > service policy → ``ResolvedPlan``), engine
  choice, cache outcome + key, queue wait / batch seq / ring slot, the
  per-step window halfwidths and admitted-delta slot counts the device
  measured, which terminate condition fired (C1 budget, C2
  certification, schedule exhaustion — or a host-side deadline
  re-plan), the final certified radius, per-shard attribution on the
  sharded path, and resilience annotations (degraded, brownout level,
  retries, fault sites hit).  ``render()`` is the human-readable text
  block; ``to_dict()`` the JSON artifact shape.

* :class:`ExemplarReservoir` — a bounded tail-latency exemplar store:
  every served ticket's (latency, uid) lands in its latency bucket's
  small ring, and sampled tickets keep their full :class:`QueryExplain`.
  ``worst(k)`` walks buckets from the tail down, which is exactly what
  :class:`~repro_torch.obs.slo.SLOWatch` attaches to a latency breach — a p99
  breach then *names actual queries* and their step/slot story instead
  of saying "re-calibrate" into the void.

Per-query records are the input feed an online self-tuning loop
needs: (certified radius, termination step, admitted-slot) triples per
served query, ground-truth-free.

Overhead contract: explain'd requests run ``search_batch_fixed`` with
``with_explain=True`` and batch separately, so the explain=False path
is bit-equal to a build without this module.
"""

from __future__ import annotations

import dataclasses
import json
from bisect import bisect_left
from collections import OrderedDict, deque

from .metrics import LATENCY_MS_BUCKETS

__all__ = [
    "DEFAULT_EXPLAIN_SAMPLE_RATE",
    "ExemplarReservoir",
    "QueryExplain",
    "TERM_CAUSE_NAMES",
]

#: names for the device-side terminate-cause codes
#: (``repro_torch.core.serve_search.TERM_*``), plus the host-side outcomes the
#: scheduler can impose before the device ever sees the query.
TERM_CAUSE_NAMES = {
    0: "schedule_exhausted",
    1: "c1_budget",
    2: "c2_certified",
}

#: recommended auto-explain sampling: 1 in 64 submitted requests.  Rare
#: enough that the split-off explain batches hold the ≤5% QPS overhead
#: budget (DESIGN.md §12; gated by ``store_throughput.py --obs``), while
#: a latency breach window almost surely contains sampled exemplars.
#: Auto-sampling is opt-in — arm it with
#: ``Observability(explain_sample_rate=DEFAULT_EXPLAIN_SAMPLE_RATE)``;
#: ``submit(..., explain=True)`` always works regardless.
DEFAULT_EXPLAIN_SAMPLE_RATE = 1.0 / 64.0


@dataclasses.dataclass
class QueryExplain:
    """EXPLAIN ANALYZE record for one served query.

    Device-measured fields (``step_half`` … ``final_radius``) come from
    the ``with_explain`` arrays of ``search_batch_fixed`` /
    ``search_sharded``; everything else is host-side provenance the
    scheduler stamps while the ticket moves through admission, the
    queue, the in-flight ring, and completion."""

    uid: int
    collection: str
    tenant: str = "default"
    # ---------------------------------------------------- plan resolution
    engine: str = "torch"
    plan_r0: float = 1.0
    plan_steps: int = 0
    plan_termination: str | None = None  # repr of the Termination, if any
    plan_source: str = "default"  # "request" | "collection" | "service" |
                                  # "default" (no policy anywhere)
    plan_policy: str | None = None  # repr of the winning policy
    plan_table: bool = False        # resolved against a calibration table
    replanned: str | None = None    # "deadline" | "brownout" when the
                                    # scheduler cut the schedule after
                                    # resolution (ticket flags degraded)
    # ------------------------------------------------------- cache / queue
    cache_outcome: str = "miss"  # "bypass" (explain'd reads skip the
                                 # cache), "miss", or "uncached"
    cache_key: str | None = None
    queue_wait_ms: float = 0.0
    batch_seq: int = -1   # monotonic batch number (trace correlation)
    ring_slot: int = -1   # in-flight ring lane = TID_RING0 + ring_slot
    batch_rows: int = 0   # real queries in the batch
    batch_shape: int = 0  # padded dispatch shape
    # ------------------------------------------------- device measurements
    steps_run: int = 0
    candidates: int = 0
    term_cause: str = "schedule_exhausted"
    final_radius: float = 0.0
    step_half: list = dataclasses.field(default_factory=list)
    step_slots: list = dataclasses.field(default_factory=list)
    # per-shard attribution (sharded placement only): parallel lists,
    # one entry per shard, measured before the pmax/psum collapse
    shard_steps: list | None = None
    shard_slots: list | None = None
    shard_cause: list | None = None
    # ---------------------------------------------------------- resilience
    degraded: bool = False
    brownout_level: int = 0
    retries: int = 0
    fault_sites: list = dataclasses.field(default_factory=list)
    # ------------------------------------------------------------- outcome
    latency_ms: float = 0.0
    traced: bool = False  # uid doubles as the Perfetto async-span id

    @property
    def cum_slots(self) -> list:
        """Cumulative verified slots by step (prefix sums of
        ``step_slots``)."""
        out, acc = [], 0
        for s in self.step_slots:
            acc += int(s)
            out.append(acc)
        return out

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["cum_slots"] = self.cum_slots
        return d

    def render(self) -> str:
        """The human-readable EXPLAIN ANALYZE block (one query)."""
        lines = [
            f"EXPLAIN query uid={self.uid} collection={self.collection!r} "
            f"tenant={self.tenant!r}",
            f"  plan: r0={self.plan_r0:g} steps={self.plan_steps} "
            f"engine={self.engine} source={self.plan_source}"
            + (f" policy={self.plan_policy}" if self.plan_policy else "")
            + (" table=calibrated" if self.plan_table else "")
            + (f" termination={self.plan_termination}"
               if self.plan_termination else ""),
        ]
        if self.replanned:
            lines.append(f"  replanned: {self.replanned} (degraded)")
        lines.append(
            f"  cache: {self.cache_outcome}"
            + (f" key={self.cache_key}" if self.cache_key else "")
        )
        lines.append(
            f"  queue: wait={self.queue_wait_ms:.3f}ms "
            f"batch=#{self.batch_seq} ring_slot={self.ring_slot} "
            f"rows={self.batch_rows}/{self.batch_shape}"
        )
        cum = self.cum_slots
        for j, (half, slots) in enumerate(zip(self.step_half,
                                              self.step_slots)):
            ran = j < self.steps_run
            mark = "*" if ran else " "
            lines.append(
                f"  {mark} step {j + 1}: half_window={half:.4f} "
                f"admitted_slots=+{int(slots)} cum={cum[j]}"
                + ("" if ran else "  (not reached)")
            )
        lines.append(
            f"  terminated: {self.term_cause} at step {self.steps_run} "
            f"(certified radius {self.final_radius:.4f}, "
            f"{self.candidates} verified slots)"
        )
        if self.shard_steps is not None:
            per = ", ".join(
                f"shard{i}: steps={int(st)} slots={int(sl)} "
                f"cause={TERM_CAUSE_NAMES.get(int(ca), str(ca))}"
                for i, (st, sl, ca) in enumerate(
                    zip(self.shard_steps, self.shard_slots,
                        self.shard_cause)
                )
            )
            lines.append(f"  shards: {per}")
        flags = []
        if self.degraded:
            flags.append("degraded")
        if self.brownout_level:
            flags.append(f"brownout_level={self.brownout_level}")
        if self.retries:
            flags.append(f"retries={self.retries}")
        if self.fault_sites:
            flags.append(f"fault_sites={sorted(set(self.fault_sites))}")
        if flags:
            lines.append("  resilience: " + " ".join(flags))
        lines.append(
            f"  latency: {self.latency_ms:.3f}ms"
            + ("  (trace: async span id "
               f"{self.uid})" if self.traced else "")
        )
        return "\n".join(lines)


class ExemplarReservoir:
    """Tail-latency exemplars: sampled ticket ids per latency bucket,
    full explains for the sampled tail.

    ``record`` is O(1): the (latency, uid) pair lands in its bucket's
    bounded ring, and when the ticket carries a :class:`QueryExplain`
    the record is kept in a bounded LRU so ``worst(k)`` can attach the
    *rendered* explain to an SLO breach.  Buckets reuse the latency
    histogram's upper bounds so an exemplar is always findable from the
    bucket its observation counted in."""

    def __init__(self, buckets=LATENCY_MS_BUCKETS, per_bucket: int = 8,
                 max_explains: int = 256):
        self.buckets = tuple(float(b) for b in buckets)
        self.per_bucket = int(per_bucket)
        self.max_explains = int(max_explains)
        # one ring per bucket (+inf tail last): (latency_ms, uid,
        # collection) triples, newest kept
        self._rings: list[deque] = [
            deque(maxlen=self.per_bucket)
            for _ in range(len(self.buckets) + 1)
        ]
        self._explains: OrderedDict[int, QueryExplain] = OrderedDict()

    def record(self, latency_ms: float, uid: int, collection: str,
               explain: QueryExplain | None = None) -> None:
        self._rings[bisect_left(self.buckets, latency_ms)].append(
            (float(latency_ms), int(uid), collection)
        )
        if explain is not None:
            self._explains[int(uid)] = explain
            self._explains.move_to_end(int(uid))
            while len(self._explains) > self.max_explains:
                self._explains.popitem(last=False)

    def explain_for(self, uid: int) -> QueryExplain | None:
        return self._explains.get(int(uid))

    def worst(self, k: int = 3, collection: str | None = None,
              with_explain_only: bool = False) -> list[dict]:
        """The ``k`` worst-latency exemplars, tail bucket first.

        Returns ``{"uid", "latency_ms", "collection", "explain"}`` dicts
        (``explain`` is the :class:`QueryExplain` or ``None``).  With
        ``with_explain_only`` exemplars without a stored explain are
        skipped — the SLO watch prefers a rendered story over a bare
        uid, falling back to bare uids only when nothing was sampled."""
        out = []
        for ring in reversed(self._rings):
            for lat, uid, col in sorted(ring, reverse=True):
                if collection is not None and col != collection:
                    continue
                ex = self._explains.get(uid)
                if with_explain_only and ex is None:
                    continue
                out.append({
                    "uid": uid, "latency_ms": lat, "collection": col,
                    "explain": ex,
                })
                if len(out) >= k:
                    return out
        return out

    def explains(self) -> list[QueryExplain]:
        """Every stored explain, oldest first (bounded by
        ``max_explains``)."""
        return list(self._explains.values())

    def to_json(self) -> dict:
        """The sampled-explains artifact shape (benchmark / CI upload)."""
        return {
            "exemplars": [
                {"bucket_le": ("+Inf" if i == len(self.buckets)
                               else self.buckets[i]),
                 "uid": uid, "latency_ms": lat, "collection": col}
                for i, ring in enumerate(self._rings)
                for lat, uid, col in ring
            ],
            "explains": [e.to_dict() for e in self._explains.values()],
        }

    def export_json(self, path: str) -> int:
        """Write :meth:`to_json`; returns the number of stored
        explains."""
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2)
        return len(self._explains)
