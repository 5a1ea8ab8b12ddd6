"""repro_torch.tune — adaptive termination and recall-target query planning.

The subsystem that makes the serving story match the paper's central
claim: DB-LSH's window radius is *query-driven*, growing until the
terminate conditions fire, while a production batch wants lockstep
shapes.  ``tune`` reconciles the two:

* ``adaptive``  — per-query C1/C2 termination inside the one-pass
  serving pipeline (``done`` masks on the delta merges + a batch-wide
  early exit; the mechanism lives in ``core.serve_search.Termination``,
  this module is its API surface and stats-analysis toolkit).
* ``planner``   — offline calibration of a per-collection schedule
  table (r0 anchored to the data's NN-distance scale; per-length
  expected recall / slot cost / measured latency) and the policy → plan
  resolution.
* ``policy``    — outcome-level policies (``RecallTarget``,
  ``LatencyBudget``, ``FixedSchedule``) with request > collection >
  service resolution, mirroring the store layer's engine defaults.

Integration points: ``core.serve_search.search_batch_fixed(...,
termination=)`` (all three verify engines) and ``store.Collection``
(``search_policy`` + persisted calibration).  Contracts: DESIGN.md §8.
"""

from .adaptive import (
    Termination,
    certified_c2_mask,
    search_batch_adaptive,
    termination_radii,
    termination_step_histogram,
)
from .planner import ScheduleTable, calibrate, plan
from .policy import (
    FixedSchedule,
    LatencyBudget,
    POLICY_SOURCES,
    RecallTarget,
    ResolvedPlan,
    policy_from_dict,
    policy_to_dict,
    resolve_policy,
    resolve_policy_with_source,
)

__all__ = [
    "FixedSchedule",
    "LatencyBudget",
    "POLICY_SOURCES",
    "RecallTarget",
    "ResolvedPlan",
    "ScheduleTable",
    "Termination",
    "calibrate",
    "certified_c2_mask",
    "plan",
    "policy_from_dict",
    "policy_to_dict",
    "resolve_policy",
    "resolve_policy_with_source",
    "search_batch_adaptive",
    "termination_radii",
    "termination_step_histogram",
]
