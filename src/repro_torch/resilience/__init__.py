"""repro_torch.resilience — fault injection, degradation, and recovery.

The robustness layer for the serving + persistence stack:

* ``faults``      — deterministic, seedable :class:`FaultPlan` with
  named injection sites threaded (behind a no-op default) through the
  checkpointer, the service dispatch path, and sharded search:
  ``snapshot.write.torn@<byte>``, ``snapshot.write.crash@<stage>``,
  ``snapshot.read.corrupt``, ``dispatch.raise``, ``dispatch.delay_ms``,
  ``shard.straggle``.
* ``degrade``     — :class:`BrownoutController`: consumes ``SLOWatch``
  check outcomes and walks the degradation ladder (cap termination
  steps → force FixedSchedule → shed lowest-weight tenants), flagging
  every touched ticket ``degraded=True`` and healing automatically.
* ``stragglers``  — the EWMA :class:`StragglerMonitor`, shared by the
  training supervisor (``runtime.fault_tolerance`` re-exports it) and
  the service's per-collection batch-duration watch.

Contracts: DESIGN.md §11.  The reference's chaos benchmark
(``benchmarks/store_throughput.py --chaos``) has no port yet.
"""

from .degrade import BrownoutController
from .faults import (
    SNAPSHOT_CRASH_STAGES,
    SNAPSHOT_WRITE_SITES,
    FaultError,
    FaultPlan,
    FaultSpec,
    SimulatedCrash,
)
from .stragglers import StragglerMonitor

__all__ = [
    "BrownoutController",
    "FaultError",
    "FaultPlan",
    "FaultSpec",
    "SNAPSHOT_CRASH_STAGES",
    "SNAPSHOT_WRITE_SITES",
    "SimulatedCrash",
    "StragglerMonitor",
    "faults",
]

from . import faults  # noqa: E402  (the module itself is part of the API)
