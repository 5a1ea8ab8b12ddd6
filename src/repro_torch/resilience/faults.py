"""Deterministic fault injection: named sites, seedable plans, no-op default.

Production failure modes — torn snapshot writes, bit-rot on restore,
dispatch exceptions, latency spikes, straggling shards — are rare by
design, which makes the *recovery* code the least-tested code in the
stack.  This module turns them into first-class, scriptable events: the
instrumented layers (``checkpoint.checkpointer``, ``store.service``,
``store.router``, ``store.lifecycle``) call :func:`fire` at **named
injection sites**, and a :class:`FaultPlan` installed via
:func:`active` decides, deterministically, which hits do what.  With no
plan installed every site is a single ``None`` check — the default path
stays a no-op and the serving stack is bit-equal to a build without
this module (pinned in ``tests/test_torch_resilience.py``).

Sites (the injection vocabulary):

=========================  ==================================================
``snapshot.write.torn``    truncate the in-flight snapshot file at a byte
                           offset (``arg``) and crash — a torn write
``snapshot.write.crash``   crash the snapshot writer between file
                           operations; ``stage`` ctx selects the kill point
                           (:data:`SNAPSHOT_CRASH_STAGES`)
``snapshot.read.corrupt``  flip a byte (offset ``arg``) in the bytes a
                           restore just read — bit-rot / torn read
``dispatch.raise``         raise :class:`FaultError` in the service's issue
                           stage (``transient`` controls retryability)
``dispatch.delay_ms``      sleep ``arg * ctx[scale]`` milliseconds in the
                           issue stage — an injected latency spike that
                           scales with the schedule the batch runs
``shard.straggle``         same delay, fired from the sharded search path —
                           one slow shard holding the merge hostage
=========================  ==================================================

A plan is a list of :class:`FaultSpec` triggers.  Each spec counts *its
own* matching hits: ``at`` skips the first ``at`` hits, ``count`` fires
for the next ``count`` (``math.inf`` = forever), and keyword filters
must equal the ctx the site reports (``plan.add("snapshot.write.torn",
file="arr_0.npy", arg=128)``).  Everything a plan does is recorded in
``plan.fired`` so tests and the chaos benchmark can assert the script
actually ran.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

__all__ = [
    "FaultError",
    "FaultPlan",
    "FaultSpec",
    "SNAPSHOT_CRASH_STAGES",
    "SNAPSHOT_WRITE_SITES",
    "SimulatedCrash",
    "active",
    "active_plan",
    "fire",
    "install",
    "uninstall",
]

#: kill points inside ``Checkpointer._write`` for ``snapshot.write.crash``
#: (ctx key ``stage``), in write order.  ``pre_manifest``: arrays written,
#: manifest not; ``pre_rename``: tmp dir complete but not committed;
#: ``post_rename``: committed but LATEST still names the previous step;
#: ``post_latest``: committed + published, GC never ran.
SNAPSHOT_CRASH_STAGES = (
    "pre_manifest",
    "pre_rename",
    "post_rename",
    "post_latest",
)

#: the snapshot *write* lane — every site at which the crash-consistency
#: property test kills the writer (torn is additionally parametrized by
#: file and byte offset, crash by stage).
SNAPSHOT_WRITE_SITES = ("snapshot.write.torn", "snapshot.write.crash")


class FaultError(RuntimeError):
    """An injected failure.  ``transient`` marks it retryable — the
    service's dispatch retry loop only retries errors whose
    ``transient`` attribute is true."""

    def __init__(self, site: str, message: str = "", *,
                 transient: bool = True):
        super().__init__(message or f"injected fault at {site!r}")
        self.site = site
        self.transient = transient


class SimulatedCrash(FaultError):
    """A process-death stand-in (never retryable): the writer stops
    mid-sequence exactly as a SIGKILL would, leaving whatever bytes and
    directory entries already hit the filesystem."""

    def __init__(self, site: str, message: str = ""):
        super().__init__(site, message, transient=False)


@dataclasses.dataclass
class FaultSpec:
    """One trigger: fire at matching hits ``[at, at + count)``."""

    site: str
    at: int = 0
    count: float = 1
    arg: float | None = None      # byte offset / ms-per-scale, per site
    transient: bool = True
    match: dict = dataclasses.field(default_factory=dict)
    hits: int = 0                 # matching hits seen so far (mutates)

    def consume(self, ctx: dict) -> bool:
        """True when this hit is inside the firing window."""
        for key, want in self.match.items():
            if ctx.get(key) != want:
                return False
        n = self.hits
        self.hits += 1
        return self.at <= n < self.at + self.count


class FaultPlan:
    """A deterministic script of injected faults.

    ``sleep`` is injectable so tests can assert delay sites without
    wall-clock waits; ``seed`` is carried for plans that want to derive
    pseudo-random offsets up front (the plan itself never draws
    randomness at fire time — determinism is the point)."""

    def __init__(self, *, seed: int = 0, sleep=time.sleep):
        self.seed = seed
        self._sleep = sleep
        self.specs: list[FaultSpec] = []
        self.fired: list[tuple[str, dict]] = []

    def add(self, site: str, *, at: int = 0, count: float = 1,
            arg: float | None = None, transient: bool = True,
            **match) -> "FaultPlan":
        """Register a trigger; returns ``self`` for chaining."""
        self.specs.append(FaultSpec(
            site=site, at=at, count=count, arg=arg,
            transient=transient, match=match,
        ))
        return self

    def reset(self) -> "FaultPlan":
        """Rewind every spec's hit counter (reuse a script verbatim)."""
        for s in self.specs:
            s.hits = 0
        self.fired.clear()
        return self

    # ------------------------------------------------------------------ fire
    def fire(self, site: str, **ctx):
        """Evaluate ``site`` against the plan.

        Raise-type sites raise; delay sites sleep and return the delay
        (ms); torn/corrupt sites return the byte offset the caller must
        apply.  ``None`` means: not firing, proceed normally.

        Every matching spec consumes the hit *before* any spec acts, so
        one spec raising cannot stall another's counter — each spec's
        window is a deterministic function of the hit sequence alone."""
        firing = [
            s for s in self.specs if s.site == site and s.consume(ctx)
        ]
        result = None
        for spec in firing:
            self.fired.append((site, dict(ctx)))
            if site == "dispatch.raise":
                raise FaultError(site, transient=spec.transient)
            if site == "snapshot.write.crash":
                raise SimulatedCrash(
                    site, f"simulated crash at stage {ctx.get('stage')!r}"
                )
            if site in ("dispatch.delay_ms", "shard.straggle"):
                delay = float(spec.arg or 0.0) * float(ctx.get("scale", 1.0))
                if delay > 0:
                    self._sleep(delay / 1e3)
                result = delay
            else:  # snapshot.write.torn / snapshot.read.corrupt
                result = 0 if spec.arg is None else spec.arg
        return result


# --------------------------------------------------------------- active plan
_ACTIVE: FaultPlan | None = None


def install(plan: FaultPlan) -> FaultPlan:
    """Make ``plan`` the process-wide active plan (replaces any)."""
    global _ACTIVE
    _ACTIVE = plan
    return plan


def uninstall() -> None:
    global _ACTIVE
    _ACTIVE = None


def active_plan() -> FaultPlan | None:
    """The currently installed plan, or ``None``.  Observability reads
    this (never mutates): the service's EXPLAIN path snapshots
    ``len(plan.fired)`` around a dispatch to attribute fault sites hit
    to the batch that hit them."""
    return _ACTIVE


@contextlib.contextmanager
def active(plan: FaultPlan):
    """``with faults.active(plan):`` — install for the block, restoring
    the previous plan (usually none) on exit, even through the injected
    exceptions the block exists to raise."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = plan
    try:
        yield plan
    finally:
        _ACTIVE = prev


def fire(site: str, **ctx):
    """The site hook the instrumented layers call.  No active plan —
    the production default — is a single attribute check."""
    plan = _ACTIVE
    if plan is None:
        return None
    return plan.fire(site, **ctx)
