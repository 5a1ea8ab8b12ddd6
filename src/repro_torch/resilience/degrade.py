"""Brownout: SLO-breach-driven degradation ladder for the store service.

The ``SLOWatch`` (``obs.slo``) emits ``BreachEvent``s that *name* a remediation but
nothing consumed them; :class:`BrownoutController` closes the loop.  It
registers itself on a ``StoreService`` (``svc.brownout = self``) and
subscribes to the watch via ``attach(slo)`` (the ``on_check`` hook), then
walks a ladder one rung per breached check, healing one rung back per
``heal_after`` consecutive clean checks:

  level 0  healthy — plans pass through untouched
  level 1  cap termination steps: ``steps = max(floor,
           ceil(steps * step_cap_frac))``, adaptive termination kept —
           DB-LSH's window schedule is the knob, recall degrades
           continuously while C1/C2 certification still runs on the
           shorter schedule
  level 2  force a FixedSchedule at ``floor_steps`` (termination
           dropped): the cheapest deterministic plan, no adaptive
           machinery on the hot path
  level 3  shed lowest-weight tenants: ``submit`` raises
           :class:`~repro_torch.store.service.BrownoutShed` for tenants below
           the max configured quota weight (equal weights shed nobody —
           there is no "lowest")

Every plan the controller touches marks its ticket ``degraded=True`` —
the caller always knows a result was served reduced-recall.  The
controller never mutates resolved state retroactively: it intercepts
plans at submit time only, so in-flight tickets keep the plan they were
admitted with.

This module deliberately imports nothing from ``repro_torch.store`` (the
service imports ``repro_torch.resilience``); the service is duck-typed —
anything with ``registry`` and a ``brownout`` slot works.
"""

from __future__ import annotations

import math

from ..tune.policy import ResolvedPlan

__all__ = ["BrownoutController"]


class BrownoutController:
    """Walks the degradation ladder on SLO breaches.

    ``hold_s`` rate-limits escalation (at most one rung per ``hold_s``
    seconds of breached checks) so a single bad window cannot slam the
    service to shedding; ``heal_after`` consecutive clean checks heal
    one rung."""

    def __init__(self, service, *, step_cap_frac: float = 0.5,
                 floor_steps: int = 1, heal_after: int = 3,
                 hold_s: float = 0.0, max_level: int = 3):
        assert 0.0 < step_cap_frac <= 1.0
        assert floor_steps >= 1 and 1 <= max_level <= 3
        self.service = service
        self.step_cap_frac = step_cap_frac
        self.floor_steps = floor_steps
        self.heal_after = heal_after
        self.hold_s = hold_s
        self.max_level = max_level
        self.level = 0
        self.transitions: list[tuple[float, int]] = []  # (t, new_level)
        self._clean_streak = 0
        self._t_escalated: float | None = None
        self._gauge = service.registry.gauge(
            "repro_store_brownout_level",
            "Current brownout ladder rung (0 = healthy)",
        )
        self._gauge.set(0)
        service.brownout = self

    # ---------------------------------------------------------- subscription
    def attach(self, slo) -> "BrownoutController":
        """Subscribe to an ``SLOWatch`` — every ``check()`` (breached or
        clean) reaches :meth:`observe`, which is what lets the ladder
        heal: breach events alone never say "the window is healthy"."""
        slo.on_check = self.observe
        return self

    def observe(self, events, now: float) -> None:
        """One SLO check's outcome: a non-empty ``events`` list is a
        breached window (escalate), an empty one is clean (heal)."""
        if events:
            self._clean_streak = 0
            held = (
                self._t_escalated is not None
                and (now - self._t_escalated) < self.hold_s
            )
            if self.level < self.max_level and not held:
                self._set_level(self.level + 1, now)
                self._t_escalated = now
        else:
            self._clean_streak += 1
            if self.level > 0 and self._clean_streak >= self.heal_after:
                self._set_level(self.level - 1, now)
                self._clean_streak = 0

    def _set_level(self, level: int, now: float) -> None:
        self.level = level
        self._gauge.set(level)
        self.transitions.append((now, level))

    # ------------------------------------------------------- plan intercepts
    def apply_plan(self, plan: ResolvedPlan) -> tuple[ResolvedPlan, bool]:
        """Degrade a freshly resolved plan per the current rung; returns
        (plan, degraded)."""
        if self.level == 0:
            return plan, False
        if self.level == 1:
            steps = max(self.floor_steps,
                        math.ceil(plan.steps * self.step_cap_frac))
            if steps >= plan.steps:
                return plan, False
            return (
                ResolvedPlan(r0=plan.r0, steps=steps,
                             termination=plan.termination),
                True,
            )
        # level >= 2: the floor plan, fixed — termination dropped so the
        # dispatch runs the plain FixedSchedule program
        if plan.steps <= self.floor_steps and plan.termination is None:
            return plan, False
        return (
            ResolvedPlan(r0=plan.r0,
                         steps=min(plan.steps, self.floor_steps)),
            True,
        )

    def should_shed(self, tenant: str) -> bool:
        """Level 3: shed tenants strictly below the max configured quota
        weight.  All-equal weights (including the no-quota default)
        shed nobody."""
        if self.level < 3:
            return False
        quotas = self.service.quotas
        if not quotas:
            return False
        top = max(q.weight for q in quotas.values())
        mine = quotas[tenant].weight if tenant in quotas else 1
        return mine < top
