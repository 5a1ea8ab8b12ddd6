"""Per-query adaptive termination over the one-pass serving pipeline.

The paper's search is *adaptive*: each query grows its window radius
``c^i·r0`` until a terminate condition fires (§IV-B/C) — C1, enough
verified candidates (``βn + k``, concretely ``2tL + k``); C2, a verified
point within ``c·r``, which certifies a c²-approximate answer.  The
batched serving core historically ran a *fixed* schedule: every query
paid all ``steps`` probes, easy queries wasted work, hard queries
silently under-recalled at whatever the hand-picked schedule reached.

This module is the subsystem face of adaptive serving.  The machinery
itself lives *inside* the one-pass pipeline
(:class:`~repro_torch.core.serve_search.Termination`, re-exported here): the
C1/C2 conditions become per-query ``done`` masks applied to the
per-step delta merges — terminated queries stop gathering and verifying
— plus a batch-wide early exit (one host read of the done mask per
step) once every query is done.  C2 is evaluated from the per-slot admission halfwidths the
verify engines already emit (the ``window_dist`` kernel's ``hw`` plane),
so termination costs no extra DMAs on any engine.

:func:`search_batch_adaptive` is the convenience entry: a fixed-budget
batched search with termination on and stats always returned.  The
helpers below read those stats back into paper language — which step a
query stopped at, the radius ``r_i`` it certified against, whether the
C2 certificate held at exit — which is what the property tests and the
recall-frontier benchmark consume.
"""

from __future__ import annotations

import numpy as np

from ..core.serve_search import Termination, search_batch_fixed

__all__ = [
    "Termination",
    "certified_c2_mask",
    "search_batch_adaptive",
    "termination_radii",
    "termination_step_histogram",
]


def search_batch_adaptive(
    index,
    Q,
    k: int = 0,
    r0: float = 1.0,
    steps: int = 8,
    engine: str = "torch",
    exact: bool = False,
    termination: Termination = Termination(),
    *,
    device=None,
):
    """Adaptive batched (c,k)-ANN: the one-pass pipeline with C1/C2 done
    masks and batch-wide early exit.  Returns ``(dists, ids, stats)`` —
    stats always included (``radius_steps`` is the per-query termination
    step, the quantity adaptivity exists to shrink)."""
    return search_batch_fixed(
        index, Q, k=k, r0=r0, steps=steps, engine=engine,
        exact=exact, with_stats=True, termination=termination,
        device=device,
    )


def termination_radii(stats, r0: float, c: float) -> np.ndarray:
    """The radius ``r_i`` each query's schedule stopped at:
    ``r0 · c^(radius_steps − 1)`` (the radius of the last step that ran;
    queries that never ran a step report ``r0``)."""
    s = np.asarray(stats["radius_steps"])
    return r0 * np.power(c, np.maximum(s, 1) - 1)


def termination_step_histogram(stats, steps: int) -> np.ndarray:
    """(steps + 1,) counts of queries by termination step; slot ``j`` is
    "stopped after j steps" (slot ``steps`` = ran the whole schedule)."""
    s = np.asarray(stats["radius_steps"])
    return np.bincount(np.clip(s, 0, steps), minlength=steps + 1)


def certified_c2_mask(dists, stats, *, r0: float, c: float, k: int,
                      steps: int) -> np.ndarray:
    """Queries that exited *early* with the C2 certificate in hand: the
    k-th returned distance is ≤ c·r_i at the termination radius.  For
    these, the paper's Theorem-2 argument guarantees the returned top-1
    is a c²-approximate NN — the property the tune test suite checks
    against a brute-force oracle."""
    d = np.asarray(dists)
    s = np.asarray(stats["radius_steps"])
    r_i = termination_radii(stats, r0, c)
    kth = d[:, k - 1]
    return (s < steps) & np.isfinite(kth) & (kth <= c * r_i * (1 + 1e-6))
