"""What every traffic generator shares.  A mix is a data file,
``perfbench/traffic/<mix>.json``; its ``"loop"`` names the generator that
reads it, ``perfbench/loops/<loop>.py``, found by name as the metric
readers are.  A loop module gives:

* ``pool_rows(traffic, seconds)`` -- the rows of held-out query pool a
  run of ``seconds`` needs, warm-up included;
* ``Loop(traffic, col, pool, r0)`` with ``warm_up()``, which runs every
  shape the window will use, and ``run(seconds, tracer, seed)``, which
  drives ``col`` (a ``repro_torch.store.Collection``) for the window and
  returns a :class:`Window`.

A request is timed from when it was due until its answer is on the host.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

__all__ = ["Window", "Timed"]


@dataclasses.dataclass
class Window:
    t0: float                       # the window's start (host clock)
    t_end: float                    # its close: the last answer on the host
    due: np.ndarray                 # per request: when it was due
    done: np.ndarray                # per request: when its answer was on the host (nan: never)
    queries: np.ndarray             # per request: its number of queries
    rows: list                      # per request: its pool rows
    dists: list                     # per request: (m, k) float32 answers (None: never)
    ids: list                       # per request: (m, k) int32 answers (None: never)
    spans: list                     # (start, return) of each search call on the host
    pool_passes: float = 0.0        # queries sent over the rows the window may use


class Timed:
    """A search function with each call's host span recorded."""

    def __init__(self, fn):
        self.fn, self.spans = fn, []

    def __call__(self, *a, **kw):
        t = time.perf_counter()
        out = self.fn(*a, **kw)
        self.spans.append((t, time.perf_counter()))
        return out
