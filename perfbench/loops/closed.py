"""The closed loop: one client sends a batch of ``batch`` queries through
``Collection.search`` and waits for its results on the host before it
sends the next.  A request is one call, timed from the call until its
results are on the host.

The pool holds ``pool_per_s * seconds`` rows for the window, so a window
sends each query once while the port answers fewer than ``pool_per_s``
queries a second; past that it starts the pool again (the run reports
its passes).  Two more batches at the pool's end are the warm-up's and
never the window's.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
from torch.profiler import record_function

from perfbench.loadgen import Timed, Window


def pool_rows(traffic: dict, seconds: float) -> int:
    B = int(traffic["batch"])
    return max(B, int(math.ceil(float(traffic["pool_per_s"]) * seconds))) + 2 * B


class Loop:
    def __init__(self, traffic, col, pool, r0):
        self.col, self.pool = col, pool
        self.B = int(traffic["batch"])
        self.W = pool.shape[0] - 2 * self.B  # the window's rows
        self.kw = dict(k=int(traffic["k"]), r0=r0, steps=int(traffic["steps"]))

    def _batch(self, i: int) -> tuple[np.ndarray, torch.Tensor]:
        s = (i * self.B) % self.W
        if s + self.B <= self.W:
            return np.arange(s, s + self.B), torch.from_numpy(self.pool[s:s + self.B])
        rows = np.arange(s, s + self.B) % self.W
        return rows, torch.from_numpy(self.pool[rows])

    def warm_up(self) -> None:
        for s in (self.W, self.W + self.B):
            d, ids = self.col.search(torch.from_numpy(self.pool[s:s + self.B]), **self.kw)
            d.cpu(), ids.cpu()

    def run(self, seconds: float, tracer, seed: int) -> Window:
        timed = Timed(self.col.search)
        due, done, rows_l, dl, il = [], [], [], [], []
        t0 = time.perf_counter()
        tracer.arm(t0, seconds)
        end = t0 + seconds
        i = 0
        while True:
            rows, Q = self._batch(i)
            t = time.perf_counter()
            if t >= end:
                break
            tracer.tick(t)
            t = time.perf_counter()
            with record_function("perfbench.search"):
                d, ids = timed(Q, **self.kw)
            with record_function("perfbench.fetch"):
                d, ids = d.cpu().numpy(), ids.cpu().numpy()
            due.append(t)
            done.append(time.perf_counter())
            rows_l.append(rows)
            dl.append(d)
            il.append(ids)
            i += 1
        t_end = done[-1] if done else time.perf_counter()
        return Window(t0=t0, t_end=t_end, due=np.array(due), done=np.array(done),
                      queries=np.full(len(due), self.B), rows=rows_l, dists=dl, ids=il,
                      spans=timed.spans, pool_passes=i * self.B / self.W)
