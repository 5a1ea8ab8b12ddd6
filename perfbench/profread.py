"""The traced window of a ``--trace 1`` run: ``torch.profiler`` over the
last ``trace_seconds`` of the measured window, reduced to what the
per-layer readers need.

A stage's device time is the device ops inside its device-side range
(the profiler's annotation of a ``record_function`` range on the card's
timeline, ``dblsh.*`` in the port), as ``chip_smoke.py``'s ``stage_ms``
reads it.  The first device records after a profiler starts can go
missing, so a session opens with a few spin kernels, which are left out
of every figure.
"""

from __future__ import annotations

import bisect
import dataclasses
import time

import torch

__all__ = ["TraceWindow", "TraceSummary"]

WINDOW_RANGE = "perfbench.window"
_SPIN = "spin_kernel"


@dataclasses.dataclass
class TraceSummary:
    window_ns: tuple[int, int]                 # the traced window on the trace's clock
    ops: list[tuple[str, int, int]]            # device ops (name, start, end), sorted
    ranges: dict[str, list[tuple[int, int]]]   # device-side ranges by name, sorted
    host: list[tuple[str, int, int]]           # host-side annotation ranges (name, start, end)

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def busy_s(self) -> float:
        """Seconds of the window in which some op ran on the device (the
        union of the ops' intervals)."""
        lo, hi = self.window_ns
        busy, cur_s, cur_e = 0, None, None
        for _, s, e in self.ops:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy / 1e9

    def in_ranges(self, name: str) -> tuple[float, int]:
        """(device seconds of the ops inside the ``name`` ranges, number
        of those ranges)."""
        spans = self.ranges.get(name, [])
        if not spans:
            return 0.0, 0
        starts = [s for s, _ in spans]
        total = 0
        for _, s, e in self.ops:
            j = bisect.bisect_right(starts, s) - 1
            if j >= 0 and spans[j][0] <= s and e <= spans[j][1]:
                total += e - s
        return total / 1e9, len(spans)

    def kernel_times(self, needle: str) -> list[float]:
        """Seconds of each device op whose name contains ``needle``."""
        return [(e - s) / 1e9 for name, s, e in self.ops if needle in name]

    def top_ops(self, count: int = 10) -> list[list]:
        by: dict[str, int] = {}
        for name, s, e in self.ops:
            by[name] = by.get(name, 0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:count]
        return [[name[:120], ns / 1e9] for name, ns in top]

    def idle_gaps(self, count: int = 10, min_ns: int = 20_000) -> list[list]:
        """The device's idle gaps of at least ``min_ns`` inside the window,
        summed by the innermost host annotation range around each gap's
        middle (what the host was doing), largest first."""
        lo, hi = self.window_ns
        host = self.host
        starts = [s for _, s, _ in host]
        by: dict[str, int] = {}
        prev = lo
        for _, s, e in self.ops + [("", hi, hi)]:
            s = max(s, lo)
            if s - prev >= min_ns:
                mid = (prev + s) // 2
                # the innermost range holding the middle: the latest
                # started one that has not ended (ranges nest)
                label = "host: outside any range"
                j = bisect.bisect_right(starts, mid) - 1
                for _ in range(4096):
                    if j < 0:
                        break
                    if host[j][2] >= mid:
                        label = host[j][0]
                        break
                    j -= 1
                by[label] = by.get(label, 0) + (s - prev)
            prev = max(prev, min(e, hi))
        top = sorted(by.items(), key=lambda kv: -kv[1])[:count]
        return [[name, ns / 1e9] for name, ns in top]


def _is_range(name: str, ev) -> bool:
    try:
        if ev.is_user_annotation():
            return True
    except AttributeError:
        pass
    return name.startswith(("dblsh.", "perfbench.", "store."))


class TraceWindow:
    """Profiles the last ``trace_seconds`` of a window (all of it when the
    window is shorter): ``arm`` at the window's start, ``tick`` from the
    loop, ``stop`` after the window closed, then ``summary``."""

    def __init__(self, enabled: bool, trace_seconds: float):
        self.enabled = enabled
        self.trace_seconds = float(trace_seconds)
        self.t_start = None
        self.t_on = None
        self.t_off = None
        self._prof = None
        self._range = None

    @property
    def active(self) -> bool:
        return self._prof is not None and self.t_off is None

    def warm_up(self) -> None:
        """A first, empty session in set-up: the profiler's first start on
        a card (its tracing library's set-up) takes seconds, which must
        not fall inside the window."""
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            with profile(activities=acts):
                if torch.cuda.is_available():
                    torch.cuda._sleep(1000)
                    torch.cuda.synchronize()

    def arm(self, t0: float, seconds: float) -> None:
        if self.enabled:
            self.t_start = t0 + max(0.0, seconds - self.trace_seconds)

    def tick(self, now: float) -> None:
        if self.enabled and self._prof is None and now >= self.t_start:
            self._start()

    def _start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        if torch.cuda.is_available():
            for _ in range(8):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        self._range = record_function(WINDOW_RANGE)
        self._range.__enter__()
        self.t_on = time.perf_counter()

    def stop(self) -> None:
        if self._prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self.t_off = time.perf_counter()
        self._prof.__exit__(None, None, None)

    def covers(self, t: float) -> bool:
        """Whether host time ``t`` lies in the profiled part."""
        return self.t_on is not None and self.t_on <= t <= (self.t_off or t)

    def summary(self) -> TraceSummary | None:
        if self._prof is None:
            return None
        events = self._prof.profiler.kineto_results.events()
        ops, ranges, host, window = [], {}, [], None
        for ev in events:
            name = ev.name()
            s = ev.start_ns()
            e = s + ev.duration_ns()
            on_device = ev.device_type() != torch.autograd.DeviceType.CPU
            if name == WINDOW_RANGE and not on_device:
                window = (s, e)
            elif on_device:
                if _SPIN in name:
                    continue
                if _is_range(name, ev):
                    ranges.setdefault(name, []).append((s, e))
                else:
                    ops.append((name, s, e))
            elif _is_range(name, ev):
                host.append((name, s, e))
        if window is None:
            return None
        ops.sort(key=lambda r: r[1])
        host.sort(key=lambda r: r[1])
        for spans in ranges.values():
            spans.sort()
        return TraceSummary(window_ns=window, ops=ops, ranges=ranges, host=host)
