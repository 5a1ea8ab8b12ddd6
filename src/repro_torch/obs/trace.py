"""Low-overhead span tracing for the serving stack.

Every interesting interval in a request's life — queue wait, batch
assembly, device dispatch, the in-flight ring's pending window, host
sync, cache publication, collection lifecycle mutations — becomes a
typed :class:`Span` on one process timeline, answerable to "where did
this query's 4 ms go?" without re-running a benchmark.

Design constraints (DESIGN.md §10):

* **Cheap when off.**  The tracer is disabled by default; every hot-path
  call site guards on ``tracer.enabled`` (one attribute read) or goes
  through :meth:`Tracer.add_span`, which returns immediately when
  disabled.  Enabling must not change results — spans only *observe*
  timestamps the scheduler already reads from its injectable clock.
* **Two-phase spans.**  The scheduler's overlapped dispatch means spans
  do not nest lexically (batch N+1 is issued while batch N is still
  pending), so the recorder accepts explicit ``(t_start, t_end)``
  intervals (:meth:`add_span`) next to the context-manager form
  (:meth:`span`) used by synchronous work like lifecycle mutations.
* **Lanes.**  Each span carries a ``tid`` (track id).  The scheduler
  puts its own host work on :data:`TID_SCHEDULER` and each in-flight
  batch on ``TID_RING0 + ring-slot``, so a Perfetto render shows the
  overlap directly: the issue span of batch N+1 sits inside the pending
  window of batch N, one lane up.
* **Bounded.**  The event buffer is a ring (``maxlen``); a long-lived
  serving process can leave tracing on without growing memory.

Exports: :meth:`Tracer.export_jsonl` (one span per line, the full
record) and :meth:`Tracer.export_perfetto` (Chrome ``trace_event``
JSON — load in ``ui.perfetto.dev`` or ``chrome://tracing``).  Request
spans (``cat == "request"``) export as *async* event pairs so hundreds
of concurrently-queued requests render as overlapping slices instead of
fighting over one track.

Device correlation: the search stages run inside
``torch.profiler.record_function`` ranges (``dblsh.project``,
``dblsh.select``, ``dblsh.verify``, ``dblsh.merge``), so a
``torch.profiler`` device trace lines up with these host spans by name.
"""

from __future__ import annotations

import json
import time
from collections import deque
from contextlib import contextmanager

__all__ = [
    "Span",
    "Tracer",
    "get_tracer",
    "TID_SCHEDULER",
    "TID_RING0",
    "TID_LIFECYCLE",
]

# Track (lane) assignment for the Perfetto timeline.  Ring lanes are
# TID_RING0 + slot so a depth-d ring renders as d parallel device lanes.
TID_SCHEDULER = 0
TID_RING0 = 1
TID_LIFECYCLE = 64

_TRACK_NAMES = {
    TID_SCHEDULER: "scheduler (host)",
    TID_LIFECYCLE: "lifecycle",
}


class Span:
    """One recorded interval (or instant, when ``dur`` is 0 and
    ``ph == 'i'``).  Plain ``__slots__`` object — spans are allocated on
    the serving path and must stay cheap."""

    __slots__ = ("name", "cat", "ts", "dur", "tid", "sid", "parent", "args", "ph")

    def __init__(self, name, cat, ts, dur, tid, sid, parent, args, ph="X"):
        self.name = name
        self.cat = cat
        self.ts = ts          # seconds, tracer clock
        self.dur = dur        # seconds
        self.tid = tid
        self.sid = sid        # unique span id
        self.parent = parent  # enclosing span id (context-manager form) or None
        self.args = args
        self.ph = ph          # "X" complete | "i" instant

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "cat": self.cat,
            "ts": self.ts,
            "dur": self.dur,
            "tid": self.tid,
            "sid": self.sid,
            "parent": self.parent,
            "ph": self.ph,
            "args": self.args,
        }


class _NopSpan:
    """Handle yielded by ``span()`` when tracing is off."""

    __slots__ = ()

    def set(self, **kw) -> None:
        pass


_NOP = _NopSpan()


class _LiveSpan:
    """Handle yielded by ``span()`` while the interval is open; ``set``
    attaches args discovered mid-span (e.g. how many rows a compaction
    actually moved)."""

    __slots__ = ("args",)

    def __init__(self, args: dict):
        self.args = args

    def set(self, **kw) -> None:
        self.args.update(kw)


class Tracer:
    """Bounded span recorder with an injectable clock.

    ``enabled`` gates everything; ``sample_rate`` (0..1) additionally
    thins *request-level* spans (call sites ask :meth:`should_sample`
    once per request) with a deterministic counter-based sampler —
    batch/lifecycle spans are low-rate and always recorded while
    enabled.
    """

    def __init__(self, *, enabled: bool = False, sample_rate: float = 1.0,
                 clock=time.monotonic, maxlen: int = 65536):
        self.enabled = enabled
        self.sample_rate = float(sample_rate)
        self.clock = clock
        self.events: deque[Span] = deque(maxlen=maxlen)
        self._sid = 0
        self._stack: list[int] = []      # open context-manager span ids
        self._sample_acc = 0.0

    # ------------------------------------------------------------- control
    def enable(self, sample_rate: float | None = None) -> "Tracer":
        self.enabled = True
        if sample_rate is not None:
            self.sample_rate = float(sample_rate)
        return self

    def disable(self) -> "Tracer":
        self.enabled = False
        return self

    def clear(self) -> None:
        self.events.clear()
        self._stack.clear()
        self._sample_acc = 0.0

    def should_sample(self) -> bool:
        """Deterministic rate limiter for per-request spans: fires on the
        calls where the accumulated rate crosses an integer (rate 1.0 →
        always, 0.5 → every other, 0 → never)."""
        if not self.enabled:
            return False
        self._sample_acc += self.sample_rate
        if self._sample_acc >= 1.0:
            self._sample_acc -= 1.0
            return True
        return False

    # ----------------------------------------------------------- recording
    def _next_sid(self) -> int:
        self._sid += 1
        return self._sid

    def add_span(self, name: str, t_start: float, t_end: float, *,
                 cat: str = "host", tid: int = TID_SCHEDULER, **args) -> None:
        """Record a completed interval measured by the caller (the
        two-phase form the overlapped scheduler needs).  Timestamps must
        come from the same clock family as ``self.clock`` so the
        timeline stays coherent."""
        if not self.enabled:
            return
        self.events.append(Span(
            name, cat, t_start, max(t_end - t_start, 0.0), tid,
            self._next_sid(), None, args,
        ))

    def instant(self, name: str, *, cat: str = "host",
                tid: int = TID_SCHEDULER, t: float | None = None,
                **args) -> None:
        """A point event (quota rejection, cache put, breach)."""
        if not self.enabled:
            return
        ts = self.clock() if t is None else t
        self.events.append(Span(
            name, cat, ts, 0.0, tid, self._next_sid(), None, args, ph="i",
        ))

    @contextmanager
    def span(self, name: str, *, cat: str = "host",
             tid: int = TID_LIFECYCLE, **args):
        """Context-managed span for synchronous work (lifecycle
        mutations, benchmark phases).  Nesting is tracked: the recorded
        span carries the enclosing span's id as ``parent``."""
        if not self.enabled:
            yield _NOP
            return
        sid = self._next_sid()
        parent = self._stack[-1] if self._stack else None
        self._stack.append(sid)
        live = _LiveSpan(dict(args))
        t0 = self.clock()
        try:
            yield live
        finally:
            t1 = self.clock()
            self._stack.pop()
            self.events.append(
                Span(name, cat, t0, t1 - t0, tid, sid, parent, live.args)
            )

    # ------------------------------------------------------------- exports
    def export_jsonl(self, path: str) -> int:
        """One span per line, full record (ts/dur in seconds); returns
        the number of spans written."""
        events = sorted(self.events, key=lambda s: s.ts)
        with open(path, "w") as f:
            for s in events:
                f.write(json.dumps(s.to_dict()) + "\n")
        return len(events)

    def to_trace_events(self) -> list[dict]:
        """Chrome ``trace_event`` records (ts/dur in microseconds).
        ``cat == "request"`` spans become async begin/end pairs keyed on
        the span id (or ``args["uid"]`` when present) so overlapping
        queued requests render side by side; instants become ``ph: "i"``;
        everything else is a complete ``ph: "X"`` slice on its lane."""
        out = []
        for tid, label in sorted(_TRACK_NAMES.items()):
            out.append({
                "ph": "M", "name": "thread_name", "pid": 0, "tid": tid,
                "args": {"name": label},
            })
        ring_tids = sorted({
            s.tid for s in self.events
            if TID_RING0 <= s.tid < TID_LIFECYCLE
        })
        for tid in ring_tids:
            out.append({
                "ph": "M", "name": "thread_name", "pid": 0, "tid": tid,
                "args": {"name": f"ring slot {tid - TID_RING0}"},
            })
        for s in sorted(self.events, key=lambda x: x.ts):
            ts_us = s.ts * 1e6
            base = {"name": s.name, "cat": s.cat, "pid": 0, "tid": s.tid,
                    "args": s.args}
            if s.ph == "i":
                out.append({**base, "ph": "i", "ts": ts_us, "s": "t"})
            elif s.cat == "request":
                ev_id = str(s.args.get("uid", s.sid))
                out.append({**base, "ph": "b", "id": ev_id, "ts": ts_us})
                out.append({**base, "ph": "e", "id": ev_id,
                            "ts": ts_us + s.dur * 1e6})
            else:
                out.append({**base, "ph": "X", "ts": ts_us,
                            "dur": s.dur * 1e6})
        return out

    def export_perfetto(self, path: str) -> int:
        """Write the Chrome/Perfetto ``trace_event`` JSON; returns the
        number of trace events (metadata included)."""
        events = self.to_trace_events()
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
        return len(events)


# The process-wide tracer: collection lifecycle spans and any service
# built without an explicit Observability bundle record here, so one
# export shows mutations and serving on a single timeline.
_global_tracer = Tracer(enabled=False)


def get_tracer() -> Tracer:
    return _global_tracer
