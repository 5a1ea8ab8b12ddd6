"""Low-overhead span tracing for the serving stack.

Every interesting interval in a request's life — queue wait, batch
assembly, device dispatch, the in-flight ring's pending window, host
sync, cache publication, collection lifecycle mutations — becomes a
typed :class:`Span` on one process timeline, answerable to "where did
this query's 4 ms go?" without re-running a benchmark.

Design constraints (DESIGN.md §10):

* **Cheap when off.**  The tracer is disabled by default; every hot-path
  call site guards on ``tracer.enabled`` (one attribute read) or goes
  through :meth:`Tracer.add_span` / :meth:`Tracer.stage`, which return
  at once when disabled (``stage`` hands back one shared no-op context
  manager, so the off path allocates nothing).  Enabling must not change
  results — spans only *observe* timestamps the scheduler already reads
  from its injectable clock.
* **One mechanism for both traces.**  :meth:`Tracer.span` and
  :meth:`Tracer.stage` open a ``torch.profiler.record_function`` range
  when, and only when, a ``torch.profiler`` session is active on the
  calling thread, and record a :class:`Span` when the tracer is enabled.
  So the lifecycle mutations and the search stages show in a device
  trace by name, and an operator without a profiler still sees where a
  call's time went.
* **Two-phase spans.**  The scheduler's overlapped dispatch means spans
  do not nest lexically (batch N+1 is issued while batch N is still
  pending), so the recorder accepts explicit ``(t_start, t_end)``
  intervals (:meth:`add_span`) next to the context-manager forms used by
  synchronous work like lifecycle mutations and a batch search.
* **Lanes.**  Each span carries a ``tid`` (track id).  The scheduler
  puts its own host work on :data:`TID_SCHEDULER` and each in-flight
  batch on ``TID_RING0 + ring-slot``, so a Perfetto render shows the
  overlap directly: the issue span of batch N+1 sits inside the pending
  window of batch N, one lane up.  Lifecycle mutations use
  :data:`TID_LIFECYCLE`; a ``Collection.search`` call and its four
  stages use :data:`TID_SEARCH`: ``store.search`` (args ``collection``,
  ``rows``, ``k``, ``steps``, ``engine``, ``dtype``) is the parent of
  ``dblsh.project``, ``dblsh.select``, ``dblsh.verify`` and
  ``dblsh.merge`` (args ``steps`` run and the host ``syncs`` early exit
  made, 0 without it; where kernel M1 runs the whole schedule in one
  launch, on the card's fused engines, ``steps`` is the schedule's
  length, ``syncs`` 0 and ``kernel`` 1).
* **Bounded.**  The event buffer is a ring (``maxlen``); a long-lived
  serving process can leave tracing on without growing memory.

Clocks: a span's start and duration are read from the tracer's clock
(``time.monotonic`` unless a test injects another), so durations never
jump.  A ``torch.profiler`` trace stamps its events on another base, the
Unix epoch in nanoseconds.  The tracer keeps an anchor, a reading of
both clocks taken when it is built and again each time it is enabled,
and :meth:`Tracer.to_trace_ns` maps a time of its clock onto the
profiler's base.  The mapping is applied when spans are exported or
read, never when they are recorded.

Exports: :meth:`Tracer.export_jsonl` (one span per line, the full
record) and :meth:`Tracer.export_perfetto` (Chrome ``trace_event`` JSON, starts on
the profiler's base — load it in ``ui.perfetto.dev`` or
``chrome://tracing`` beside a ``torch.profiler`` chrome trace).  Request
spans (``cat == "request"``) export as *async* event pairs so hundreds
of concurrently-queued requests render as overlapping slices instead of
fighting over one track.
"""

from __future__ import annotations

import json
import time
from collections import deque

from torch.autograd import _profiler_enabled
from torch.profiler import record_function

__all__ = [
    "Span",
    "Tracer",
    "get_tracer",
    "TID_SCHEDULER",
    "TID_RING0",
    "TID_LIFECYCLE",
    "TID_SEARCH",
]

# Track (lane) assignment for the Perfetto timeline.  Ring lanes are
# TID_RING0 + slot so a depth-d ring renders as d parallel device lanes.
TID_SCHEDULER = 0
TID_RING0 = 1
TID_LIFECYCLE = 64
TID_SEARCH = 65

_TRACK_NAMES = {
    TID_SCHEDULER: "scheduler (host)",
    TID_LIFECYCLE: "lifecycle",
    TID_SEARCH: "search (host)",
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
    """Handle yielded by a span when tracing is off: false, so a caller
    can skip building args nothing would record (``if sp: sp.set(...)``)."""

    __slots__ = ()

    def set(self, **kw) -> None:
        pass

    def __bool__(self) -> bool:
        return False

    def __enter__(self) -> "_NopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOP = _NopSpan()


class _Scope:
    """One open span of :meth:`Tracer.span` / :meth:`Tracer.stage`, and
    the handle ``with`` yields: it holds the profiler's range when a
    session was active at its opening and records a :class:`Span` when
    the tracer was enabled then.  ``set`` attaches args discovered
    mid-span (e.g. how many rows a compaction actually moved); the
    handle is true only when it records."""

    __slots__ = ("tracer", "name", "cat", "tid", "args", "traced", "range",
                 "sid", "parent", "t0")

    def __init__(self, tracer, name, cat, tid, traced, profiled):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.tid = tid
        self.args = {}
        self.traced = traced
        self.range = record_function(name) if profiled else None

    def __enter__(self) -> "_Scope":
        # the clock is read before the profiler's range opens: the range
        # stamps its start part-way through an opening that takes
        # microseconds, so the span's start lies closest to it this way
        if self.traced:
            tr = self.tracer
            self.sid = tr._next_sid()
            self.parent = tr._stack[-1] if tr._stack else None
            tr._stack.append(self.sid)
            self.t0 = tr.clock()
        if self.range is not None:
            self.range.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if self.traced:
            tr = self.tracer
            t1 = tr.clock()
            tr._stack.pop()
            tr.events.append(Span(self.name, self.cat, self.t0, t1 - self.t0,
                                  self.tid, self.sid, self.parent, self.args))
        if self.range is not None:
            self.range.__exit__(*exc)
        return False

    def set(self, **kw) -> None:
        self.args.update(kw)

    def __bool__(self) -> bool:
        return self.traced


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
        self._anchor = self._read_anchor()

    # ------------------------------------------------------------- control
    def enable(self, sample_rate: float | None = None) -> "Tracer":
        self.enabled = True
        if sample_rate is not None:
            self.sample_rate = float(sample_rate)
        self._anchor = self._read_anchor()
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

    def span(self, name: str, *, cat: str = "host",
             tid: int = TID_LIFECYCLE, **args):
        """Context-managed span for synchronous work (lifecycle
        mutations, benchmark phases): :meth:`stage` with args given at
        opening.  Nesting is tracked: the recorded span carries the
        enclosing span's id as ``parent``."""
        sp = self.stage(name, cat, tid)
        if sp:
            sp.args.update(args)
        return sp

    def stage(self, name: str, cat: str = "search", tid: int = TID_SEARCH):
        """A span that opens a ``record_function(name)`` range under an
        active ``torch.profiler`` session, so the work shows on the device
        trace, and records a :class:`Span` while the tracer is enabled.
        For the hot path: args are attached through the handle, behind
        ``if sp:``; with tracing and the profiler both off it costs an
        attribute read, one call and the shared no-op context manager,
        allocating nothing."""
        profiled = _profiler_enabled()
        if not (self.enabled or profiled):
            return _NOP
        return _Scope(self, name, cat, tid, self.enabled, profiled)

    # --------------------------------------------------------------- clocks
    def _read_anchor(self) -> tuple[float, int]:
        """(a reading of the tracer's clock, the Unix epoch in ns at that
        moment): of five back-to-back readings, the one whose two clock
        reads lie closest together, the epoch taken between them."""
        best = None
        for _ in range(5):
            a = self.clock()
            wall = time.time_ns()
            b = self.clock()
            if best is None or b - a < best[0]:
                best = (b - a, 0.5 * (a + b), wall)
        return best[1], best[2]

    def to_trace_ns(self, t: float) -> int:
        """A time ``t`` of the tracer's clock (seconds) on the
        ``torch.profiler`` time base: nanoseconds of the Unix epoch, the
        base of a kineto event's ``start_ns()`` and of a chrome trace's
        ``ts`` (there in microseconds).  Exact up to the anchor's reading,
        a microsecond or so, while neither clock is stepped."""
        t_anchor, wall = self._anchor
        return wall + round((t - t_anchor) * 1e9)

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
        """Chrome ``trace_event`` records (ts/dur in microseconds, starts
        on the profiler's base: :meth:`to_trace_ns`).
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
            ts_us = self.to_trace_ns(s.ts) / 1e3
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
