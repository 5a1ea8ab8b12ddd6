#!/usr/bin/env python3
"""What the port's search spans show on a benchmark cell, on one GPU.

    python3 tools/search_trace_check.py --cells sift10m.batch256 gist1m.batch1024 \
        [--seconds 51] [--seeds 3] [--cost-seconds 51]

Runs ``perfbench``'s harness in this process, with the port's process
tracer (``repro_torch.obs.get_tracer()``) enabled over each measured
window, and reads the tracer's spans beside the profiler's trace:

* one ``--trace 1`` run a cell (the first seed): the cell's metrics; the
  device's idle gaps placed by the tracer's ``dblsh.merge`` spans mapped
  onto the profiler's clock (``Tracer.to_trace_ns``) against the
  breakdown's ``dblsh.merge`` entry, which places them by the profiler's
  own host ranges; how far each stage span's mapped start lies from the
  profiler's host event of the same name; the ``store.search`` spans that
  start in the profiled part against the trace's ``store.search`` host
  and device ranges (whether the trace lost records); each stage's host
  ms a call from the tracer in the part that was not profiled, beside its
  device ms and device ops a call in the profiled part; and the CUDA
  runtime calls inside each stage's host ranges, by total time (where the
  host waits);
* ``--seeds`` pairs of untraced runs a cell, the tracer off and on in
  turns (off, on; then on, off), for the cost of tracing: queries/s,
  p95, and the harness's host ms a call;
* the host cost of one ``Tracer.stage`` with the tracer off and on.

Prints one JSON line a cell and writes all of it to
``chiprun_out/search_trace_check.json``.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import bisect
import gc
import json
import statistics
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

STAGES = ("dblsh.project", "dblsh.select", "dblsh.verify", "dblsh.merge")
CALL = "store.search"
MIN_GAP_NS = 20_000
NEAR_NS = 50_000
SEED0 = 2**31 + 1_234_567


def _loops(harness, windows, traced):
    """``harness.load_loop`` whose loops keep their window and, when
    ``traced``, run it with the port's tracer cleared and enabled."""
    from repro_torch.obs import get_tracer

    orig = harness.load_loop

    def load(traffic):
        mod = orig(traffic)

        class Loop(mod.Loop):
            def run(self, seconds, tracer, seed):
                tr = get_tracer()
                tr.clear()
                if traced:
                    tr.enable()
                try:
                    win = super().run(seconds, tracer, seed)
                finally:
                    tr.disable()
                windows.append(win)
                return win

        return types.SimpleNamespace(pool_rows=mod.pool_rows, Loop=Loop)

    return load


def _run(harness, cell, seed, seconds, trace, traced):
    import torch

    windows, views = [], []
    make = harness.RunView

    def keep(**kw):
        views.append(make(**kw))
        return views[-1]

    load, harness.load_loop = harness.load_loop, _loops(harness, windows, traced)
    harness.RunView = keep
    torch.cuda.reset_peak_memory_stats()
    try:
        result, side = harness.run_cell(cell, seed, seconds, trace)
    finally:
        harness.load_loop, harness.RunView = load, make
    return result, side, windows[0], (views[0] if views else None)


def _pct(values, q):
    v = sorted(values)
    return v[min(len(v) - 1, max(0, round(q / 100 * (len(v) - 1))))] if v else None


def _spans(tracer):
    """(name, start ns, end ns, args) of the tracer's spans on the
    profiler's base."""
    out = []
    for s in tracer.events:
        t = tracer.to_trace_ns(s.ts)
        out.append((s.name, t, t + round(s.dur * 1e9), s.args))
    return out


def _gaps(trace):
    lo, hi = trace.window_ns
    prev = lo
    for _, s, e in trace.ops + [("", hi, hi)]:
        s = max(s, lo)
        if s - prev >= MIN_GAP_NS:
            yield prev, s
        prev = max(prev, min(e, hi))


def _inside(intervals, t):
    starts = [s for s, _ in intervals]
    j = bisect.bisect_right(starts, t) - 1
    return j >= 0 and t <= intervals[j][1]


def _ops_in(trace, name):
    spans = trace.ranges.get(name, [])
    starts = [s for s, _ in spans]
    n = 0
    for _, s, e in trace.ops:
        j = bisect.bisect_right(starts, s) - 1
        if j >= 0 and spans[j][0] <= s and e <= spans[j][1]:
            n += 1
    return n, len(spans)


def _runtime_calls(view, trace):
    """CUDA runtime calls on the host inside each stage's host ranges
    (and outside any): count and ms a call, by stage and call name."""
    import torch

    ranges = sorted((s, e, name) for name, s, e in trace.host
                    if name in STAGES or name == CALL)
    starts = [s for s, _, _ in ranges]
    calls = max(1, sum(1 for *_, name in ranges if name == CALL))
    by: dict[tuple, list] = {}
    lo, hi = trace.window_ns
    for ev in view.tracer._prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() != torch.autograd.DeviceType.CPU or not name.startswith("cuda"):
            continue
        s = ev.start_ns()
        if not lo <= s < hi:
            continue
        label = "outside the search"
        j = bisect.bisect_right(starts, s) - 1
        while j >= 0:  # the innermost: the latest started that holds s
            if ranges[j][1] >= s:
                label = ranges[j][2]
                break
            j -= 1
        acc = by.setdefault((label, name), [0, 0])
        acc[0] += 1
        acc[1] += ev.duration_ns()
    rows = [[label, name, n / calls, ns / 1e6 / calls] for (label, name), (n, ns) in by.items()]
    return sorted(rows, key=lambda r: -r[3])[:16]


def traced_checks(view, result) -> dict:
    from repro_torch.obs import get_tracer

    trace = view.trace
    lo, hi = trace.window_ns
    spans = _spans(get_tracer())
    prof = [r for r in spans if lo <= r[1] < hi]
    rest = [r for r in spans if not lo <= r[1] < hi]
    out = {"metrics": {k: v["value"] for k, v in result["metrics"].items()},
           "spans": len(spans), "spans_profiled": len(prof)}

    # the merge's idle time placed by the tracer's spans
    merge = sorted((s, e) for name, s, e, _ in prof if name == "dblsh.merge")
    idle = sum(b - a for a, b in _gaps(trace) if _inside(merge, (a + b) // 2))
    breakdown = dict(trace.idle_gaps(count=1000)).get("dblsh.merge", 0.0)
    out["merge_idle"] = {
        "tracer_spans": len(merge), "tracer_s": idle / 1e9,
        "tracer_ms_a_span": idle / 1e6 / max(1, len(merge)),
        "breakdown_s": breakdown,
        "ratio": (idle / 1e9) / breakdown if breakdown else None}

    # each stage span's start against the profiler's host event
    host = {}
    for name, s, _ in trace.host:
        host.setdefault(name, []).append(s)
    for v in host.values():
        v.sort()
    deltas = {}
    for name, s, _, _ in prof:
        if name not in STAGES and name != CALL:
            continue
        ev = host.get(name, [])
        j = bisect.bisect_left(ev, s)
        near = [ev[i] - s for i in (j - 1, j) if 0 <= i < len(ev)]
        deltas.setdefault(name, []).append(min(near, key=abs) if near else None)
    clock = {}
    all_stage = []
    for name, ds in deltas.items():
        found = [d for d in ds if d is not None]
        if name in STAGES:
            all_stage += [abs(d) if d is not None else float("inf") for d in ds]
        clock[name] = {"spans": len(ds), "unmatched": len(ds) - len(found),
                       "median_us": statistics.median(found) / 1e3 if found else None,
                       "p99_abs_us": _pct([abs(d) for d in found], 99) / 1e3 if found else None,
                       "max_abs_us": max(abs(d) for d in found) / 1e3 if found else None}
    clock["stage_share_within_50us"] = (
        sum(d <= NEAR_NS for d in all_stage) / len(all_stage) if all_stage else None)
    out["clock"] = clock

    # lost records: the calls that started in the profiled part
    out["records"] = {
        "tracer_calls": sum(1 for r in prof if r[0] == CALL),
        "host_ranges": len(host.get(CALL, [])),
        "device_ranges": len(trace.ranges.get(CALL, [])),
        **{f"device_ranges.{st}": len(trace.ranges.get(st, [])) for st in STAGES}}

    # stages: host ms a call outside the profiled part, device ms and ops
    # a call inside it
    stages = {}
    for name in (CALL,) + STAGES:
        durs = [(e - s) / 1e6 for n, s, e, _ in rest if n == name]
        sec, count = trace.in_ranges(name)
        ops, _ = _ops_in(trace, name)
        stages[name] = {"host_ms": statistics.fmean(durs) if durs else None,
                        "host_ms_max": max(durs) if durs else None, "host_calls": len(durs),
                        "device_ms": sec * 1e3 / count if count else None,
                        "device_ops": ops / count if count else None}
    out["stages"] = stages
    out["merge_steps"] = sorted({a.get("steps") for n, _, _, a in spans if n == "dblsh.merge"})
    out["runtime_calls"] = _runtime_calls(view, trace)
    out["idle_gaps"] = result.get("breakdown", {}).get("idle_gaps")
    out["busy_s"] = result["device"].get("busy_s")
    out["window_s"] = result["device"].get("window_s")
    return out


def stage_cost(n: int = 200_000) -> dict:
    """Host ns of one ``with tracer.stage(...)``, the tracer off and on
    (no profiler)."""
    from repro_torch.obs import Tracer

    out = {}
    for on in (False, True):
        tr = Tracer(enabled=on, maxlen=1024)
        t = time.perf_counter()
        for _ in range(n):
            with tr.stage("dblsh.merge"):
                pass
        out["on" if on else "off"] = (time.perf_counter() - t) / n * 1e9
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--cost-seconds", type=float, default=51.0)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "search_trace_check.json"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("search_trace_check: needs a CUDA device", file=sys.stderr)
        return 2
    from perfbench import harness

    report = {"card": harness._card_line(), "torch": torch.__version__,
              "stage_ns": stage_cost(), "cells": {}}
    print(json.dumps({"card": report["card"], "stage_ns": report["stage_ns"]}), flush=True)
    for cell in args.cells:
        rec = {}
        result, side, win, view = _run(harness, cell, SEED0, args.seconds, True, True)
        rec["traced"] = traced_checks(view, result)
        rec["traced"]["correct"] = result["correct"]
        rec["traced"]["side"] = side
        del view
        gc.collect()
        torch.cuda.empty_cache()
        cost = []
        for i in range(args.seeds):
            seed = SEED0 + 7919 * (i + 1)
            order = (False, True) if i % 2 == 0 else (True, False)
            for traced in order:
                result, _, win, _ = _run(harness, cell, seed, args.cost_seconds, False, traced)
                host = [(e - s) * 1e3 for s, e in win.spans]
                m = result["metrics"]
                cost.append({"seed": seed, "tracer": traced, "correct": result["correct"],
                             "queries_per_s": m["queries_per_s"]["value"],
                             "request_p95_ms": m["request_p95_ms"]["value"],
                             "host_ms": statistics.fmean(host)})
                gc.collect()
                torch.cuda.empty_cache()
        rec["cost"] = cost
        for traced in (False, True):
            runs = [c for c in cost if c["tracer"] == traced]
            rec[f"cost_{'on' if traced else 'off'}_median"] = {
                k: statistics.median(c[k] for c in runs)
                for k in ("queries_per_s", "request_p95_ms", "host_ms")} if runs else None
        report["cells"][cell] = rec
        print(json.dumps({cell: {k: v for k, v in rec.items() if k != "traced"} |
                          {"traced": {k: v for k, v in rec["traced"].items() if k != "side"}}}),
              flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
