"""Device ops a search call: the device ops (kernels and copies) inside
the port's ``store.search`` device-side ranges of the traced window (the
range the ``Collection.search`` span opens under the profiler, on the
card's timeline), over the number of ranges.  A fixed schedule launches
the same ops every call, so this is a count, not a time."""

import bisect


def read(run):
    trace = run.trace
    spans = trace.ranges.get("store.search", []) if trace is not None else []
    if not spans:
        return None
    starts = [s for s, _ in spans]
    count = 0
    for _, s, e in trace.ops:
        j = bisect.bisect_right(starts, s) - 1
        if j >= 0 and spans[j][0] <= s and e <= spans[j][1]:
            count += 1
    return count / len(spans)
