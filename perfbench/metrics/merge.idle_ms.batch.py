"""Device idle milliseconds of the merge stage a search call
(``core.serve_search.search_batch_fixed``: eight masked merges whose small
launches the host paces): the device's idle gaps of at least 20 us in the
traced window whose middle falls inside a host-side ``dblsh.merge`` range
(the profiler's record of the port's merge span), summed, over the number
of those ranges.  Nothing to read without device ops."""

import bisect

STAGE = "dblsh.merge"
MIN_GAP_NS = 20_000  # as the breakdown's idle gaps


def read(run):
    trace = run.trace
    if trace is None or not trace.ops:
        return None
    lo, hi = trace.window_ns
    spans = [(s, e) for name, s, e in trace.host if name == STAGE and lo <= s < hi]
    if not spans:
        return None
    starts = [s for s, _ in spans]
    idle, prev = 0, lo
    for _, s, e in trace.ops + [("", hi, hi)]:
        s = max(s, lo)
        if s - prev >= MIN_GAP_NS:
            mid = (prev + s) // 2
            j = bisect.bisect_right(starts, mid) - 1
            if j >= 0 and mid <= spans[j][1]:
                idle += s - prev
        prev = max(prev, min(e, hi))
    return idle / 1e6 / len(spans)
