"""Host milliseconds of one ``Collection.search`` call (to its return,
not its completion: the search enqueues its work and returns), the mean
over the window's calls outside the profiled part; a span the harness
records around each call."""

import statistics


def read(run):
    spans = run.host_spans_ms()
    return statistics.fmean(spans) if spans else None
