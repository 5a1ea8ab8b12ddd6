"""Device milliseconds of the selection stage a search call
(``core.serve_search._select_blocks``): the device ops inside the port's
``dblsh.select`` ranges of the traced window, over the number of ranges."""


def read(run):
    if run.trace is None:
        return None
    seconds, count = run.trace.in_ranges("dblsh.select")
    return seconds * 1e3 / count if count else None
