"""Device milliseconds of the verify stage a search call (kernel B1 on
engine ``inline``): the device ops inside the port's ``dblsh.verify``
ranges of the traced window, over the number of ranges."""


def read(run):
    if run.trace is None:
        return None
    seconds, count = run.trace.in_ranges("dblsh.verify")
    return seconds * 1e3 / count if count else None
