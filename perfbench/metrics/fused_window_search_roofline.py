"""Kernel B1's share of its roofline, %: the least time its launches
could take on this card (bytes over the HBM rate or operations over the
float32 rate, the larger, per launch; ``perfbench/roofline/``) over the
device time the profiler gave them, both as a mean over the traced
launches."""

KERNEL = "fused_window_search"


def read(run):
    calls = run.kernel_calls.get(KERNEL) or []
    mod = run.roofline.get(KERNEL)
    if not calls or mod is None or run.trace is None or run.peaks is None:
        return None
    times = run.trace.kernel_times(mod.KERNEL)
    if not times:
        return None
    bounds = []
    for rec in calls:
        in_b, out_b, ops = mod.work(rec)
        t_bytes = (in_b + out_b) / run.peaks["hbm_bytes_per_s"]
        t_ops = sum(v / run.peaks[rate] for rate, v in ops.items())
        bounds.append(max(t_bytes, t_ops))
    return 100.0 * (sum(bounds) / len(bounds)) / (sum(times) / len(times))
