"""The readers of the port's search spans on a device trace
(``merge.idle_ms.batch``, ``search.device_ops.batch``) on synthetic
traces, and the traced and untraced CPU runs around them: the port's
ranges reach the trace's summary, a run leaves the port's tracer as it
found it, and a reader with nothing to read leaves its metric out."""

from __future__ import annotations

import pytest
import torch

from perfbench import harness
from perfbench.profread import TraceSummary

torch.set_num_threads(1)

SMALL = {"config": {"n": 6_000, "d": 96},
         "traffic": {"batch": 64, "pool_per_s": 2000, "check_requests": 4, "check_rows": 48}}


class _Run:
    def __init__(self, trace):
        self.trace = trace


def _read(metric, trace):
    return harness.load_module("metrics", metric).read(_Run(trace))


def _summary(ops, host=(), ranges=None, window=(0, 1_000_000)):
    return TraceSummary(window_ns=window, ops=sorted(ops, key=lambda r: r[1]),
                        ranges=ranges or {}, host=sorted(host, key=lambda r: r[1]))


def test_a_gap_counts_for_the_merge_where_its_middle_lies_in_a_merge_range():
    # ops at [0, 100k], [300k, 400k], [460k, 470k], [900k, 1M]: gaps of 200k
    # (middle 200k), 60k (middle 430k), 430k (middle 685k)
    ops = [("k", 0, 100_000), ("k", 300_000, 400_000), ("k", 460_000, 470_000),
           ("k", 900_000, 1_000_000)]
    host = [("store.search", 90_000, 480_000),
            ("dblsh.merge", 150_000, 250_000),   # holds the first gap's middle
            ("dblsh.merge", 410_000, 420_000),   # holds no gap's middle
            ("dblsh.select", 600_000, 800_000)]  # the third gap: not the merge's
    got = _read("merge.idle_ms.batch", _summary(ops, host))
    assert got == pytest.approx(200_000 / 1e6 / 2)
    # the breakdown labels the same gap by the same range
    summary = _summary(ops, host)
    assert dict(summary.idle_gaps())["dblsh.merge"] * 1e3 == pytest.approx(2 * got)
    # a gap under 20 us is no idle time
    short = [("k", 0, 100_000), ("k", 119_000, 1_000_000)]
    assert _read("merge.idle_ms.batch",
                 _summary(short, [("dblsh.merge", 100_000, 119_000)])) == 0.0
    # ranges that start outside the window are not the window's calls
    assert _read("merge.idle_ms.batch",
                 _summary(ops, [("dblsh.merge", 2_000_000, 2_100_000)])) is None


def test_the_merge_reader_finds_nothing_without_device_ops_or_merge_ranges():
    assert _read("merge.idle_ms.batch", None) is None
    assert _read("merge.idle_ms.batch", _summary([], [("dblsh.merge", 0, 10)])) is None
    assert _read("merge.idle_ms.batch",
                 _summary([("k", 0, 10)], [("dblsh.select", 0, 10)])) is None


def test_device_ops_count_only_the_ops_inside_the_search_ranges():
    ops = [("a", 10, 20), ("b", 30, 40), ("c", 45, 60),    # call 1: 2 inside
           ("d", 100, 110), ("e", 120, 130), ("f", 140, 150), ("g", 155, 158),
           ("h", 300, 310)]                                # after every call
    ranges = {"store.search": [(10, 41), (100, 158)], "dblsh.merge": [(0, 400)]}
    assert _read("search.device_ops.batch", _summary(ops, ranges=ranges)) == (2 + 4) / 2
    # a program that opens no such range (the parent's) gives nothing to read
    assert _read("search.device_ops.batch",
                 _summary(ops, ranges={"dblsh.merge": [(0, 400)]})) is None
    assert _read("search.device_ops.batch", None) is None


@pytest.fixture
def views(monkeypatch):
    """The ``RunView`` of each traced run, kept for the test."""
    kept = []
    make = harness.RunView

    def keep(**kw):
        kept.append(make(**kw))
        return kept[-1]

    monkeypatch.setattr(harness, "RunView", keep)
    return kept


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_a_cpu_run_leaves_the_ports_tracer_as_it_found_it(trace, views):
    """Neither run enables the port's tracer (``--trace 0`` changes
    nothing in the program); the traced one profiles the port's own
    ``store.search`` and ``dblsh.*`` ranges on the host, and its device
    readers, finding no device ops on the CPU, leave their metrics out."""
    from repro_torch.obs import get_tracer

    tracer = get_tracer()
    assert not tracer.enabled and not tracer.events
    result, _ = harness.run_cell("gist1m.batch1024", 2**31 + 11, 0.6, trace, device="cpu",
                                 overrides=SMALL)
    assert result["correct"]
    assert not tracer.enabled and not tracer.events
    if not trace:
        assert views == [] and "merge.idle_ms.batch" not in result["metrics"]
        return
    (view,) = views
    host = {name for name, _, _ in view.trace.host}
    assert {"store.search", "dblsh.project", "dblsh.select", "dblsh.verify",
            "dblsh.merge"} <= host
    assert "store.dispatch" not in " ".join(host)
    assert "search.host_ms.batch" in result["metrics"]
    assert "merge.idle_ms.batch" not in result["metrics"]
    assert "search.device_ops.batch" not in result["metrics"]
