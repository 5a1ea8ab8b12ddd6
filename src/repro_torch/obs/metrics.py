"""Process-wide metrics registry: counters, gauges, fixed-bucket
histograms, with Prometheus-text and JSON exporters.

This is the numeric half of ``repro_torch.obs``: every quantity the serving
stack used to keep in ad-hoc per-service structs (``svc.stats()`` /
``svc.tenant_stats()``) now lives in a :class:`MetricsRegistry` the
whole process can scrape.  The service API is unchanged — its snapshot
methods *read* the registry — but the same numbers are now exportable
(``/metrics``-style text, JSON artifacts from benchmarks) and consumable
by the SLO watch (:mod:`repro_torch.obs.slo`) without private access.

Naming scheme (DESIGN.md §10): ``repro_store_<noun>[_total]`` with
snake_case label keys (``collection``, ``tenant``, ``engine``, ``step``).
``_total`` marks monotonic counters, matching Prometheus convention.

Histograms serve two consumers at once:

* **fixed buckets** (cumulative ``le`` counts + sum + count) — the
  exportable shape, mergeable across scrapes;
* an optional bounded **sample window** (most recent ``window``
  observations) — exact rolling percentiles for ``svc.stats()`` and the
  SLO watch, because bucket-interpolated p99s are too coarse to gate on.
  The window is a ring: long-lived processes don't grow memory.

All mutators take label kwargs; a (name, sorted-labels) pair is one
series.  Metrics are get-or-create (:meth:`MetricsRegistry.counter` et
al. return the existing family when re-declared), so independent
subsystems can share one registry without import-order coupling.
"""

from __future__ import annotations

import json
import math
from bisect import bisect_left
from collections import deque

import numpy as np

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_registry",
    "get_registry",
    "LATENCY_MS_BUCKETS",
]

# Default latency buckets (ms): decade-ish ladder from sub-ms dispatch
# to multi-second stalls, +inf implied.
LATENCY_MS_BUCKETS = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0,
)


def _labelkey(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class _Family:
    """Shared series bookkeeping for one named metric."""

    kind = "untyped"

    def __init__(self, name: str, help: str):
        self.name = name
        self.help = help
        self._series: dict[tuple, object] = {}

    def series(self):
        """Yield (labels_dict, series_state) pairs, label-sorted."""
        for key in sorted(self._series):
            yield dict(key), self._series[key]

    def labels_seen(self) -> list[dict]:
        return [dict(k) for k in sorted(self._series)]


class Counter(_Family):
    """Monotonic counter (per label set)."""

    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        assert value >= 0, f"counter {self.name} cannot decrease"
        key = _labelkey(labels)
        self._series[key] = self._series.get(key, 0.0) + value

    def value(self, **labels) -> float:
        return float(self._series.get(_labelkey(labels), 0.0))


class Gauge(_Family):
    """Set-to-current-value metric (queue depth, ring occupancy)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._series[_labelkey(labels)] = float(value)

    def inc(self, value: float = 1.0, **labels) -> None:
        key = _labelkey(labels)
        self._series[key] = self._series.get(key, 0.0) + value

    def value(self, **labels) -> float:
        return float(self._series.get(_labelkey(labels), 0.0))


class _HistSeries:
    __slots__ = ("bucket_counts", "sum", "count", "window")

    def __init__(self, n_buckets: int, window: int):
        self.bucket_counts = [0] * (n_buckets + 1)  # +1: the +inf bucket
        self.sum = 0.0
        self.count = 0
        self.window = deque(maxlen=window) if window > 0 else None


class Histogram(_Family):
    """Fixed-bucket histogram + bounded exact-percentile window.

    ``buckets`` are upper bounds (ascending, +inf implied).  Bucket
    counts are stored per-bucket and exported cumulative (Prometheus
    ``le`` semantics).
    """

    kind = "histogram"

    def __init__(self, name: str, help: str,
                 buckets=LATENCY_MS_BUCKETS, window: int = 0):
        super().__init__(name, help)
        b = tuple(float(x) for x in buckets)
        assert b == tuple(sorted(b)) and len(set(b)) == len(b), (
            f"histogram {name}: buckets must strictly ascend: {b}"
        )
        self.buckets = b
        self.window_size = int(window)

    def _get(self, labels) -> _HistSeries:
        key = _labelkey(labels)
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = _HistSeries(
                len(self.buckets), self.window_size
            )
        return s

    def observe(self, value: float, **labels) -> None:
        s = self._get(labels)
        s.bucket_counts[bisect_left(self.buckets, value)] += 1
        s.sum += value
        s.count += 1
        if s.window is not None:
            s.window.append(value)

    # ----------------------------------------------------------- queries
    def count(self, **labels) -> int:
        key = _labelkey(labels)
        s = self._series.get(key)
        return 0 if s is None else s.count

    def sum(self, **labels) -> float:
        key = _labelkey(labels)
        s = self._series.get(key)
        return 0.0 if s is None else s.sum

    def mean(self, **labels) -> float:
        key = _labelkey(labels)
        s = self._series.get(key)
        return s.sum / s.count if s is not None and s.count else 0.0

    def percentile(self, q, **labels):
        """Exact percentile(s) over the rolling sample window (0 when
        the window is empty or disabled) — the ``svc.stats()`` / SLO
        consumer.  ``q`` may be a scalar or a sequence."""
        key = _labelkey(labels)
        s = self._series.get(key)
        if s is None or s.window is None or not s.window:
            return (np.zeros(len(q)) if np.ndim(q) else 0.0)
        return np.percentile(np.asarray(s.window, np.float64), q)

    def cumulative_buckets(self, **labels) -> list[tuple[float, int]]:
        """(upper_bound, cumulative_count) per bucket, +inf last."""
        key = _labelkey(labels)
        s = self._series.get(key)
        counts = (
            [0] * (len(self.buckets) + 1) if s is None else s.bucket_counts
        )
        out, acc = [], 0
        for ub, c in zip(self.buckets + (math.inf,), counts):
            acc += c
            out.append((ub, acc))
        return out


class MetricsRegistry:
    """Get-or-create registry of metric families."""

    def __init__(self):
        self._families: dict[str, _Family] = {}

    def _declare(self, cls, name: str, help: str, **kw):
        fam = self._families.get(name)
        if fam is not None:
            if not isinstance(fam, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {fam.kind}, "
                    f"not {cls.kind}"
                )
            return fam
        fam = self._families[name] = cls(name, help, **kw)
        return fam

    def counter(self, name: str, help: str = "") -> Counter:
        return self._declare(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._declare(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets=LATENCY_MS_BUCKETS, window: int = 0) -> Histogram:
        return self._declare(Histogram, name, help, buckets=buckets,
                             window=window)

    def get(self, name: str) -> _Family | None:
        return self._families.get(name)

    def families(self):
        for name in sorted(self._families):
            yield self._families[name]

    # ------------------------------------------------------------- export
    @staticmethod
    def _escape_label_value(v) -> str:
        # text exposition format: backslash, double-quote, and newline
        # must be escaped inside label values (backslash first, or the
        # other escapes get double-escaped)
        return (
            str(v)
            .replace("\\", "\\\\")
            .replace('"', '\\"')
            .replace("\n", "\\n")
        )

    @classmethod
    def _fmt_labels(cls, labels: dict, extra: dict | None = None) -> str:
        merged = dict(labels)
        if extra:
            merged.update(extra)
        if not merged:
            return ""
        inner = ",".join(
            f'{k}="{cls._escape_label_value(v)}"'
            for k, v in sorted(merged.items(), key=lambda kv: str(kv[0]))
        )
        return "{" + inner + "}"

    @staticmethod
    def _fmt_num(v: float) -> str:
        if v == math.inf:
            return "+Inf"
        f = float(v)
        return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        lines = []
        for fam in self.families():
            lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            if isinstance(fam, Histogram):
                for labels, s in fam.series():
                    for ub, acc in fam.cumulative_buckets(**labels):
                        lab = self._fmt_labels(labels, {"le": self._fmt_num(ub)})
                        lines.append(f"{fam.name}_bucket{lab} {acc}")
                    lab = self._fmt_labels(labels)
                    lines.append(f"{fam.name}_sum{lab} {self._fmt_num(s.sum)}")
                    lines.append(f"{fam.name}_count{lab} {s.count}")
            else:
                for labels, v in fam.series():
                    lab = self._fmt_labels(labels)
                    lines.append(f"{fam.name}{lab} {self._fmt_num(v)}")
        # an empty registry exports valid (empty) text, not a bare "\n"
        return "\n".join(lines) + "\n" if lines else ""

    def to_json(self) -> dict:
        """JSON-serializable dump: the benchmark / CI artifact shape."""
        out = {}
        for fam in self.families():
            series = []
            if isinstance(fam, Histogram):
                for labels, s in fam.series():
                    series.append({
                        "labels": labels,
                        "sum": s.sum,
                        "count": s.count,
                        "buckets": [
                            {"le": ub if math.isfinite(ub) else "+Inf",
                             "count": acc}
                            for ub, acc in fam.cumulative_buckets(**labels)
                        ],
                    })
            else:
                for labels, v in fam.series():
                    series.append({"labels": labels, "value": v})
            out[fam.name] = {
                "type": fam.kind, "help": fam.help, "series": series,
            }
        return out

    def export_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2)

    def export_prometheus(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_prometheus())


# One process-wide registry for callers that want a shared scrape
# surface; services default to a private registry (deterministic tests,
# no cross-service bleed) and can be handed this one explicitly.
default_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return default_registry
