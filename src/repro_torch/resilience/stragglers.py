"""EWMA straggler detection — shared by training and serving.

Lifted out of ``repro_torch.runtime.fault_tolerance`` (which re-exports it for
backward compatibility) so the store can feed it batch dispatch
durations: the serving loop records each in-flight batch's
issue→complete wall time and flags batches that blow out the rolling
baseline — in a sharded deployment the classic signature of one
straggling shard holding the cross-shard merge hostage (the
``shard.straggle`` fault site in :mod:`repro_torch.resilience.faults`
injects exactly that).
"""

from __future__ import annotations

__all__ = ["StragglerMonitor"]


class StragglerMonitor:
    """EWMA-based step-time outlier detection."""

    def __init__(self, alpha: float = 0.1, threshold: float = 2.0, warmup: int = 3):
        self.alpha = alpha
        self.threshold = threshold
        self.warmup = warmup
        self.ewma = None
        self.count = 0
        self.flagged: list[tuple[int, float]] = []

    def record(self, step: int, duration: float) -> bool:
        """Returns True if this step is a straggler."""
        self.count += 1
        if self.ewma is None:
            self.ewma = duration
            return False
        is_slow = self.count > self.warmup and duration > self.threshold * self.ewma
        if is_slow:
            self.flagged.append((step, duration))
        else:
            # only fold non-outliers into the baseline
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * duration
        return is_slow
