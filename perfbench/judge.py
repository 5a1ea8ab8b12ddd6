"""What decides ``correct``: the port's answers against the reference's,
and the recall side information against exact nearest neighbours."""

from __future__ import annotations

import numpy as np

__all__ = ["wrong_answers", "quality"]


def wrong_answers(port_d: np.ndarray, port_i: np.ndarray, ref_d: np.ndarray,
                  ref_i: np.ndarray) -> int:
    """Query rows whose answer differs from the reference's in any id or
    in any distance's bits (the benchmark's inputs make every float32 sum
    exact, so an answer is either the reference's or wrong)."""
    port_d = np.ascontiguousarray(port_d, np.float32)
    ref_d = np.ascontiguousarray(ref_d, np.float32)
    bad = (port_d.view(np.int32) != ref_d.view(np.int32)) | (port_i.astype(np.int64)
                                                            != ref_i.astype(np.int64))
    return int(bad.any(axis=1).sum())


def quality(port_d: np.ndarray, true_d: np.ndarray) -> tuple[float, float]:
    """(recall@k, overall ratio) of answers against the exact k nearest
    distances: recall counts an answer within the true k-th distance, the
    ratio is the mean of ``port_j / true_j`` over ranks whose true
    distance is positive (an unfilled answer counts as a miss and is left
    out of the ratio)."""
    k = true_d.shape[1]
    hits = (port_d <= true_d[:, -1:] * (1 + 1e-6)) & np.isfinite(port_d)
    recall = float(hits.sum() / (k * true_d.shape[0]))
    ok = (true_d > 0) & np.isfinite(port_d)
    ratio = float((port_d[ok] / true_d[ok]).mean()) if ok.any() else float("nan")
    return recall, ratio
