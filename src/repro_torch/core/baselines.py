"""Baselines (paper §VI-A).  Only the exact k-NN oracle is ported so far;
FBLSH, MQIndex and C2Index come later."""

from __future__ import annotations

import torch

from ..device import as_tensor, full_fp32, resolve_device

__all__ = ["brute_force"]


def brute_force(data, Q, k: int = 50, *, device=None):
    """Exact k-NN via ||q||^2 - 2 q.x + ||x||^2 (full fp32).
    Returns (dists, ids) of shape (Qn, k), ids int64."""
    device = resolve_device(device)
    data = as_tensor(data, device)
    Q = as_tensor(Q, device)
    qn = torch.sum(torch.square(Q), dim=-1, keepdim=True)
    xn = torch.sum(torch.square(data), dim=-1)
    with full_fp32():
        d2 = torch.clamp(qn - 2.0 * Q @ data.T + xn, min=0.0)
    neg, ids = torch.topk(-d2, k, dim=1)
    return torch.sqrt(-neg), ids
