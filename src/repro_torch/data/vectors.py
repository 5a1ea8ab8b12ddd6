"""Vector-dataset generators (the port of ``repro.data.vectors``).

Clustered data with controllable local intrinsic dimensionality: points
live near a mixture of low-dimensional Gaussian pancakes embedded in R^d.
The distribution is the reference's; the numbers are not (a
``torch.Generator`` is not a ``jax.random`` key).  Tests that compare
against the reference take their data from the reference instead.
"""

from __future__ import annotations

import math

import torch

from ..device import full_fp32, resolve_device

__all__ = ["make_clustered", "make_uniform", "paper_dataset_specs", "normalize_scale"]

# Table III of the paper (cardinality, dimensionality).
paper_dataset_specs = {
    "audio": (54_387, 192),
    "mnist": (60_000, 784),
    "cifar": (60_000, 1024),
    "trevi": (101_120, 4096),
    "nus": (269_648, 500),
    "deep1m": (1_000_000, 256),
    "gist": (1_000_000, 960),
    "sift10m": (10_000_000, 128),
    "tiny80m": (79_302_017, 384),
    "sift100m": (100_000_000, 128),
}


def make_uniform(generator: torch.Generator, n: int, d: int, *, device=None) -> torch.Tensor:
    """Uniform points in [-1, 1)^d, drawn on the generator's device; the
    result lies on ``device`` (the CUDA device when None)."""
    device = resolve_device(device)
    u = torch.rand((n, d), generator=generator, device=generator.device)
    return (u * 2.0 - 1.0).to(device)


def make_clustered(
    generator: torch.Generator,
    n: int,
    d: int,
    n_clusters: int = 32,
    intrinsic_dim: int | None = None,
    spread: float = 0.05,
    *,
    device=None,
) -> torch.Tensor:
    """Gaussian-mixture data on low-dimensional pancakes in R^d.

    Each cluster has a random center in [-1,1]^d and covariance of rank
    ``intrinsic_dim`` (default d//8) with per-axis scale ``spread``.
    Random numbers are drawn on the generator's device; the result lies
    on ``device`` (the CUDA device when None)."""
    device = resolve_device(device)
    kid = intrinsic_dim or max(2, d // 8)
    gd = generator.device
    centers = torch.rand((n_clusters, d), generator=generator, device=gd) * 2.0 - 1.0
    basis = torch.randn((n_clusters, kid, d), generator=generator, device=gd) / math.sqrt(d)
    assign = torch.randint(0, n_clusters, (n,), generator=generator, device=gd)
    coeff = torch.randn((n, kid), generator=generator, device=gd) * (spread * math.sqrt(d))
    centers, basis, assign, coeff = (
        t.to(device) for t in (centers, basis, assign, coeff)
    )
    # per-point coeff @ basis[assign], one cluster at a time: never
    # materializes the (n, kid, d) gathered basis
    pts = centers[assign]
    for c in range(n_clusters):
        rows = torch.nonzero(assign == c).squeeze(1)
        with full_fp32():
            pts[rows] += coeff[rows] @ basis[c]
    return pts.to(torch.float32)


def normalize_scale(data: torch.Tensor, queries: torch.Tensor,
                    target_nn: float = 1.0):
    """Rescale data so the typical NN distance is ~``target_nn`` — the
    paper assumes r0 = 1 WLOG (§III-A); this realizes that WLOG.
    Returns (data, queries, scale)."""
    m = min(512, queries.shape[0])
    sample = queries[:m]
    with full_fp32():
        d2 = (
            torch.sum(torch.square(sample), -1, keepdim=True)
            - 2.0 * sample @ data.T
            + torch.sum(torch.square(data), -1)
        )
    nn = torch.sqrt(torch.clamp(d2.min(dim=-1).values, min=1e-12))
    # quantile interpolates like jnp.median (mean of the middle pair)
    scale = target_nn / torch.quantile(nn, 0.5)
    return data * scale, queries * scale, float(scale)
