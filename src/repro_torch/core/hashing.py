"""p-stable LSH hashing for DB-LSH (paper Eq. 3 / Eq. 4).

The dynamic LSH family is ``h(o) = a . o`` with ``a ~ N(0, I_d)`` (Eq. 3).
Two points collide at width ``w`` iff ``|h(o1) - h(o2)| <= w/2``; the
collision probability for points at distance ``tau`` is (Eq. 4)

    p(tau; w) = P(|N(0,1)| <= w / (2 tau)) = erf(w / (2 sqrt(2) tau)).
"""

from __future__ import annotations

import math

import torch

from ..device import full_fp32

__all__ = ["sample_projections", "project", "collision_prob"]


def sample_projections(generator: torch.Generator, d: int, K: int, L: int,
                       device=None) -> torch.Tensor:
    """Sample L compound hashes G_i = (h_i1 .. h_iK): an (L, K, d) tensor
    of i.i.d. standard-normal projection vectors (paper Eq. 6/7).  Drawn
    on the generator's device, then moved to ``device``."""
    a = torch.randn((L, K, d), generator=generator, device=generator.device,
                    dtype=torch.float32)
    return a.to(device if device is not None else generator.device)


def project(data: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """G_i(o) for every point and table: (n, d) x (L, K, d) -> (L, n, K),
    table-major (the layout the STR index consumes).  Full fp32."""
    with full_fp32():
        return torch.einsum("lkd,nd->lnk", proj, data)


def collision_prob(tau, w):
    """Collision probability p(tau; w) of the dynamic family (paper Eq. 4).

    p(tau; w) = erf(w / (2 sqrt(2) tau)); decreasing in tau, increasing
    in w.  Float32 like the reference (which runs without x64)."""
    tau = torch.as_tensor(tau, dtype=torch.float32)
    return torch.special.erf(w / (2.0 * math.sqrt(2.0) * tau))
