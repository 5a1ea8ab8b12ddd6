"""The benchmark's inputs, made from the seed: vectors, a held-out query
pool, the hash functions and the initial radius.

The vectors follow ``repro_torch.data.make_clustered`` (Gaussian pancakes
of low intrinsic dimension around random centers), rewritten here so the
yardstick does not move with the program.  Two changes make every
product of the search exact in float32, so the port's answers can be held
to the reference's bit for bit:

* the vectors are whole numbers in ``[value_min, value_max]`` (SIFT
  descriptors are bytes; the GIST-like set is a fixed-point quantization),
  centred on 0 (DB-LSH is translation-equivariant);
* the hash functions are N(0, 1) draws rounded to multiples of
  ``2**-grid_bits`` and clipped to ``[-clip, clip]``.

A projection is then a multiple of ``2**-grid_bits`` that a float32 sum
holds exactly in any order, as long as its positive and negative parts
stay under ``2**(23 - grid_bits)``; ``check_exact`` proves that for every
vector and hash function before a run starts.  With ``grid_bits = 10`` and
``clip = 3`` the hash entries of magnitude 2 to 3 carry 12 significant
bits, so a TF32 product (11 bits) changes the projections: the benchmark
still sees a lower-precision path.

``normalize_scale`` of the program rescales the data so the median
nearest-neighbour distance is 1; DB-LSH is scale-equivariant (windows
scale with the radius), so here the radius is scaled instead and the data
stay whole numbers: ``r0 = r0_nn * median NN distance`` of a sample of
the pool.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = ["Inputs", "make_inputs", "cluster_model", "make_vectors", "hash_functions", "check_exact",
           "digest", "median_nn"]

_EXACT_UNITS = 2 ** 23  # projections stay under this many grid units


@dataclasses.dataclass
class Inputs:
    data: torch.Tensor   # (n, d) float32 whole numbers, on the device
    pool: np.ndarray     # (P, d) float32 held-out queries, on the host
    proj: torch.Tensor   # (L, K, d) float32 hash functions, on the device
    r0: float            # the schedule's first radius (a float32 value)
    digest: tuple        # of data, pool and proj: a regeneration must match


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device).manual_seed(int(seed) % (1 << 63))


def cluster_model(gen: torch.Generator, d: int, spec: dict) -> tuple:
    """(centers, basis) of the configuration's ``data`` block:
    ``n_clusters`` centers uniform in ``[center_min, center_max]^d``, each
    with a rank-``intrinsic_dim`` basis of N(0, 1/d) rows."""
    if spec["kind"] != "clustered_int":
        raise ValueError(f"unknown data kind {spec['kind']!r}")
    C, kid = int(spec["n_clusters"]), int(spec["intrinsic_dim"])
    gd = gen.device
    lo_c = float(spec["center_min"])
    centers = torch.rand((C, d), generator=gen, device=gd) * (float(spec["center_max"]) - lo_c) + lo_c
    basis = torch.randn((C, kid, d), generator=gen, device=gd) / math.sqrt(d)
    return centers, basis


def chunk_rows(d: int, kid: int) -> int:
    """Rows drawn at a time: 65,536, or fewer where the gathered bases of a
    chunk would pass 1 GiB."""
    return max(1, min(1 << 16, (1 << 30) // (4 * kid * d)))


def make_vectors(gen: torch.Generator, model: tuple, count: int, spec: dict):
    """Yield ``(start, rows)`` chunks of ``count`` clustered whole-number
    vectors on the generator's device: each row picks a cluster, takes
    ``axis_std`` per coordinate along its basis, and is rounded and
    clipped to ``[value_min, value_max]``.  Every chunk draws a whole
    chunk's numbers, so the first rows do not depend on ``count``."""
    centers, basis = model
    C, kid, d = basis.shape
    gd = gen.device
    scale = float(spec["axis_std"]) * math.sqrt(d / kid)
    lo, hi = float(spec["value_min"]), float(spec["value_max"])
    step = chunk_rows(d, kid)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for s in range(0, count, step):
            m = min(step, count - s)
            a = torch.randint(0, C, (step,), generator=gen, device=gd)[:m]
            coeff = torch.randn((step, 1, kid), generator=gen, device=gd)[:m] * scale
            rows = centers[a] + torch.bmm(coeff, basis[a]).squeeze(1)
            yield s, rows.round_().clamp_(lo, hi)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def hash_functions(gen: torch.Generator, L: int, K: int, d: int, spec: dict,
                   device) -> torch.Tensor:
    """(L, K, d) N(0, 1) draws on the ``2**-grid_bits`` grid, in
    ``[-clip, clip]``."""
    scale = float(2 ** int(spec["grid_bits"]))
    a = torch.randn((L, K, d), generator=gen, device=gen.device, dtype=torch.float32)
    a = torch.clamp(torch.round(a * scale) / scale, -float(spec["clip"]), float(spec["clip"]))
    return a.to(device)


def check_exact(x: torch.Tensor, proj: torch.Tensor, grid_bits: int) -> None:
    """Raise unless every float32 sum of the search is exact on these
    inputs: the positive and the negative part of each projection under
    ``2**23`` grid units (so a difference of two stays under ``2**24``),
    and every squared norm under ``2**22``."""
    a = proj.reshape(-1, proj.shape[-1]).double()
    rows = max(1, (1 << 27) // x.shape[1])  # 1 GiB of float64 a temporary
    ap, an = a.clamp(min=0.0).T, (-a).clamp(min=0.0).T
    worst, worst_n2 = 0.0, 0.0
    for s in range(0, x.shape[0], rows):
        xs = x[s:s + rows].double()
        xp, xn = xs.clamp(min=0.0), (-xs).clamp(min=0.0)
        pos = xp @ ap + xn @ an  # the sum of a projection's positive terms
        neg = xp @ an + xn @ ap  # and of its negative ones
        worst = max(worst, float(pos.max()), float(neg.max()))
        worst_n2 = max(worst_n2, float((xs * xs).sum(dim=1).max()))
    units = worst * 2 ** grid_bits
    if units >= _EXACT_UNITS or worst_n2 >= 2 ** 22:
        raise ValueError(
            f"inputs leave the exact float32 range: projection parts {units:.0f} grid units "
            f"(limit {_EXACT_UNITS}), squared norm {worst_n2:.0f} (limit {2 ** 22})")


def median_nn(data: torch.Tensor, sample: torch.Tensor, rows: int = 1 << 20) -> float:
    """Median over ``sample`` of the distance to its nearest vector in
    ``data``.  Whole-number inputs under ``check_exact`` make every
    squared distance exact in float32 (TF32 off)."""
    q2 = (sample * sample).sum(dim=1, keepdim=True)
    best = torch.full((sample.shape[0],), torch.inf, device=sample.device)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for s in range(0, data.shape[0], rows):
            xs = data[s:s + rows]
            d2 = q2 - 2.0 * (sample @ xs.T) + (xs * xs).sum(dim=1)[None]
            best = torch.minimum(best, d2.amin(dim=1))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return float(torch.quantile(torch.sqrt(torch.clamp(best, min=0.0)), 0.5))


def digest(t: torch.Tensor, scale: float = 1.0, start: int = 0, rows: int = 1 << 20) -> tuple:
    """Two weighted integer sums of ``t * scale`` (whole numbers), its rows
    numbered from ``start``: a regenerated input that differs anywhere
    changes one of them; the sums of a tensor's chunks add up to its own."""
    flat = t.reshape(t.shape[0], -1)
    cols = torch.arange(1, flat.shape[1] + 1, device=t.device, dtype=torch.int64)
    a = b = 0
    for s in range(0, flat.shape[0], rows):
        v = (flat[s:s + rows] * scale).to(torch.int64)
        rws = torch.arange(start + s, start + s + v.shape[0], device=t.device, dtype=torch.int64) % 997 + 1
        a += int((v * cols).sum())
        b += int((v * rws[:, None]).sum())
    return a, b


def make_inputs(config: dict, traffic: dict, seed: int, pool_size: int, device) -> Inputs:
    """Everything a run feeds the port and the reference, from ``seed``:
    the same seed gives the same inputs, bit for bit.  The draws come in
    a fixed order (the clusters, the vectors, the hash functions, then
    the pool), so the pool's first rows do not depend on its size.  The
    pool is made on the device and goes to the host in one copy."""
    n, d = int(config["n"]), int(config["d"])
    ix = config["index"]
    grid = int(config["hash"]["grid_bits"])
    gen = _generator(seed, device)
    model = cluster_model(gen, d, config["data"])
    data = torch.empty((n, d), dtype=torch.float32, device=device)
    for s, rows in make_vectors(gen, model, n, config["data"]):
        data[s:s + rows.shape[0]] = rows
    del rows
    proj = hash_functions(gen, int(ix["L"]), int(ix["K"]), d, config["hash"], device)
    check_exact(data, proj, grid)
    pool_dev = torch.empty((pool_size, d), dtype=torch.float32, device=device)
    for s, rows in make_vectors(gen, model, pool_size, config["data"]):
        pool_dev[s:s + rows.shape[0]] = rows
    del rows
    check_exact(pool_dev, proj, grid)
    m = min(int(traffic.get("nn_sample", 512)), pool_size)
    r0 = float(np.float32(float(traffic["r0_nn"]) * median_nn(data, pool_dev[:m])))
    dg = (digest(data), digest(pool_dev), digest(proj, float(2 ** grid)))
    pool = pool_dev.cpu().numpy()
    del pool_dev
    return Inputs(data=data, pool=pool, proj=proj, r0=r0, digest=dg)
