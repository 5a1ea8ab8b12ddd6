"""Reference side of the port's parity tests.

The only test module that imports ``repro``: it builds reference
fixtures and hands them over as numpy arrays, so the port's tests feed
the same inputs to both packages.  Pallas kernels run in interpret mode,
as the reference's own tests run them on the CPU.
"""

from __future__ import annotations

import dataclasses
import os

# the reference's float32 numerics are its CPU ones (on a GPU, JAX runs
# float32 matmuls in TF32); this takes effect when nothing imported JAX yet
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import DBLSHParams, brute_force, build, collision_prob, merge_dedup_topk
from repro.core import search_batch_fixed
from repro.core.serve_search import _select_blocks
from repro.data import make_clustered, normalize_scale
from repro.kernels import fused_cand_search, fused_window_search
from repro.kernels.ref import candidate_dist_ref, fused_search_ref, window_dist_ref
from repro.kernels.window_verify import merge_topk

__all__ = [
    "DBLSHParams",
    "brute_force",
    "build",
    "collision_prob",
    "merge_dedup_topk",
    "merge_topk",
    "search_batch_fixed",
    "index_arrays",
    "index_params",
    "onepass_fixture",
    "build_from",
    "ref_index_from_arrays",
    "select_blocks",
    "fused_window",
    "fused_cand",
]

INDEX_FIELDS = (
    "proj_vecs", "proj_blocks", "ids_blocks", "mbr_lo", "mbr_hi", "data",
    "vec_blocks", "norm_blocks",
)


def index_arrays(index) -> dict:
    """A reference index as (writable) numpy arrays of its snapshot tree."""
    return {f: np.array(getattr(index, f)) for f in INDEX_FIELDS}


def index_params(index) -> dict:
    return dataclasses.asdict(index.params)


def onepass_fixture(max_blocks: int = 32):
    """The data, queries and index of ``tests/test_onepass_search.py``'s
    fixture (n = 2048, d = 24, K = 8, L = 3, inline vectors); with the
    default ``max_blocks == nb`` selection never truncates."""
    kd, kb = jax.random.split(jax.random.key(29))
    allpts = make_clustered(kd, 2080, 24, n_clusters=12, spread=0.02)
    data, queries = allpts[:2048], allpts[2048:]
    data, queries, _ = normalize_scale(data, queries)
    params = DBLSHParams.derive(
        n=2048, d=24, c=1.5, t=48, k=10, K=8, L=3,
        inline_vectors=True, max_blocks=max_blocks,
    )
    index = build(kb, data, params)
    return np.array(data), np.array(queries), index


def ref_index_from_arrays(arrays: dict, params: dict):
    """A reference index made from (possibly edited) snapshot arrays."""
    from repro.core import DBLSHIndex

    return DBLSHIndex(
        **{f: jnp.asarray(arrays[f]) for f in INDEX_FIELDS},
        qvec_blocks=jnp.zeros((0,), jnp.int8), qvec_scale=jnp.zeros((0,)),
        params=DBLSHParams(**params),
    )


def build_from(data: np.ndarray, params, proj_vecs: np.ndarray):
    """Reference ``build`` with given hash functions: the reference draws
    them from its key, so swap them in before the arrays are derived."""
    from repro.core import index as ridx

    orig = ridx.hashing.sample_projections
    ridx.hashing.sample_projections = lambda key, d, K, L: jnp.asarray(proj_vecs)
    try:
        return build(jax.random.key(0), jnp.asarray(data), params)
    finally:
        ridx.hashing.sample_projections = orig


def select_blocks(index, Q: np.ndarray, w: float):
    """Reference selection on its own query projections: (blk, bhw, G)."""
    G = jnp.einsum("lkd,qd->qlk", index.proj_vecs, jnp.asarray(Q))
    blk, bhw = _select_blocks(index, G, jnp.float32(w))
    return np.asarray(blk), np.asarray(bhw), np.asarray(G)


def fused_window(blk, halves, proj, vec, nrm, ids, g, q, *, M, ks, n, mode):
    """Reference B1 in interpret mode, and its pool oracle."""
    args = [jnp.asarray(a) for a in (blk, halves, proj, vec, nrm, ids, g, q)]
    got = fused_window_search(*args, M=M, ks=ks, n=n, mode=mode, interpret=True)
    d2, hw = window_dist_ref(args[0], args[2], args[3], args[4], args[6], args[7],
                             M, exact=(mode == "exact"))
    pool_ids = jnp.take(args[5], args[0], axis=0, mode="fill",
                        fill_value=n).reshape(blk.shape[0], -1)
    oracle = fused_search_ref(d2, hw, pool_ids, args[1], n, ks)
    return tuple(map(np.asarray, got)), oracle


def fused_cand(cp, cx, cn, ci, halves, g, q, *, ks, n, mode):
    """Reference B2 in interpret mode, and its pool oracle."""
    args = [jnp.asarray(a) for a in (cp, cx, cn, ci, halves, g, q)]
    got = fused_cand_search(*args, ks=ks, n=n, mode=mode, tile_c=64, interpret=True)
    d2, hw = candidate_dist_ref(args[0], args[1], args[2], args[5], args[6],
                                exact=(mode == "exact"))
    oracle = fused_search_ref(d2, hw, ci.reshape(cp.shape[0], -1), halves, n, ks)
    return tuple(map(np.asarray, got)), oracle
