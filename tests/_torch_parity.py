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
import torch  # noqa: E402

# one intra-op thread for the port's CPU ops: the test runner starts
# several workers on a few cores, and torch's per-op thread pools then
# oversubscribe the cores and slow the port's many small ops by ~10x
torch.set_num_threads(1)

from repro.core import DBLSHParams, brute_force, build, collision_prob, merge_dedup_topk
from repro.core import (
    Termination,
    probe_radius,
    rc_nn,
    search_batch,
    search_batch_fixed,
    search_batch_fixed_dispatch,
    search_batch_fixed_ref,
)
from repro.core import quantize_blocks as _quantize_blocks
from repro.core import updates
from repro.core.query import _dedup_merge
from repro.core.serve_search import _gather_pool, _merge_dedup_topk_lexsort, _select_blocks
from repro.data import make_clustered, normalize_scale
from repro.kernels import (
    candidate_dist,
    candidate_verify,
    fused_cand_search,
    fused_window_search,
    pairwise_l2,
    window_dist,
    window_verify,
)
from repro.kernels.ops import _quantize_query
from repro.kernels.ref import (
    candidate_dist_ref,
    candidate_verify_ref,
    fused_search_ref,
    pairwise_l2_ref,
    window_dist_ref,
    window_verify_ref,
)
from repro.kernels.window_verify import merge_topk

__all__ = [
    "DBLSHParams",
    "brute_force",
    "build",
    "collision_prob",
    "merge_dedup_topk",
    "merge_topk",
    "Termination",
    "probe_radius",
    "rc_nn",
    "search_batch",
    "search_batch_fixed",
    "search_batch_fixed_dispatch",
    "search_batch_fixed_ref",
    "core_fixture",
    "tune_fixture",
    "lexsort_merge",
    "project_one",
    "dedup_merge",
    "window_verify_both",
    "candidate_verify_both",
    "index_arrays",
    "index_params",
    "onepass_fixture",
    "build_from",
    "ref_index_from_arrays",
    "select_blocks",
    "fused_window",
    "fused_cand",
    "quantize_blocks",
    "quantize_query",
    "quant_arrays",
    "compact",
    "onepass_quant_fixture",
    "updates_fixture",
    "updates",
    "window_dist_both",
    "candidate_dist_both",
    "pairwise_l2_both",
    "gather_pool",
    "integer_projections",
    "key",
    "ref_exports",
    "ref_modules",
    "resilience_fixture",
    "store_fixture",
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


def onepass_quant_fixture(dtype: str):
    """``tests/test_onepass_search.py::setup_quant``: the onepass fixture's
    data indexed with ``quant_dtype=dtype`` under the same key."""
    data, queries, _ = onepass_fixture()
    params = DBLSHParams.derive(
        n=2048, d=24, c=1.5, t=48, k=10, K=8, L=3,
        inline_vectors=True, max_blocks=32, quant_dtype=dtype,
    )
    index = build(jax.random.split(jax.random.key(29))[1], jnp.asarray(data), params)
    return data, queries, index


def updates_fixture(**derive_kw):
    """The data, inserts, queries and index of ``tests/test_updates.py``'s
    fixture (n = 2000, d = 24, K = 8, L = 3; the gather layout unless
    ``derive_kw`` says otherwise)."""
    kd, kb = jax.random.split(jax.random.key(21))
    allpts = make_clustered(kd, 3096, 24, n_clusters=12, spread=0.02)
    data, extra, queries = allpts[:2000], allpts[2000:3064], allpts[3064:]
    data, queries, scale = normalize_scale(data, queries)
    extra = extra * scale
    params = DBLSHParams.derive(n=2000, d=24, c=1.5, t=48, k=10, K=8, L=3, **derive_kw)
    index = build(kb, data, params)
    return np.array(data), np.array(extra), np.array(queries), index


def quantize_blocks(data: np.ndarray, ids_blocks: np.ndarray, quant_dtype: str):
    """The reference's ``index.quantize_blocks`` on numpy inputs: (qvec,
    scale) as numpy arrays (bf16 as ``ml_dtypes.bfloat16``)."""
    qb, qs = _quantize_blocks(jnp.asarray(data), jnp.asarray(ids_blocks), quant_dtype)
    return np.asarray(qb), np.asarray(qs)


def quantize_query(q: np.ndarray, mode: str):
    """The reference's ``ops._quantize_query``: (qv, qs) as numpy."""
    qv, qs = _quantize_query(jnp.asarray(q), mode)
    return np.asarray(qv), np.asarray(qs)


def compact(index, seed: int, integer_projections: bool = False):
    """The reference's ``updates.compact`` under ``jax.random.key(seed)``;
    with ``integer_projections`` its new hash functions are small integers
    (numpy, from ``seed``), which keeps every projection of integer data
    exact."""
    if not integer_projections:
        return updates.compact(index, jax.random.key(seed))
    from repro.core import index as ridx

    rng = np.random.default_rng(seed)
    orig = ridx.hashing.sample_projections
    ridx.hashing.sample_projections = lambda key, d, K, L: jnp.asarray(
        rng.integers(-2, 3, (L, K, d)).astype(np.float32))
    try:
        return updates.compact(index, jax.random.key(seed))
    finally:
        ridx.hashing.sample_projections = orig


def quant_arrays(index) -> dict:
    """An index's quantized fields as numpy (bf16 as ``ml_dtypes.bfloat16``)."""
    return {f: np.asarray(getattr(index, f)) for f in ("qvec_blocks", "qvec_scale")}


def core_fixture():
    """The data, queries and index of ``tests/test_core.py``'s fixture
    (n = 4000, d = 32, K = 10, L = 4, the gather layout)."""
    kd, kb = jax.random.split(jax.random.key(7))
    allpts = make_clustered(kd, 4032, 32, n_clusters=16, spread=0.02)
    data, queries, _ = normalize_scale(allpts[:4000], allpts[4000:])
    params = DBLSHParams.derive(n=4000, d=32, c=1.5, t=64, k=10, K=10, L=4)
    index = build(kb, data, params)
    return np.array(data), np.array(queries), index


def tune_fixture():
    """The data, queries and index of ``tests/test_tune.py``'s fixture
    (n = 2048, d = 24, K = 8, L = 3, max_blocks = 16 < nb)."""
    kd, kb = jax.random.split(jax.random.key(31))
    allpts = make_clustered(kd, 2096, 24, n_clusters=12, spread=0.02)
    data, queries, _ = normalize_scale(allpts[:2048], allpts[2048:])
    params = DBLSHParams.derive(
        n=2048, d=24, c=1.5, t=48, k=10, K=8, L=3,
        inline_vectors=True, max_blocks=16,
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


def fused_window(blk, halves, proj, vec, nrm, ids, g, q, *, M, ks, n, mode, x_scale=None):
    """Reference B1 in interpret mode, and its pool oracle.  In the
    quantized modes ``vec`` holds the quantized blocks and the oracle is
    None (``fused_search_ref`` takes a float32 pool)."""
    args = [jnp.asarray(a) for a in (blk, halves, proj, vec, nrm, ids, g, q)]
    if x_scale is not None:
        got = fused_window_search(*args, M=M, ks=ks, n=n, mode=mode, interpret=True,
                                  x_scale=jnp.asarray(x_scale))
        return tuple(map(np.asarray, got)), None
    got = fused_window_search(*args, M=M, ks=ks, n=n, mode=mode, interpret=True)
    d2, hw = window_dist_ref(args[0], args[2], args[3], args[4], args[6], args[7],
                             M, exact=(mode == "exact"))
    pool_ids = jnp.take(args[5], args[0], axis=0, mode="fill",
                        fill_value=n).reshape(blk.shape[0], -1)
    oracle = fused_search_ref(d2, hw, pool_ids, args[1], n, ks)
    return tuple(map(np.asarray, got)), oracle


def fused_cand(cp, cx, cn, ci, halves, g, q, *, ks, n, mode, cand_scale=None):
    """Reference B2 in interpret mode, and its pool oracle (None in the
    quantized modes, as :func:`fused_window`)."""
    args = [jnp.asarray(a) for a in (cp, cx, cn, ci, halves, g, q)]
    if cand_scale is not None:
        got = fused_cand_search(*args, ks=ks, n=n, mode=mode, tile_c=64, interpret=True,
                                cand_scale=jnp.asarray(cand_scale))
        return tuple(map(np.asarray, got)), None
    got = fused_cand_search(*args, ks=ks, n=n, mode=mode, tile_c=64, interpret=True)
    d2, hw = candidate_dist_ref(args[0], args[1], args[2], args[5], args[6],
                                exact=(mode == "exact"))
    oracle = fused_search_ref(d2, hw, ci.reshape(cp.shape[0], -1), halves, n, ks)
    return tuple(map(np.asarray, got)), oracle


def project_one(index, q: np.ndarray) -> np.ndarray:
    """The reference's projections G_i(q) of one query, as ``search``
    computes them: (L, K)."""
    return np.asarray(jnp.einsum("lkd,d->lk", index.proj_vecs, jnp.asarray(q)))


def lexsort_merge(run_d, run_i, new_d, new_i, n: int, k: int):
    """The multi-pass oracle's lexsort merge."""
    args = [jnp.asarray(a) for a in (run_d, run_i, new_d, new_i)]
    return tuple(map(np.asarray, _merge_dedup_topk_lexsort(*args, n, k)))


def dedup_merge(best_d2, best_id, new_d2, new_id, n: int, k: int):
    """``query._dedup_merge`` on each row of (Q, ·) arrays."""
    args = [jnp.asarray(a) for a in (best_d2, best_id, new_d2, new_id)]
    out = jax.vmap(lambda a, b, c, d: _dedup_merge(a, b, c, d, n, k))(*args)
    return tuple(map(np.asarray, out))


def window_verify_both(blk, proj, vec, ids, g, q, w: float, *, n: int, k: int):
    """Reference B6 in interpret mode, and its jnp oracle."""
    args = [jnp.asarray(a) for a in (blk, proj, vec, ids, g, q)]
    got = window_verify(*args, w, n=n, k=k, interpret=True)
    oracle = window_verify_ref(*args, w, n, k)
    return tuple(map(np.asarray, got)), tuple(map(np.asarray, oracle))


def candidate_verify_both(cp, cv, ci, g, q, w: float, *, n: int, k: int):
    """Reference B7 in interpret mode, and its jnp oracle."""
    args = [jnp.asarray(a) for a in (cp, cv, ci, g, q)]
    got = candidate_verify(*args, w, n=n, k=k, interpret=True)
    oracle = candidate_verify_ref(*args, w, n, k)
    return tuple(map(np.asarray, got)), tuple(map(np.asarray, oracle))


def window_dist_both(blk, proj, vec, nrm, g, q, *, M: int, exact: bool):
    """Reference B4 in interpret mode, and its jnp oracle: (d2, hw) each."""
    args = [jnp.asarray(a) for a in (blk, proj, vec, nrm, g, q)]
    got = window_dist(*args, M=M, exact=exact, interpret=True)
    oracle = window_dist_ref(*args, M, exact=exact)
    return tuple(map(np.asarray, got)), tuple(map(np.asarray, oracle))


def candidate_dist_both(cp, cv, cn, g, q, *, exact: bool):
    """Reference B5 in interpret mode, and its jnp oracle: (d2, hw) each."""
    args = [jnp.asarray(a) for a in (cp, cv, cn, g, q)]
    got = candidate_dist(*args, exact=exact, interpret=True)
    oracle = candidate_dist_ref(*args, exact=exact)
    return tuple(map(np.asarray, got)), tuple(map(np.asarray, oracle))


def pairwise_l2_both(Q: np.ndarray, X: np.ndarray, dtype: str = "fp32", **tiles):
    """Reference B8 in interpret mode (``tiles``: its tile_q/tile_n/tile_d)
    on float32 inputs cast to ``dtype`` ('fp32' | 'bf16') in JAX, and its
    jnp oracle on the cast inputs widened to float32."""
    jt = {"fp32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    q, x = jnp.asarray(Q).astype(jt), jnp.asarray(X).astype(jt)
    got = pairwise_l2(q, x, interpret=True, **tiles)
    oracle = pairwise_l2_ref(q.astype(jnp.float32), x.astype(jnp.float32))
    return np.asarray(got), np.asarray(oracle)


def gather_pool(index, blk_q: np.ndarray, G: np.ndarray, Q: np.ndarray, engine: str,
                exact: bool):
    """The reference's ``serve_search._gather_pool`` (engine 'jnp',
    'kernel' or 'inline'; Pallas in interpret mode): (d2, hw) (Qn, S*B)."""
    d2, hw = _gather_pool(index, jnp.asarray(blk_q), jnp.asarray(G), jnp.asarray(Q),
                          engine, exact, True)
    return np.asarray(d2), np.asarray(hw)


def key(seed: int):
    """``jax.random.key(seed)``: the key a reference entry point takes."""
    return jax.random.key(seed)


def ref_modules():
    """The reference's collection-level packages, imported on first use
    (``repro.store`` pulls in its service and router): a namespace with
    ``checkpoint``, ``store``, ``tune``, ``hashing`` and ``data``."""
    import importlib
    import types

    names = {
        "checkpoint": "repro.checkpoint", "store": "repro.store", "tune": "repro.tune",
        "hashing": "repro.core.hashing", "data": "repro.data",
    }
    return types.SimpleNamespace(**{k: importlib.import_module(v) for k, v in names.items()})


def resilience_fixture():
    """The data and queries of ``tests/test_resilience.py``'s fixture
    (240 + 40 points, d = 12), and its build key."""
    kd, kb = jax.random.split(jax.random.key(31))
    allpts = make_clustered(kd, 280, 12, n_clusters=6, spread=0.02)
    data, queries, _ = normalize_scale(allpts[:240], allpts[240:])
    return np.array(data), np.array(queries), kb


def store_fixture():
    """The data and queries of ``tests/test_store.py``'s fixture (1200 +
    32 points, d = 16), and its build key."""
    kd, kb = jax.random.split(jax.random.key(17))
    allpts = make_clustered(kd, 1232, 16, n_clusters=10, spread=0.02)
    data, queries, _ = normalize_scale(allpts[:1200], allpts[1200:])
    return np.array(data), np.array(queries), kb


class integer_projections:
    """Inside the block, every hash family the reference draws (``build``,
    ``compact``) is small integers from ``numpy`` under ``seed``; the
    arrays drawn are kept in ``self.drawn``, so the port can be handed
    the same ones.  With integer data every projection is then exact in
    float32 in both frameworks."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.drawn: list[np.ndarray] = []

    def __enter__(self):
        from repro.core import index as ridx

        self._mod, self._orig = ridx.hashing, ridx.hashing.sample_projections

        def draw(key, d, K, L):
            a = self.rng.integers(-2, 3, (L, K, d)).astype(np.float32)
            self.drawn.append(a)
            return jnp.asarray(a)

        self._mod.sample_projections = draw
        return self

    def __exit__(self, *exc):
        self._mod.sample_projections = self._orig
        return False


def ref_exports(module: str) -> list[str]:
    """``__all__`` of the reference module ``repro.<module>`` (``""``: the
    package itself)."""
    import importlib

    return list(importlib.import_module("repro" + (f".{module}" if module else "")).__all__)
