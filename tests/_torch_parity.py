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
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

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
    "obs_fixture",
    "scheduler_fixture",
    "scheduler_property_points",
    "store_fixture",
    "sharded_reference",
    "sharded_lifecycle_fixture",
    "ref_sharded_collection",
    "HostWaits",
    "SHARDS",
    "SHARDED_KW",
    "ref_collection_arrays",
    "baselines_reference",
    "BASELINE_FIELDS",
    "RefLM",
    "ref_chunked_threshold",
    "ref_kv_chunked_context",
    "ref_token_batch",
    "ref_knn_probs",
    "ref_configs",
    "ref_ssm_params",
    "ref_ssm_forward",
    "ref_ssm_decode",
    "ref_moe_ffn",
    "ref_value_and_grad",
    "ref_grad_cast_vjp",
    "RefTrain",
    "ref_schedules",
    "mesh_reference",
    "MESH_BATCH_SEED",
    "MOE_LOW_FACTOR",
    "ref_quantize",
    "ref_compressed_pmean",
    "ref_specs",
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


def obs_fixture():
    """The data and queries of ``tests/test_obs.py``'s fixture (256 + 24
    points, d = 12), and its build key."""
    kd, kb = jax.random.split(jax.random.key(31))
    allpts = make_clustered(kd, 280, 12, n_clusters=6, spread=0.02)
    data, queries, _ = normalize_scale(allpts[:256], allpts[256:])
    return np.array(data), np.array(queries), kb


def scheduler_fixture():
    """The data and queries of ``tests/test_store_scheduler.py``'s fixture
    (400 + 22 points, d = 16), and its build key."""
    kd, kb = jax.random.split(jax.random.key(23))
    allpts = make_clustered(kd, 422, 16, n_clusters=8, spread=0.02)
    data, queries, _ = normalize_scale(allpts[:400], allpts[400:])
    return np.array(data), np.array(queries), kb


def scheduler_property_points() -> np.ndarray:
    """The 160 points (d = 8) of ``tests/test_store_scheduler.py``'s cache
    property test, normalized as there."""
    kd, _ = jax.random.split(jax.random.key(7))
    pts = np.asarray(make_clustered(kd, 160, 8, n_clusters=4, spread=0.05))
    pts, _, _ = normalize_scale(pts, pts[:1])
    return np.asarray(pts, np.float32)


def ref_collection_arrays(name: str, key, data: np.ndarray, **kw):
    """A reference ``Collection.create(name, key, data, **kw)``, and its
    index's arrays and params (for the port's ``from_arrays``)."""
    col = ref_modules().store.Collection.create(name, key, data, **kw)
    return col, index_arrays(col.index), index_params(col.index)


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


def ref_exports(module: str, defined: bool = False) -> list[str]:
    """``__all__`` of the reference module ``repro.<module>`` (``""``: the
    package itself); a package without one (``repro.serve``) exports the
    public names it imports, its submodules aside.  ``defined``: the
    public functions and classes the module defines itself (for a module
    without ``__all__`` whose imports are helpers, ``repro.models.vlm``)."""
    import importlib
    import types

    # repro.launch.dryrun forces 512 host devices through XLA_FLAGS when it
    # is imported: keep this process's flags (no backend starts meanwhile)
    flags = os.environ.get("XLA_FLAGS")
    try:
        mod = importlib.import_module("repro" + (f".{module}" if module else ""))
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
    if defined:
        return [n for n, v in vars(mod).items()
                if not n.startswith("_") and getattr(v, "__module__", None) == mod.__name__]
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    return [n for n, v in vars(mod).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)]


# ---------------------------------------------------------------------------
# The reference's sharded fleet at P = 4, in a subprocess with four forced
# host devices (the test process keeps its one device)
# ---------------------------------------------------------------------------

SHARDS = 4
SHARDED_KW = dict(c=1.5, w0=3.6, t=16, k=10, K=6, L=3, block_size=32, inline_vectors=True)

_SHARDED_SCRIPT = r'''
import json, sys
from pathlib import Path
import numpy as np
import jax, jax.numpy as jnp
import _torch_parity as R
from repro.core import DBLSHParams, Termination
from repro.core.distributed import (build_sharded, compact_sharded, delete_sharded,
                                    id_stride, insert_sharded, search_sharded,
                                    shard_live_counts)
from repro.store import CompactionPolicy, ShardedCollection

out = Path(sys.argv[1])
P, KW = R.SHARDS, R.SHARDED_KW
assert len(jax.devices()) == P, jax.devices()
mesh = jax.make_mesh((P,), ("data",))
rng = np.random.default_rng(11)
n, d = 4096, 16
data = rng.integers(-3, 4, (n, d)).astype(np.float32)
extra = rng.integers(-3, 4, (48, d)).astype(np.float32)
queries = rng.integers(-3, 4, (24, d)).astype(np.float32)
tied = np.tile(rng.integers(-3, 4, (256, d)).astype(np.float32), (P, 1))
res = {"data": data, "extra": extra, "queries": queries, "tied": tied}
meta = {}

def arrays(tag, s):
    for f in R.INDEX_FIELDS:
        res[f"{tag}/{f}"] = np.asarray(getattr(s.index, f))
    meta[tag] = dict(params=R.index_params(s.index), n_total=s.n_total,
                     n_local=s.n_local, stride=s.stride)

SEARCHES = {
    "plain": dict(r0=1.0, steps=6),
    "stats": dict(r0=1.0, steps=6, with_stats=True),
    "explain": dict(r0=1.0, steps=6, with_explain=True),
    "exact": dict(r0=1.0, steps=6, exact=True, with_stats=True),
    "term": dict(r0=1.0, steps=8, termination=Termination(), with_explain=True),
    "term_c1": dict(r0=1.0, steps=8, with_explain=True,
                    termination=Termination(use_c2=False, c1_budget=96)),
    "unfilled": dict(r0=1.0, steps=4, with_stats=True),
}

def searches(tag, s, which=SEARCHES):
    for name, kw in which.items():
        o = search_sharded(s, jnp.asarray(queries), k=10, mesh=mesh, **kw)
        res[f"{tag}/{name}/d"], res[f"{tag}/{name}/i"] = np.asarray(o[0]), np.asarray(o[1])
        for extra_out in o[2:]:
            for key, v in extra_out.items():
                res[f"{tag}/{name}/{key}"] = np.asarray(v)

with R.integer_projections(seed=4) as proj:
    params = DBLSHParams.derive(n=n // P, d=d, **KW)
    s = build_sharded(R.key(0), jnp.asarray(data), params, mesh,
                      stride=id_stride(n // P, 1.25))
    res["build/proj"] = proj.drawn[-1]
    arrays("build", s)
    searches("build", s)
    # every shard holds the same points: each distance ties across shards
    st = build_sharded(R.key(1), jnp.asarray(tied), params, mesh)
    res["tied/proj"] = proj.drawn[-1]
    arrays("tied", st)
    searches("tied", st, {"stats": SEARCHES["stats"], "exact": SEARCHES["exact"]})
    # inserts on shard 2, then deletes across shards, headroom and sentinels
    s2 = insert_sharded(s, jnp.asarray(extra), 2, mesh=mesh)
    gids = np.concatenate([np.arange(0, 3000, 37), 2 * 1280 + 1024 + np.arange(0, 48, 5),
                           [1100, 4 * 1280]]).astype(np.int32)
    res["delete/gids"] = gids
    s3 = delete_sharded(s2, jnp.asarray(gids), mesh=mesh)
    arrays("insert", s2)
    arrays("delete", s3)
    res["delete/counts"] = np.asarray(shard_live_counts(s3, mesh=mesh))
    searches("delete", s3, {k_: SEARCHES[k_] for k_ in ("stats", "exact", "explain")})
    s4, id_map = compact_sharded(s3, R.key(5), mesh, headroom=1.25)
    res["compact/proj"] = proj.drawn[-1]
    res["compact/id_map"] = np.asarray(id_map)
    arrays("compact", s4)
    searches("compact", s4, {k_: SEARCHES[k_] for k_ in ("stats", "exact")})
    # a collection's snapshot, after updates, and an int8 one
    for tag, ckw in (("col", {}), ("col8", {"quant_dtype": "int8"})):
        col = ShardedCollection.create(
            tag, R.key(9), data, mesh, payload=np.arange(n) * 3,
            policy=CompactionPolicy(auto=False), **KW, **ckw)
        col.add(extra[:20], payload=np.arange(20) + 50_000)
        col.remove(np.arange(0, 600, 7).astype(np.int32))
        col.snapshot(str(out / tag))
        meta[tag] = dict(stats=col.stats.as_dict(), built_n=col.built_n,
                         n_total=col.sharded.n_total, stride=col.sharded.stride,
                         live=col.live_count(), key=np.asarray(
                             jax.random.key_data(col._key)).tolist())
        for dt in ("fp32",) + (("int8",) if ckw else ()):
            o = col.search(queries, k=10, r0=1.0, steps=6, with_stats=True, dtype=dt)
            res[f"{tag}/{dt}/d"], res[f"{tag}/{dt}/i"] = np.asarray(o[0]), np.asarray(o[1])
            for key, v in o[2].items():
                res[f"{tag}/{dt}/{key}"] = np.asarray(v)
        # the quantized blocks as the reference's own restore re-derives
        # them (a live fleet keeps its tombstoned slots' old rows)
        back = ShardedCollection.restore(str(out / tag), mesh=mesh)
        res[f"{tag}/qvec_blocks"] = np.asarray(back.sharded.index.qvec_blocks)
        res[f"{tag}/qvec_scale"] = np.asarray(back.sharded.index.qvec_scale)
        res[f"{tag}/payload"] = np.asarray(col.payload)
np.savez(out / "ref.npz", **res)
(out / "meta.json").write_text(json.dumps(meta))
print("SHARDED-REF-OK")
'''


def sharded_reference(out_dir) -> tuple[dict, dict]:
    """Run the reference's sharded path at P = 4 (four forced host
    devices, in a subprocess) under integer hash functions on integer
    data, and return its outputs as ``(arrays, meta)``; the snapshots of
    its collections are left under ``out_dir / "col"`` and ``"col8"``."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    here = Path(__file__).resolve().parent
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={SHARDS}",
               PYTHONPATH=os.pathsep.join([str(here.parent / "src"), str(here)]))
    proc = subprocess.run([sys.executable, "-c", _SHARDED_SCRIPT, str(out_dir)],
                          capture_output=True, text=True, env=env, timeout=600,
                          check=False)
    if proc.returncode != 0 or "SHARDED-REF-OK" not in proc.stdout:
        raise RuntimeError(f"the reference's sharded run failed:\n{proc.stderr[-4000:]}")
    z = np.load(Path(out_dir) / "ref.npz")
    return {k: z[k] for k in z.files}, json.loads((Path(out_dir) / "meta.json").read_text())


def sharded_lifecycle_fixture():
    """The data, inserts and queries of ``tests/test_sharded_lifecycle.py``'s
    fixture (800 + 200 + 32 points, d = 16), and its build key."""
    kd, kb = jax.random.split(jax.random.key(29))
    allpts = make_clustered(kd, 1032, 16, n_clusters=8, spread=0.02)
    pts, q, _ = normalize_scale(allpts[:1000], allpts[1000:])
    allpts = np.concatenate([np.asarray(pts), np.asarray(q)])
    return allpts[:800], allpts[800:1000], allpts[1000:], kb


def ref_sharded_collection(name: str, key, data: np.ndarray, **kw):
    """A reference ``ShardedCollection`` on a one-device mesh (this
    process keeps JAX's one CPU device)."""
    mesh = jax.make_mesh((1,), ("data",))
    return ref_modules().store.ShardedCollection.create(name, key, data, mesh, **kw)


class HostWaits(TorchDispatchMode):
    """Records the ops of a CPU run that would make the host wait for the
    card on CUDA tensors: a read of a tensor's value
    (``_local_scalar_dense``: ``item``, ``bool``, ``int``), ``nonzero``, a
    move of a tensor to a device by a plain copy (``_to_copy`` with a
    ``device``: from pageable memory the copy synchronises the stream),
    and a ``where`` given a 0-dim tensor made from host data (``where``
    copies such an operand to the card; a Python scalar becomes a
    ``scalar_tensor`` on the operands' device instead)."""

    def __init__(self):
        super().__init__()
        self.found, self._scalars = [], set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        aten = torch.ops.aten
        if func in (aten._local_scalar_dense.default, aten.nonzero.default) or (
                func == aten._to_copy.default and "device" in kwargs):
            self.found.append(str(func))
        elif func == aten.scalar_tensor.default:
            self._scalars.add(id(out))
        elif func == aten.where.self and any(
                isinstance(a, torch.Tensor) and a.dim() == 0 and id(a) not in self._scalars
                for a in args):
            self.found.append("where with a 0-dim tensor made from host data")
        return out


# ---------------------------------------------------------------------------
# The paper's baselines (``repro.core.baselines``)
# ---------------------------------------------------------------------------

BASELINE_FIELDS = {
    "FBLSH": (("proj_vecs", "proj", "offsets", "data"),
              ("K", "L", "w0", "c", "t", "max_radius_steps", "cand_cap")),
    "MQIndex": (("proj_vecs", "proj", "data"), ("m", "beta")),
    "C2Index": (("proj_vecs", "proj", "data"), ("m", "l", "w", "cand_cap")),
}


def baselines_reference(data: np.ndarray, queries: np.ndarray, specs: dict, k: int = 10):
    """The reference's baselines built on ``data`` and searched with
    ``queries``: ``specs`` maps a class name to ``(seed, build_kw,
    search_kw)``.  Returns, per name, ``(arrays, meta, dists, ids)`` as
    numpy and plain values, for the port's ``from_arrays``."""
    from repro.core import baselines as rb

    out = {}
    for name, (seed, build_kw, search_kw) in specs.items():
        idx = getattr(rb, name).build(jax.random.key(seed), jnp.asarray(data), **build_kw)
        d, i = idx.search_batch(jnp.asarray(queries), k=k, **search_kw)
        arrays, meta = BASELINE_FIELDS[name]
        out[name] = ({f: np.array(getattr(idx, f)) for f in arrays},
                     {f: getattr(idx, f) for f in meta}, np.asarray(d), np.asarray(i))
    return out


# ---------------------------------------------------------------------------
# The LM and its serving path (``repro.models``, ``repro.serve``)
# ---------------------------------------------------------------------------


def _np_tree(tree):
    """A JAX pytree of arrays (dicts and lists) as numpy."""
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return np.asarray(tree)


def _jnp_tree(tree):
    if isinstance(tree, dict):
        return {k: _jnp_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_jnp_tree(v) for v in tree]
    return jnp.asarray(tree)


def ref_configs():
    """The reference's ``repro.configs`` package."""
    import repro.configs

    return repro.configs


class RefLM:
    """A reference model, ``build_model(get_config(arch).smoke().scaled(
    n_layers=2, **scaled))`` (``scaled`` may set n_layers) initialised
    from ``jax.random.key(seed)``; every method takes and returns numpy
    arrays (caches as numpy trees).  ``extras`` are the encoder-decoder's
    ``frames`` or the VLM's ``images``."""

    def __init__(self, arch: str, seed: int = 0, **scaled):
        from repro.configs import get_config
        from repro.models.registry import build_model

        self.cfg = get_config(arch).smoke().scaled(**{"n_layers": 2, **scaled})
        self.model = build_model(self.cfg)
        self.params = self.model.init(jax.random.key(seed))

    @property
    def tree(self) -> dict:
        return _np_tree(self.params)

    def set_tree(self, tree: dict) -> None:
        """Run on the numpy parameter tree ``tree`` from now on."""
        self.params = _jnp_tree(tree)

    def head(self, hidden):
        """The family's logits of ``hidden`` (numpy or JAX)."""
        from repro.models import transformer

        if self.cfg.family == "encdec":  # the tied embedding, whatever the config says
            return np.asarray(jnp.einsum("btd,vd->btv", jnp.asarray(hidden),
                                         self.params["embed"]))
        return np.asarray(transformer.logits_fn(self.params, jnp.asarray(hidden), self.cfg))

    def loss(self, tokens, labels, **extras):
        """(loss, hidden) of the teacher-forced pass, and the logits."""
        batch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
                 **{k: jnp.asarray(v) for k, v in extras.items()}}
        loss, metrics = self.model.loss(self.params, batch)
        return float(loss), np.asarray(metrics["hidden"]), self.head(metrics["hidden"])

    def prefill(self, tokens, cache_len=None, **extras):
        batch = {"tokens": jnp.asarray(tokens), **{k: jnp.asarray(v) for k, v in extras.items()}}
        out = self.model.prefill(self.params, batch, cache_len=cache_len)
        return _np_tree(out)

    def decode(self, token, caches, pos):
        out = self.model.decode(self.params, jnp.asarray(token), _jnp_tree(caches),
                                jnp.asarray(pos, jnp.int32))
        return _np_tree(out)

    def engine(self, requests, retrieval=None, **kw):
        """The reference's ServeEngine over ``requests`` (dicts of Request
        fields): their outputs."""
        from repro.serve import Request, ServeEngine

        eng = ServeEngine(self.model, self.params, retrieval=retrieval, **kw)
        reqs = [Request(**r) for r in requests]
        for r in reqs:
            eng.submit(r)
        eng.run()
        return [r.output for r in reqs]

    def datastore(self, batches, seed: int, **kw):
        """The reference's ``build_datastore`` over ``batches``."""
        from repro.serve import build_datastore

        return build_datastore(self.model, self.params, batches, jax.random.key(seed), **kw)

    def retrieval(self, ds, r0: float, steps: int):
        from repro.serve import RetrievalLM

        return RetrievalLM(self.model, ds, r0=r0, steps=steps)

    def retrieval_decode(self, rlm, token, caches, pos):
        """One ``RetrievalLM.decode`` step of the reference (the batch path)."""
        out = rlm.decode(self.params, jnp.asarray(token), _jnp_tree(caches),
                         jnp.asarray(pos, jnp.int32))
        return _np_tree(out)


class ref_chunked_threshold:
    """Inside the block the reference's attention takes its KV-chunked path
    from ``value`` keys on."""

    def __init__(self, value: int):
        self.value = value

    def __enter__(self):
        from repro.models import attention

        self._orig = attention.CHUNKED_THRESHOLD
        attention.CHUNKED_THRESHOLD = self.value
        return self

    def __exit__(self, *exc):
        from repro.models import attention

        attention.CHUNKED_THRESHOLD = self._orig
        return False


def ref_kv_chunked_context(q, k, v, *, causal, window, ck):
    from repro.models.attention import _kv_chunked_context

    return np.asarray(_kv_chunked_context(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          causal=causal, window=window, ck=ck))


def ref_token_batch(vocab: int, seq_len: int, batch: int, seed: int, step: int, extras=None):
    """``make_batch_fn(SyntheticTokens(...), extras)(step)`` of the reference."""
    from repro.data.pipeline import SyntheticTokens, make_batch_fn

    return make_batch_fn(SyntheticTokens(vocab, seq_len, batch, seed=seed), extras)(step)


def ref_cross_attention(x, p, kv_src):
    """``attention.cross_attention``: (out, (k, v))."""
    from repro.models import attention

    return _np_tree(attention.cross_attention(jnp.asarray(x), _jnp_tree(p), jnp.asarray(kv_src)))


def ref_decode_cross_attention(x1, p, cache):
    from repro.models import attention

    return np.asarray(attention.decode_cross_attention(jnp.asarray(x1), _jnp_tree(p),
                                                       _jnp_tree(cache)))


def ref_sinusoid(T: int, D: int, offset: int = 0):
    from repro.models import encdec

    return np.asarray(encdec.sinusoid(T, D, offset))


def ref_sinusoid_at(pos, D: int):
    from repro.models import encdec

    return np.asarray(encdec.sinusoid_at(jnp.asarray(pos), D))


def ref_encode(lm: "RefLM", frames):
    """``encdec.encode`` of ``lm``'s parameters on ``frames``."""
    from repro.models import encdec

    return np.asarray(encdec.encode(lm.params, jnp.asarray(frames), lm.cfg))


def ref_model_specs(arch: str, shape: str, batch: int, seq_len: int):
    """The reference's ``input_specs`` (prefill and train) and
    ``cache_specs`` of ``arch``'s smoke config, as (shape, dtype name)
    trees."""
    from repro.configs import SHAPES, get_config
    from repro.models.registry import build_model

    model = build_model(get_config(arch).smoke())

    def plain(tree):
        return jax.tree.map(lambda s: (tuple(s.shape), jnp.dtype(s.dtype).name), tree)

    return {"inputs": plain(model.input_specs(SHAPES[shape], batch)),
            "caches": plain(model.cache_specs(batch, seq_len))}


def ref_knn_probs(ds, queries, vocab: int, r0: float, steps: int):
    """The reference's ``knn_probs`` and ``Datastore.search`` on ``ds``."""
    from repro.serve import knn_probs

    q = jnp.asarray(queries)
    d, i = ds.search(q, r0=r0, steps=steps)
    return (np.asarray(knn_probs(ds, q, vocab, r0=r0, steps=steps)), np.asarray(d),
            np.asarray(i))


# ---------------------------------------------------------------------------
# The reference's SSD mixer and MoE FFN on numpy inputs
# ---------------------------------------------------------------------------


def ref_ssm_params(cfg, seed: int) -> dict:
    """``repro.models.ssm.ssm_params`` drawn from ``jax.random.key(seed)``."""
    from repro.models import ssm

    return _np_tree(ssm.ssm_params(jax.random.key(seed), cfg))


def ref_ssm_forward(x, params, cfg, chunk: int):
    from repro.models import ssm

    return _np_tree(ssm.ssm_forward(jnp.asarray(x), _jnp_tree(params), cfg, chunk=chunk))


def ref_ssm_decode(x1, params, cfg, state, conv):
    from repro.models import ssm

    return _np_tree(ssm.ssm_decode(jnp.asarray(x1), _jnp_tree(params), cfg,
                                   jnp.asarray(state), jnp.asarray(conv)))


def ref_moe_ffn(x, params, cfg):
    """``repro.models.ffn.moe_ffn`` on one device: (out, load_balance)."""
    from repro.models import ffn

    out, aux = ffn.moe_ffn(jnp.asarray(x), _jnp_tree(params), cfg)
    return np.asarray(out), float(aux["load_balance"])


# ---------------------------------------------------------------------------
# Training (``repro.train``): value and grad, jitted train steps
# ---------------------------------------------------------------------------


def ref_value_and_grad(lm: "RefLM", batch: dict):
    """``jax.value_and_grad`` of ``lm``'s loss on the numpy ``batch``:
    (loss, gradient tree as numpy)."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(lambda p: lm.model.loss(p, jb)[0]))(lm.params)
    return float(loss), _np_tree(grads)


def ref_grad_cast_vjp(x, ct, dtype_name: str, dtype: str):
    """The cotangent ``grad_cast`` hands back for ``ct``, x and ct in ``dtype``."""
    from repro.models.common import grad_cast

    x = jnp.asarray(x).astype(dtype)
    _, vjp = jax.vjp(lambda a: grad_cast(a, dtype_name), x)
    (g,) = vjp(jnp.asarray(ct).astype(dtype))
    return np.asarray(g.astype(jnp.float32)), jnp.dtype(g.dtype).name


def ref_schedules():
    """The reference's ``cosine_schedule`` and ``wsd_schedule``."""
    from repro.train.optimizer import cosine_schedule, wsd_schedule

    return cosine_schedule, wsd_schedule


class RefTrain:
    """The reference's jitted ``make_train_step`` on ``RefLM(arch, seed,
    **scaled)``'s model and parameters, with ``make_optimizer(optimizer,
    cosine_schedule(*lr))``; states and batches as numpy trees."""

    def __init__(self, arch: str, optimizer: str, lr=(1e-2, 2, 100), accum_steps: int = 1,
                 seed: int = 0, **scaled):
        from repro.train import make_optimizer, make_train_step
        from repro.train.optimizer import cosine_schedule

        self.lm = RefLM(arch, seed, **scaled)
        opt = make_optimizer(optimizer, cosine_schedule(*lr))
        self.state = {"params": self.lm.params, "opt": opt.init(self.lm.params),
                      "step": jnp.zeros((), jnp.int32)}
        self._step = jax.jit(make_train_step(self.lm.model, opt, accum_steps=accum_steps))

    @property
    def tree(self) -> dict:
        return _np_tree(self.state)

    def step(self, batch: dict) -> dict:
        """One step; its metrics as floats."""
        self.state, metrics = self._step(self.state, {k: jnp.asarray(v)
                                                      for k, v in batch.items()})
        return {k: float(v) for k, v in metrics.items()}


class _SpecMesh:
    """What the reference's sharding rules read of a mesh: its axis sizes
    and names (no devices needed)."""

    def __init__(self, shape, names):
        self.shape = dict(zip(names, shape))
        self.axis_names = tuple(names)


def ref_specs(arch: str, mesh_shape, axis_names) -> dict:
    """The reference's spec trees for ``arch`` (its full config, shapes
    from ``jax.eval_shape``) on a mesh of ``mesh_shape``: ``param_specs``
    with fsdp on and off, ``state_specs`` of the AdamW and Adafactor
    states (pod-compressed: with ``err``), and for every shape in
    ``SHAPES`` the ``batch_specs`` (train, prefill) or ``cache_specs``
    (decode) of its inputs.  Each as {'/'-joined key path: spec tuple}."""
    from repro.configs import SHAPES, get_config
    from repro.models.registry import build_model
    from repro.sharding import rules
    from repro.train import make_optimizer
    from repro.train.train_step import init_train_state

    mesh = _SpecMesh(mesh_shape, axis_names)
    model = build_model(get_config(arch))

    def flat(tree):
        leaves = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
        return {rules._path_str(kp): tuple(s) for kp, s in leaves}

    params = jax.eval_shape(model.init, jax.random.key(0))
    out = {f"params/fsdp={f}": flat(rules.param_specs(params, mesh, fsdp=f))
           for f in (True, False)}
    for name in ("adamw", "adafactor"):
        opt = make_optimizer(name)
        state = jax.eval_shape(lambda k: init_train_state(model, opt, k, compress_pods=True),
                               jax.random.key(0))
        out[f"state/{name}"] = flat(rules.state_specs(
            state, rules.param_specs(state["params"], mesh), mesh))
    for sname, shape in SHAPES.items():
        spec = model.input_specs(shape)
        out[f"inputs/{sname}"] = flat(rules.cache_specs(spec["caches"], mesh)
                                      if shape.phase == "decode"
                                      else rules.batch_specs(spec["batch"], mesh))
    return out


def ref_quantize(x):
    """``repro.train.grad_compression.quantize`` of ``x``: numpy (codes,
    scales, residual)."""
    from repro.train import grad_compression as gc

    return tuple(np.asarray(a) for a in gc.quantize(jnp.asarray(x)))


def ref_compressed_pmean(trees: list, errs: list):
    """``compressed_pmean`` over a 'pod' axis of ``len(trees)`` (vmapped:
    its ``all_gather`` and ``psum`` run over the mapped axis): (the mean
    tree, one residual tree a pod), numpy."""
    from repro.train import grad_compression as gc

    stack = lambda ts: jax.tree.map(lambda *a: jnp.stack(a), *ts)  # noqa: E731
    mean, err = jax.vmap(lambda g, e: gc.compressed_pmean(g, "pod", e), axis_name="pod")(
        stack([_jnp_tree(t) for t in trees]), stack([_jnp_tree(e) for e in errs]))
    mean = jax.tree.map(lambda a: np.asarray(a[0]), mean)
    return mean, [jax.tree.map(lambda a, i=i: np.asarray(a[i]), err) for i in range(len(trees))]


# ---------------------------------------------------------------------------
# The reference on a mesh of 8 forced host devices (``tests/test_distributed.py``'s
# MoE and PP parity setups, and the pod-compressed train step), in a
# subprocess; the test process keeps its one device
# ---------------------------------------------------------------------------

MESH_BATCH_SEED = 4
MOE_LOW_FACTOR = 0.5

_MESH_SCRIPT = r"""
import sys
from pathlib import Path
import numpy as np
import jax, jax.numpy as jnp
import _torch_parity as R
from repro.configs import get_config
from repro.models.registry import build_model

out, part = Path(sys.argv[1]), sys.argv[2]
assert len(jax.devices()) == 8, jax.devices()
res = {}

def put(prefix, tree):
    for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        res[prefix + "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)] = \
            np.asarray(v, np.float32) if np.asarray(v).dtype.name == "bfloat16" else np.asarray(v)

def token_batch(cfg, shape):
    ks = jax.random.split(jax.random.key(1), 2)
    return {"tokens": jax.random.randint(ks[0], shape, 0, cfg.vocab_size),
            "labels": jax.random.randint(ks[1], shape, 0, cfg.vocab_size)}

if part == "ep":
    # tests/test_distributed.py's SCRIPT_MOE_PARITY, and layer 0's moe_ffn alone
    from repro.models import ffn
    cfg = get_config("arctic-480b").smoke().scaled(n_layers=2)
    model = build_model(cfg)
    params = model.init(jax.random.key(0))
    batch = token_batch(cfg, (4, 16))
    res["loss_1dev"] = np.float32(jax.jit(lambda p, b: model.loss(p, b)[0])(params, batch))
    mesh = jax.make_mesh((2, 4), ("data", "model"))
    with mesh:
        res["loss_ep"] = np.float32(jax.jit(lambda p, b: model.loss(p, b, mesh)[0])(params, batch))
    put("params/", params)
    put("batch/", batch)
    moe = jax.tree.map(lambda a: a[0], params["blocks"]["moe"])
    x = np.random.default_rng(3).standard_normal((4, 16, cfg.d_model)).astype(np.float32)
    res["x"] = x
    with mesh:
        o, aux = jax.jit(lambda x, p: ffn.moe_ffn(x, p, cfg, mesh=mesh, dp_axes=("data",)))(
            jnp.asarray(x), moe)
    res["moe_ep"], res["moe_lb"] = np.asarray(o), np.float32(aux["load_balance"])
    low = cfg.scaled(moe_capacity_factor=R.MOE_LOW_FACTOR)  # a capacity that drops more
    with mesh:
        res["moe_ep_low"] = np.asarray(jax.jit(lambda x, p: ffn.moe_ffn(
            x, p, low, mesh=mesh, dp_axes=("data",))[0])(jnp.asarray(x), moe))
    # build_step's spec trees on the same mesh, for two smoke configs
    import json
    from repro.configs import SHAPES
    from repro.launch.steps import build_step
    from repro.sharding import rules
    specs = {}
    for arch in ("yi-9b", "arctic-480b"):
        m_ = build_model(get_config(arch).smoke())
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            with mesh:
                _, _, in_sh, out_sh, donate = build_step(m_, SHAPES[shape], mesh,
                                                         batch_override=8)
            flat = {}
            for tag, tree in (("in", in_sh), ("out", out_sh)):
                for kp, sh in jax.tree_util.tree_flatten_with_path(tree)[0]:
                    flat[tag + "/" + rules._path_str(kp)] = list(sh.spec)
            specs[f"{arch}/{shape}"] = {"specs": flat, "donate": list(donate)}
    res["build_step"] = np.array(json.dumps(specs))
elif part == "pp":
    # tests/test_distributed.py's SCRIPT_PP_PARITY
    from repro.sharding.pp import pp_loss_fn
    cfg = get_config("yi-9b").smoke().scaled(n_layers=4)
    model = build_model(cfg)
    params = model.init(jax.random.key(0))
    batch = token_batch(cfg, (8, 16))
    res["loss"] = np.float32(jax.jit(lambda p, b: model.loss(p, b)[0])(params, batch))
    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
    f = lambda p, b: pp_loss_fn(p, b, cfg, mesh, microbatches=4)
    with mesh:
        res["loss_pp"] = np.float32(jax.jit(f)(params, batch))
        g_pp = jax.jit(jax.grad(f))(params, batch)
    g_ref = jax.jit(jax.grad(lambda p, b: model.loss(p, b)[0]))(params, batch)
    res["grad_embed"] = np.asarray(g_ref["embed"], np.float32)
    res["grad_embed_pp"] = np.asarray(g_pp["embed"], np.float32)
    put("params/", params)
    put("batch/", batch)
elif part == "pods":
    # the pod-compressed train step on (pod 2, data 1, model 4), 3 steps
    from repro.data.pipeline import SyntheticTokens, make_batch_fn
    from repro.train import make_optimizer, make_train_step
    from repro.train.optimizer import cosine_schedule
    from repro.train.train_step import init_train_state
    cfg = get_config("yi-9b").smoke().scaled(n_layers=2)
    model = build_model(cfg)
    opt = make_optimizer("adamw", cosine_schedule(1e-2, 2, 100))
    mesh = jax.make_mesh((2, 1, 4), ("pod", "data", "model"))
    batch_fn = make_batch_fn(SyntheticTokens(cfg.vocab_size, 16, 8, seed=R.MESH_BATCH_SEED))
    state = init_train_state(model, opt, jax.random.key(0), compress_pods=True)
    put("init/", {k: v for k, v in state.items() if k != "err"})
    with mesh:
        step = jax.jit(make_train_step(model, opt, mesh, compress_pods=True))
        for t in range(3):
            state, m = step(state, batch_fn(t))
            put(f"state{t}/", {k: v for k, v in state.items() if k != "err"})
            res[f"loss/{t}"] = np.float32(m["loss"])
            res[f"grad_norm/{t}"] = np.float32(m["grad_norm"])
            # each pod's residual: the shard its first device holds (every
            # device of a pod holds the whole tree, out_specs=P() unchecked)
            for kp, v in jax.tree_util.tree_flatten_with_path(state["err"])[0]:
                name = "/".join(str(k.key) for k in kp)
                shards = {s.device.id: np.asarray(s.data) for s in v.addressable_shards}
                for pod, dev in ((0, 0), (1, 4)):
                    assert shards[dev].shape == v.shape
                    res[f"err{t}/{pod}/{name}"] = shards[dev]
else:
    raise SystemExit(f"unknown part {part}")
np.savez(out / f"mesh_{part}.npz", **res)
print("MESH-REF-OK")
"""


def mesh_reference(out_dir, part: str) -> dict:
    """Run the reference's ``part`` ("ep": the MoE parity setup of
    tests/test_distributed.py on a (data 2, model 4) mesh, layer 0's
    ``moe_ffn`` alone on a seeded input, and ``build_step``'s spec trees
    on that mesh as JSON; "pp": its PP parity setup on
    (pod 2, data 2, model 2); "pods": three pod-compressed AdamW steps of
    the yi-9b smoke model at 2 layers on (pod 2, data 1, model 4): the
    state before (``init/``) and after each step (``state<step>/``, each
    pod's residual tree as ``err<step>/<pod>/<leaf>``)) on 8
    forced host devices, in a subprocess; returns its arrays by name."""
    import subprocess
    import sys
    from pathlib import Path

    here = Path(__file__).resolve().parent
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join([str(here.parent / "src"), str(here)]))
    proc = subprocess.run([sys.executable, "-c", _MESH_SCRIPT, str(out_dir), part],
                          capture_output=True, text=True, env=env, timeout=600, check=False)
    if proc.returncode != 0 or "MESH-REF-OK" not in proc.stdout:
        raise RuntimeError(f"the reference's {part} run failed:\n{proc.stderr[-4000:]}")
    z = np.load(Path(out_dir) / f"mesh_{part}.npz")
    return {k: z[k] for k in z.files}
