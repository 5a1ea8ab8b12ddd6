"""DB-LSH core on PyTorch.

    from repro_torch.core import DBLSHParams, build, search_batch_fixed

    params = DBLSHParams.derive(n=..., d=..., c=1.5, inline_vectors=True)
    index  = build(data, params, generator=torch.Generator("cuda").manual_seed(0))
    dists, ids = search_batch_fixed(index, queries, k=10, engine="inline")
"""

from .params import DBLSHParams, alpha_of_gamma, rho_star
from .hashing import collision_prob, project, sample_projections
from .index import DBLSHIndex, build, compute_norm_blocks, from_arrays
from .query import merge_dedup_topk, probe_radius, rc_nn, search, search_batch
from .baselines import brute_force
from .serve_search import (
    ENGINES,
    TERM_C1,
    TERM_C2,
    TERM_EXHAUSTED,
    PendingSearch,
    Termination,
    search_batch_fixed,
    search_batch_fixed_dispatch,
    search_batch_fixed_ref,
    validate_engine,
)

__all__ = [
    "DBLSHParams",
    "alpha_of_gamma",
    "rho_star",
    "collision_prob",
    "project",
    "sample_projections",
    "DBLSHIndex",
    "build",
    "compute_norm_blocks",
    "from_arrays",
    "search",
    "search_batch",
    "search_batch_fixed",
    "search_batch_fixed_dispatch",
    "search_batch_fixed_ref",
    "Termination",
    "PendingSearch",
    "ENGINES",
    "TERM_EXHAUSTED",
    "TERM_C1",
    "TERM_C2",
    "validate_engine",
    "merge_dedup_topk",
    "rc_nn",
    "probe_radius",
    "brute_force",
]
