"""DB-LSH core on PyTorch.

    from repro_torch.core import DBLSHParams, build, search_batch_fixed

    params = DBLSHParams.derive(n=..., d=..., c=1.5, inline_vectors=True)
    index  = build(data, params, generator=torch.Generator("cuda").manual_seed(0))
    dists, ids = search_batch_fixed(index, queries, k=10, engine="inline")

    # quantized search (params derived with quant_dtype="int8") and updates
    index = insert(index, new_points)
    index = delete(index, ids_to_delete)
    dists, ids = search_batch_fixed(index, queries, k=10, engine="inline", dtype="int8")
    index, id_map = compact(index, generator=torch.Generator("cuda").manual_seed(1))
"""

from .params import DBLSHParams, alpha_of_gamma, rho_star
from .hashing import collision_prob, normal_pdf, normal_sf, project, sample_projections
from .index import DBLSHIndex, build, compute_norm_blocks, from_arrays, quantize_blocks
from .query import merge_dedup_topk, probe_radius, rc_nn, search, search_batch
from .baselines import C2Index, FBLSH, MQIndex, brute_force
from .serve_search import (
    DTYPES,
    ENGINES,
    TERM_C1,
    TERM_C2,
    TERM_EXHAUSTED,
    PendingSearch,
    Termination,
    search_batch_fixed,
    search_batch_fixed_dispatch,
    search_batch_fixed_ref,
    validate_dtype,
    validate_engine,
)
from .updates import compact, delete, grown_params, insert, live_count, live_ids_padded

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
    "quantize_blocks",
    "search",
    "search_batch",
    "search_batch_fixed",
    "search_batch_fixed_dispatch",
    "search_batch_fixed_ref",
    "Termination",
    "PendingSearch",
    "ENGINES",
    "DTYPES",
    "TERM_EXHAUSTED",
    "TERM_C1",
    "TERM_C2",
    "validate_engine",
    "validate_dtype",
    "merge_dedup_topk",
    "rc_nn",
    "probe_radius",
    "brute_force",
    "FBLSH",
    "MQIndex",
    "C2Index",
    "grown_params",
    "insert",
    "delete",
    "compact",
    "live_count",
    "live_ids_padded",
]
