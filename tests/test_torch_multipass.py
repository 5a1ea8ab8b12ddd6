"""The port's multi-pass oracle ``search_batch_fixed_ref`` vs the
reference's, and the one-pass contracts it is the oracle of
(tests/test_onepass_search.py, within the port).

The fixture is tests/test_onepass_search.py's (n = 2048, d = 24,
max_blocks == nb, so the one-pass and multi-pass paths see the same
candidates), carried across with ``from_arrays``.  The reference runs its
``jnp`` multi-pass engine: its Pallas multi-pass engines in interpret
mode would be too slow here.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
R = pytest.importorskip("_torch_parity")

from _hypothesis_compat import given, settings, st  # noqa: E402
from repro_torch.core import (  # noqa: E402
    ENGINES,
    from_arrays,
    merge_dedup_topk,
    probe_radius,
    search_batch_fixed,
    search_batch_fixed_ref,
)
from repro_torch.core.serve_search import _merge_dedup_topk_lexsort  # noqa: E402

K_TEST = 8


@pytest.fixture(scope="module")
def setup():
    data, queries, ref = R.onepass_fixture()
    assert ref.params.max_blocks == ref.nb
    index = from_arrays(R.index_arrays(ref), R.index_params(ref), device="cpu")
    return data, queries, ref, index


def _idsets(d, i):
    d, i = np.asarray(d), np.asarray(i)
    return [set(i[q][np.isfinite(d[q])].tolist()) for q in range(d.shape[0])]


def _bit_equal(a, b):
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.fixture(scope="module")
def ref_runs(setup):
    """The reference's multi-pass ``jnp`` search with stats, per steps."""
    _, queries, ref, _ = setup
    return {steps: R.search_batch_fixed_ref(ref, queries, k=K_TEST, r0=0.5, steps=steps,
                                            engine="jnp", with_stats=True)
            for steps in (1, 4, 8)}


@pytest.mark.parametrize("steps", [1, 4, 8])
@pytest.mark.parametrize("engine", ENGINES)
def test_multipass_matches_reference(setup, ref_runs, engine, steps):
    """Equal id sets and stats; distances within a few float32 ulps, as
    tests/test_torch_serve_search.py's exact form: the frameworks sum the
    d squared differences in different orders (ROADMAP queue C)."""
    _, queries, _, index = setup
    rd, ri, rs = ref_runs[steps]
    gd, gi, gs = search_batch_fixed_ref(index, queries, k=K_TEST, r0=0.5, steps=steps,
                                        engine=engine, with_stats=True, device="cpu")
    assert gi.dtype == torch.int32 and gd.shape == (queries.shape[0], K_TEST)
    assert _idsets(gd, gi) == _idsets(rd, ri)
    np.testing.assert_allclose(gd.numpy(), np.asarray(rd), rtol=3e-7, atol=5e-7)
    np.testing.assert_array_equal(gi.numpy()[~np.isfinite(gd.numpy())], index.n)
    for key in ("radius_steps", "candidates"):
        np.testing.assert_array_equal(gs[key].numpy(), np.asarray(rs[key]), err_msg=key)


@pytest.mark.parametrize("engine", ENGINES)
def test_exact_bit_equality_to_seed(setup, engine):
    """exact=True: the one-pass search of each engine is bit-equal to the
    multi-pass oracle, of the same engine and of the ``torch`` engine."""
    _, queries, _, index = setup
    kw = dict(k=K_TEST, r0=0.5, device="cpu")
    for steps in (1, 4, 8):
        new = search_batch_fixed(index, queries, steps=steps, engine=engine, exact=True, **kw)
        _bit_equal(new, search_batch_fixed_ref(index, queries, steps=steps, engine=engine, **kw))
        _bit_equal(new, search_batch_fixed_ref(index, queries, steps=steps, **kw))


def test_distinct_candidate_accounting(setup):
    """The one-pass ``candidates`` stat counts each fetched slot once:
    equal to the multi-pass count at steps=1, below its per-step recount
    after, monotone in steps, whole blocks only; radius_steps equal."""
    _, queries, _, index = setup
    B = index.params.block_size
    prev = None
    for steps in (1, 4, 8):
        kw = dict(k=K_TEST, r0=0.5, steps=steps, with_stats=True, device="cpu")
        *_, s_new = search_batch_fixed(index, queries, **kw)
        *_, s_ref = search_batch_fixed_ref(index, queries, **kw)
        c_new, c_ref = s_new["candidates"].numpy(), s_ref["candidates"].numpy()
        assert (c_new % B == 0).all()
        if steps == 1:
            np.testing.assert_array_equal(c_new, c_ref)
        else:
            assert (c_new <= c_ref).all() and c_new.sum() < c_ref.sum()
        if prev is not None:
            assert (c_new >= prev).all()
        prev = c_new
        assert torch.equal(s_new["radius_steps"], s_ref["radius_steps"])


@given(steps=st.integers(1, 6), r0_scale=st.integers(2, 8))
@settings(deadline=None, max_examples=6)
def test_nesting_contract_property(setup, steps, r0_scale):
    """Incremental per-step results equal from-scratch probes at the same
    radius: the oracle rebuilds each step with ``probe_radius`` (the
    paper path's independent window probe) and the same masked merge and
    C2 rule.  Tolerance as the reference's: the oracle reduces per query,
    the pipeline over the batched pool."""
    _, queries, _, index = setup
    p = index.params
    r0 = r0_scale / 10.0
    n, k, nq = index.n, K_TEST, 8
    Q = torch.from_numpy(queries[:nq])
    d_new, i_new = search_batch_fixed(index, Q, k=k, r0=r0, steps=steps, exact=True,
                                      device="cpu")

    G = torch.einsum("lkd,qd->qlk", index.proj_vecs, Q)
    best_d = torch.full((nq, k), torch.inf)
    best_i = torch.full((nq, k), n, dtype=torch.int32)
    done = torch.zeros((nq,), dtype=torch.bool)
    r = np.float32(r0)
    for _ in range(steps):
        w = np.float32(p.w0) * r
        probes = [probe_radius(index, Q[qi], G[qi], w) for qi in range(nq)]
        nd, ni = merge_dedup_topk(best_d, best_i, torch.stack([a for a, _ in probes]),
                                  torch.stack([b for _, b in probes]), n, k)
        best_d = torch.where(done[:, None], best_d, nd)
        best_i = torch.where(done[:, None], best_i, ni)
        done = done | (best_d[:, k - 1] <= float(np.square(np.float32(p.c) * r)))
        r = r * np.float32(p.c)
    np.testing.assert_allclose(d_new.numpy(), torch.sqrt(best_d).numpy(), rtol=0, atol=5e-7)
    assert _idsets(d_new, i_new) == _idsets(torch.sqrt(best_d), best_i)


@pytest.mark.parametrize("seed", range(6))
def test_lexsort_merge_matches_reference(seed):
    """The oracle's merge, tie order included: duplicate ids at several
    distances, exact distance ties across ids, all-inf rows, ids >= n."""
    rng = np.random.default_rng(seed)
    n, Qn = 40, 4
    k, a, b = int(rng.integers(1, 10)), int(rng.integers(1, 12)), int(rng.integers(1, 20))
    k = min(k, a)
    run_d = np.sort(rng.choice([0.5, 1.0, 2.0, np.inf], (Qn, a)), axis=1).astype(np.float32)
    run_i = np.where(np.isfinite(run_d), rng.integers(0, n, (Qn, a)), n).astype(np.int32)
    new_d = rng.choice([0.25, 0.5, 1.0, 3.0, np.inf], (Qn, b)).astype(np.float32)
    new_i = rng.integers(0, n + 2, (Qn, b)).astype(np.int32)
    new_d[seed % Qn, :] = np.inf
    gd, gi = _merge_dedup_topk_lexsort(*(torch.from_numpy(x) for x in
                                         (run_d, run_i, new_d, new_i)), n, k)
    rd, ri = R.lexsort_merge(run_d, run_i, new_d, new_i, n, k)
    np.testing.assert_array_equal(gd.numpy(), rd)
    np.testing.assert_array_equal(gi.numpy(), ri)


def test_multipass_gather_layout_matches_inline(setup):
    """The gather layout (vectors fetched from data by id) gives the
    inline layout's multi-pass results on the engines it runs."""
    _, queries, ref, index = setup
    params = R.index_params(ref)
    params["inline_vectors"] = False
    arrays = R.index_arrays(ref)
    arrays["vec_blocks"] = np.zeros((0,), np.float32)
    gather = from_arrays(arrays, params, device="cpu")
    for engine in ("torch", "kernel"):
        kw = dict(k=K_TEST, r0=0.5, steps=4, engine=engine, device="cpu")
        _bit_equal(search_batch_fixed_ref(gather, queries, **kw),
                   search_batch_fixed_ref(index, queries, **kw))
