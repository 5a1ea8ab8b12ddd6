"""Port vs reference: params, hashing, index build, brute force, data."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
R = pytest.importorskip("_torch_parity")

from repro_torch.core import (  # noqa: E402
    DBLSHParams,
    alpha_of_gamma,
    brute_force,
    build,
    collision_prob,
    from_arrays,
    rho_star,
)
from repro_torch.data import make_clustered, normalize_scale  # noqa: E402

CPU = "cpu"


@pytest.mark.parametrize("n,d,c,t,k,block_size", [
    (2048, 24, 1.5, 48, 10, 64),
    (1_000_000, 64, 1.5, 64, 10, 64),
    (100_000, 128, 2.0, 100, 50, 32),
    (1200, 16, 1.2, 10, 5, 16),
    (60_000, 784, 1.5, 100, 50, 128),
    (10, 4, 3.0, 1, 1, 8),
])
def test_params_match_reference(n, d, c, t, k, block_size):
    """derive (K, L, max_blocks, p1, p2, rho) agrees field for field, with
    and without explicit K/L, and resolve is idempotent."""
    for kw in ({}, {"K": 10, "L": 5}, {"w0": 3.6}, {"inline_vectors": True, "max_blocks": 7}):
        ref = R.DBLSHParams.derive(n=n, d=d, c=c, t=t, k=k, block_size=block_size, **kw)
        got = DBLSHParams.derive(n=n, d=d, c=c, t=t, k=k, block_size=block_size, **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
        assert got.resolve() is got
        assert (got.budget, got.cand_per_table, got.alpha()) == (
            ref.budget, ref.cand_per_table, ref.alpha())
        assert DBLSHParams(n=n, d=d, c=c).resolve() == DBLSHParams(
            **dataclasses.asdict(R.DBLSHParams(n=n, d=d, c=c).resolve()))


def test_paper_constants():
    assert abs(alpha_of_gamma(2.0) - 4.746) < 2e-3  # Lemma 3, as tests/test_core.py
    assert alpha_of_gamma(0.752) > 1.0 > alpha_of_gamma(0.751)
    assert 0.0 < rho_star(1.5, 9.0) < 1.0
    with pytest.raises(ValueError, match="quant_dtype"):
        DBLSHParams(n=10, d=2, quant_dtype="fp8").resolve()


def test_collision_prob_matches_reference():
    """Both sides evaluate erf in float32 (different implementations):
    agreement to a few float32 ulps."""
    tau = np.array([0.1, 0.5, 1.0, 1.5, 3.0, 10.0], np.float32)
    for w in (0.5, 4.0, 9.0):
        ref = np.asarray(R.collision_prob(tau, w))
        got = collision_prob(torch.from_numpy(tau), w).numpy()
        np.testing.assert_allclose(got, ref, rtol=5e-7, atol=5e-7)
    assert (np.diff(collision_prob(torch.from_numpy(tau), 9.0).numpy()) <= 0).all()


def _assert_index_equal(got, ref_index):
    arrs = R.index_arrays(ref_index)
    for f in R.INDEX_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), arrs[f], err_msg=f)
    assert got.params == DBLSHParams(**R.index_params(ref_index))


@pytest.mark.parametrize("d,inline", [(16, True), (24, False), (24, True)])
def test_build_exact_on_integer_data(d, inline):
    """Integer-valued data and hash functions make every projection exact
    in float32 whatever the summation order, so the block arrays must be
    bit-equal.  Small integers give many exact ties and duplicate rows:
    the STR stable-sort tie order is what this pins."""
    rng = np.random.default_rng(d)
    n = 1500
    data = rng.integers(-3, 4, (n, d)).astype(np.float32)
    data[700:760] = data[:60]  # duplicate rows
    data[900:910] = data[5]
    params = R.DBLSHParams.derive(n=n, d=d, c=1.5, t=20, k=10, K=6, L=3,
                                  block_size=32, inline_vectors=inline)
    pv = rng.integers(-2, 3, (params.L, params.K, d)).astype(np.float32)
    ref = R.build_from(data, params, pv)
    got = build(data, DBLSHParams(**dataclasses.asdict(params)), proj_vecs=pv, device=CPU)
    _assert_index_equal(got, ref)


def test_build_matches_reference_fixture():
    """Real-valued clustered data under the reference's hash functions.

    XLA and torch sum the d = 24 products of a projection in different
    orders, so projections may differ by ~1e-6 (ROADMAP queue C),
    and two points whose sort keys lie that close may swap places.  So:
    each table holds the same points, at most 0.1 % of the slots differ,
    and wherever the slot ids agree the block arrays agree to that
    rounding (absolute: a sum's error scales with its terms, not its
    result, so ulps of a near-zero projection say nothing)."""
    data, _, ref = R.onepass_fixture()
    got = build(data, DBLSHParams(**R.index_params(ref)),
                proj_vecs=np.asarray(ref.proj_vecs), device=CPU)
    arrs = R.index_arrays(ref)
    gi, ri = got.ids_blocks.numpy(), arrs["ids_blocks"]
    for li in range(gi.shape[0]):
        np.testing.assert_array_equal(np.sort(gi[li], None), np.sort(ri[li], None))
    same = gi == ri
    assert same.mean() >= 0.999, same.mean()
    np.testing.assert_array_equal(got.vec_blocks.numpy()[same], arrs["vec_blocks"][same])
    a, b = got.proj_blocks.numpy()[same], arrs["proj_blocks"][same]
    assert (np.isinf(a) == np.isinf(b)).all()
    fin = np.isfinite(b)
    tol = 2e-6 * np.abs(b[fin]).max()  # f32 rounding at the projections' scale
    np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=tol)
    np.testing.assert_allclose(got.norm_blocks.numpy()[same], arrs["norm_blocks"][same],
                               rtol=1e-6)
    # an MBR moves only where a swapped point crossed its block's edge
    blk_same = same.all(axis=-1)
    for f in ("mbr_lo", "mbr_hi"):
        np.testing.assert_allclose(getattr(got, f).numpy()[blk_same],
                                   arrs[f][blk_same], rtol=0, atol=tol)


def test_from_arrays_roundtrip():
    data, _, ref = R.onepass_fixture()
    arrays = R.index_arrays(ref)
    idx = from_arrays(arrays, R.index_params(ref), device=CPU)
    for f, a in arrays.items():
        t = getattr(idx, f)
        assert t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), a, err_msg=f)
    assert idx.ids_blocks.dtype == torch.int32
    assert (idx.n, idx.nb) == (ref.n, ref.nb)
    assert idx.params == DBLSHParams(**R.index_params(ref))
    assert idx.memory_bytes() == ref.memory_bytes()
    with pytest.raises(ValueError, match="lack"):
        from_arrays({"data": arrays["data"]}, R.index_params(ref), device=CPU)


def test_brute_force_matches_reference():
    data, queries, _ = R.onepass_fixture()
    rd, ri = map(np.asarray, R.brute_force(data, queries, k=10))
    gd, gi = brute_force(data, queries, k=10, device=CPU)
    # norm form ||q||^2 - 2 q.x + ||x||^2 cancels: matmul rounding moves
    # distances by up to ~1e-3 at these norms (the search's norm-form
    # tolerance, tests/test_onepass_search.py:91)
    np.testing.assert_allclose(gd.numpy(), rd, rtol=1e-2, atol=1e-2)
    for a, b in zip(gi.numpy(), ri):
        assert set(a.tolist()) == set(b.tolist())


def test_make_clustered_and_normalize():
    """Same distribution as the reference, from a torch.Generator: shape,
    dtype, determinism per seed, and a median NN distance of 1 after
    normalize_scale."""
    gen = lambda: torch.Generator().manual_seed(3)
    a = make_clustered(gen(), 1500, 16, n_clusters=6, spread=0.02, device=CPU)
    b = make_clustered(gen(), 1500, 16, n_clusters=6, spread=0.02, device=CPU)
    assert a.shape == (1500, 16) and a.dtype == torch.float32
    assert torch.equal(a, b) and torch.isfinite(a).all()
    data, queries, scale = normalize_scale(a[:1400], a[1400:])
    d, _ = brute_force(data, queries, k=1, device=CPU)
    assert abs(float(d[:, 0].quantile(0.5)) - 1.0) < 1e-2  # norm-form rounding
    assert scale > 0
