"""The per-slot distance kernels B4 (``window_dist``) and B5
(``candidate_dist``) and the pool engines of ``_gather_pool``: the twins
vs the reference's Pallas kernels (interpret mode) at the shapes and
tolerances of tests/test_kernels.py, the port's ``_gather_pool`` vs the
reference's on tests/test_onepass_search.py's fixture, the wrappers'
checks.  The kernels themselves are held against the twins on a CUDA
device by tests/test_torch_kernels.py, on these inputs.

Inputs are made with numpy and handed to both packages.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import ENGINES, from_arrays  # noqa: E402
from repro_torch.core.serve_search import _gather_pool, _schedule  # noqa: E402
from repro_torch.kernels import candidate_dist, launches, window_dist  # noqa: E402
from repro_torch.kernels import ref as twin  # noqa: E402

REF_ENGINE = {"torch": "jnp", "kernel": "kernel", "inline": "inline"}

WINDOW_SHAPES = [  # (Q, L, M, nb, B, K, d), test_kernels.py:151-154
    (2, 2, 4, 16, 32, 4, 16),
    (1, 3, 8, 8, 64, 12, 96),  # M == nb
]
CAND_SHAPES = [  # (Q, L, Ct, K, d), test_kernels.py:122-126
    (2, 3, 64, 4, 16),
    (1, 5, 300, 12, 96),  # Ct not a multiple of the reference's tile
    (4, 1, 32, 2, 8),
]


@pytest.fixture(scope="module")
def R():
    return pytest.importorskip("_torch_parity")


def _t(arrays, device="cpu"):
    return [torch.from_numpy(np.array(a)).to(device) for a in arrays]


def _mk_window(seed, Q, L, M, nb, B, K, d):
    """test_kernels.py::test_window_dist_matches_ref's inputs: the last
    block's back half +inf-padded, block ids including the sentinel L*nb."""
    rng = np.random.default_rng(seed)
    lnb = L * nb
    proj = (rng.standard_normal((lnb, B, K)) * 2.0).astype(np.float32)
    vec = rng.standard_normal((lnb, B, d)).astype(np.float32)
    nrm = np.sum(vec * vec, axis=-1).astype(np.float32)
    proj[-1, B // 2:, :] = np.inf
    nrm[-1, B // 2:] = np.inf
    blk = rng.integers(0, lnb + 1, (Q, L * M)).astype(np.int32)
    g = rng.standard_normal((Q, L, K)).astype(np.float32)
    q = rng.standard_normal((Q, d)).astype(np.float32)
    return blk, proj, vec, nrm, g, q


def _mk_cand(seed, Q, L, Ct, K, d):
    """test_kernels.py::test_candidate_dist_matches_ref's inputs: every
    7th slot invalid (+inf projection and norm)."""
    rng = np.random.default_rng(seed)
    cp = (rng.standard_normal((Q, L, Ct, K)) * 2.0).astype(np.float32)
    cv = rng.standard_normal((Q, L, Ct, d)).astype(np.float32)
    cn = np.sum(cv * cv, axis=-1).astype(np.float32)
    cp[:, :, ::7, :] = np.inf
    cn[:, :, ::7] = np.inf
    g = rng.standard_normal((Q, L, K)).astype(np.float32)
    q = rng.standard_normal((Q, d)).astype(np.float32)
    return cp, cv, cn, g, q


def _assert_pool_close(got, want):
    """tests/test_kernels.py's pool comparison: hw to rtol 1e-6, d2 where
    hw is finite (the contract masks the rest through hw) to rtol = atol =
    1e-4."""
    gd, gh = (np.asarray(x) for x in got)
    wd, wh = want
    np.testing.assert_allclose(gh, wh, rtol=1e-6)
    mask = np.isfinite(wh)
    np.testing.assert_allclose(gd[mask], wd[mask], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", WINDOW_SHAPES)
@pytest.mark.parametrize("exact", [False, True])
def test_window_dist_twin_matches_reference(R, shape, exact):
    """B4's twin (through the wrapper, on CPU tensors) against the
    reference's kernel in interpret mode and its jnp oracle, with
    tests/test_kernels.py's tolerances; on every slot of an invalid block
    both outputs are +inf in both forms, as the reference's kernel writes
    them."""
    Q, L, M, nb, B, K, d = shape
    args = _mk_window(Q + M + nb + L, Q, L, M, nb, B, K, d)
    kern, oracle = R.window_dist_both(*args, M=M, exact=exact)
    before = dict(launches)
    got = [x.numpy() for x in window_dist(*_t(args), M=M, exact=exact)]
    assert launches == before
    assert got[0].shape == got[1].shape == (Q, L * M * B)
    _assert_pool_close(got, kern)
    _assert_pool_close(got, oracle)
    invalid = np.repeat(args[0] >= L * nb, B, axis=1)
    assert invalid.any()
    for d2, hw in (got, kern):
        assert np.isinf(hw[invalid]).all() and np.isinf(d2[invalid]).all()
    if not exact:  # the +inf-padded rows of the last block stay +inf in norm form
        padded = np.isinf(np.asarray(kern[0]))
        assert np.isinf(got[0][padded]).all()


@pytest.mark.parametrize("shape", CAND_SHAPES)
@pytest.mark.parametrize("exact", [False, True])
def test_candidate_dist_twin_matches_reference(R, shape, exact):
    """B5's twin against the reference's kernel in interpret mode and its
    jnp oracle; +inf norms give +inf d2 in norm form."""
    Q, L, Ct, K, d = shape
    args = _mk_cand(Q * Ct + d, Q, L, Ct, K, d)
    kern, oracle = R.candidate_dist_both(*args, exact=exact)
    got = [x.numpy() for x in candidate_dist(*_t(args), exact=exact)]
    assert got[0].shape == (Q, L * Ct)
    _assert_pool_close(got, kern)
    _assert_pool_close(got, oracle)
    inf_proj = np.isinf(args[0][..., 0]).reshape(Q, -1)
    assert np.isinf(got[1][inf_proj]).all()
    if exact:  # the diff form computes the real distance of an invalid slot
        assert np.isfinite(got[0]).all()
    else:
        assert np.isinf(got[0][np.isinf(args[2]).reshape(Q, -1)]).all()


def _all_invalid_case():
    """test_kernels.py::test_invalid_slots_never_contribute: block 0
    matches the query exactly (hw = 0, d2 = 0), and every select slot
    carries the invalid id L*nb."""
    L, M, nb, B, K, d = 1, 4, 4, 8, 4, 8
    lnb = L * nb
    q = np.random.default_rng(5).standard_normal((1, d)).astype(np.float32)
    g = np.zeros((1, L, K), np.float32)
    proj = np.zeros((lnb, B, K), np.float32)
    vec = np.broadcast_to(q[0], (lnb, B, d)).copy()
    nrm = np.full((lnb, B), np.sum(q * q), np.float32)
    blk = np.full((1, L * M), lnb, np.int32)
    return (blk, proj, vec, nrm, g, q), M


@pytest.mark.parametrize("exact", [False, True])
def test_window_dist_all_invalid(R, exact):
    """Every slot unadmittable (+inf d2 and hw) though block 0 matches the
    query exactly — the twin and the reference's kernel alike."""
    args, M = _all_invalid_case()
    (kd2, khw), _ = R.window_dist_both(*args, M=M, exact=exact)
    d2, hw = window_dist(*_t(args), M=M, exact=exact)
    for a in (d2.numpy(), hw.numpy(), kd2, khw):
        assert np.isinf(a).all()
    # the same blocks through a valid id are found at distance 0
    args[0][0, 0] = 0
    d2, hw = window_dist(*_t(args), M=M, exact=exact)
    assert (hw[0, :8] == 0).all() and (d2[0, :8].abs() < 1e-5).all()
    assert torch.isinf(hw[0, 8:]).all() and torch.isinf(d2[0, 8:]).all()


# ------------------------------------------------- _gather_pool's engines


@pytest.fixture(scope="module")
def pool_setup(R):
    """The onepass fixture, its port index (``from_arrays``), and the
    reference's selection at the final radius of the 8-step schedule from
    r0 = 0.5, flattened across tables as ``search_batch_fixed`` does."""
    data, queries, ref = R.onepass_fixture()
    index = from_arrays(R.index_arrays(ref), R.index_params(ref), device="cpu")
    p = ref.params
    w = float(np.float32(p.w0) * np.float32(0.5 * 1.5 ** 7))
    blk, _, G = R.select_blocks(ref, queries, w)  # (L, Q, M), (Q, L, K)
    nb = ref.nb
    offs = (np.arange(p.L, dtype=np.int32) * nb)[:, None, None]
    blk_q = np.where(blk < nb, blk + offs, p.L * nb).transpose(1, 0, 2)
    blk_q = np.ascontiguousarray(blk_q.reshape(queries.shape[0], -1).astype(np.int32))
    return queries, ref, index, blk_q, G


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("engine", ENGINES)
def test_gather_pool_matches_reference(R, pool_setup, engine, exact):
    """The port's ``_gather_pool`` on each engine (on CPU tensors the
    kernel engines run the B4/B5 twins) against the reference's on the
    same arrays, blocks and projections: hw bit-equal (an elementwise max,
    no reduction order), d2 where hw is finite within the rounding of a
    d-term sum of positive terms in another order in the exact form
    (d * 2^-24 = 1.4e-6 relative at d = 24: the pool holds distances up to
    ~1e4, where the top-k's 2 ulps of tests/test_torch_serve_search.py
    become 3) or, in norm form, an atol
    scaled by the norms (4e-6 x (max ||x||^2 + max ||q||^2), ~0.05 here):
    ||x||^2 - 2<q,x> + ||q||^2 cancels, so its rounding follows the norms
    (~6.7e3 on this fixture), not d2 (ROADMAP queue C)."""
    queries, ref, index, blk_q, G = pool_setup
    want_d2, want_hw = R.gather_pool(ref, blk_q, G, queries, REF_ENGINE[engine], exact)
    before = dict(launches)
    d2, hw = (x.numpy() for x in _gather_pool(
        index, *_t((blk_q, G, queries)), engine, exact))
    assert launches == before
    np.testing.assert_array_equal(hw, want_hw)
    fin = np.isfinite(want_hw)
    assert fin.any() and not fin.all()
    if exact:
        d = queries.shape[1]
        np.testing.assert_allclose(d2[fin], want_d2[fin], rtol=d * 2.0 ** -24, atol=5e-7)
    else:
        nrm = index.norm_blocks
        scale = float(nrm[torch.isfinite(nrm)].max()) + float(np.max(np.sum(queries ** 2, -1)))
        np.testing.assert_allclose(d2[fin], want_d2[fin], rtol=1e-5, atol=4e-6 * scale)


@pytest.mark.parametrize("exact", [False, True])
def test_gather_pool_engines_agree(pool_setup, exact):
    """Within the port on one device the three engines give bit-equal hw
    and bit-equal d2 wherever hw is finite (the twins compute the torch
    engine's per-slot arithmetic); the pool, binned, equals the fused
    twins' bins (B1 for 'inline', B2 for 'kernel')."""
    queries, _, index, blk_q, G = pool_setup
    args = _t((blk_q, G, queries))
    pools = {e: _gather_pool(index, *args, e, exact) for e in ENGINES}
    fin = torch.isfinite(pools["torch"][1])
    for e in ("kernel", "inline"):
        assert torch.equal(pools[e][1], pools["torch"][1]), e
        assert torch.equal(pools[e][0][fin], pools["torch"][0][fin]), e
    p = index.params
    L, M, B, nb, n = p.L, p.max_blocks, p.block_size, index.nb, index.n
    halves = torch.tensor(np.array(_schedule(p, 0.5, 8)[1], np.float32))
    blk_t = args[0]
    ids = twin.take_fill(index.ids_blocks.reshape(L * nb, B), blk_t, n).reshape(len(blk_t), -1)
    mode = "exact" if exact else "norm"
    bins = twin.bins_from_pool(*pools["inline"], ids, halves, n, 10)
    fused = twin.fused_window_search_ref(
        blk_t, halves, index.proj_blocks.reshape(L * nb, B, -1),
        index.vec_blocks.reshape(L * nb, B, -1), index.norm_blocks.reshape(L * nb, B),
        index.ids_blocks.reshape(L * nb, B), args[1], args[2], M=M, ks=10, n=n, mode=mode)
    for a, b in zip(bins, fused):
        assert torch.equal(a, b)


def test_gather_pool_inline_needs_inline_vectors(R, pool_setup):
    """The gather layout (no vec_blocks): 'kernel' gathers the rows of
    ``data`` by id and agrees with the inline layout; 'inline' raises."""
    queries, ref, index, blk_q, G = pool_setup
    params = R.index_params(ref)
    params["inline_vectors"] = False
    arrays = R.index_arrays(ref)
    arrays["vec_blocks"] = np.zeros((0,), np.float32)
    gather = from_arrays(arrays, params, device="cpu")
    args = _t((blk_q, G, queries))
    a = _gather_pool(index, *args, "kernel", True)
    b = _gather_pool(gather, *args, "kernel", True)
    fin = torch.isfinite(a[1])
    assert torch.equal(a[1], b[1]) and torch.equal(a[0][fin], b[0][fin])
    with pytest.raises(ValueError, match="inline_vectors"):
        _gather_pool(gather, *args, "inline", True)


def test_wrappers_reject_wrong_dtypes_shapes_and_mixed_devices():
    """Wrong dtypes, wrong shapes, S != L*M and operands on several devices
    raise before anything runs, on CPU tensors too."""
    wargs = _t(_mk_window(0, 2, 2, 4, 16, 32, 4, 16))
    bad = list(wargs)
    bad[0] = bad[0].long()
    with pytest.raises(TypeError, match="blk_idx"):
        window_dist(*bad, M=4)
    bad = list(wargs)
    bad[5] = bad[5].double()
    with pytest.raises(TypeError, match="q"):
        window_dist(*bad, M=4)
    with pytest.raises(ValueError, match="L\\*M"):
        window_dist(*wargs, M=3)
    bad = list(wargs)
    bad[0] = bad[0].to("meta")
    with pytest.raises(ValueError, match="devices"):
        window_dist(*bad, M=4)
    cargs = _t(_mk_cand(0, 2, 3, 64, 4, 16))
    bad = list(cargs)
    bad[1] = bad[1].to(torch.bfloat16)
    with pytest.raises(TypeError, match="cand_vecs"):
        candidate_dist(*bad)
    bad = list(cargs)
    bad[2] = bad[2][..., :-1]
    with pytest.raises(ValueError, match="cand_norms"):
        candidate_dist(*bad)
    bad = list(cargs)
    bad[4] = bad[4].to("meta")
    with pytest.raises(ValueError, match="devices"):
        candidate_dist(*bad)
