"""The search kernels: the fused one-pass kernels' twins vs the
reference's Pallas kernels (interpret mode) and ``fused_search_ref``, the
per-radius verify kernels' twins vs the reference's Pallas kernels and
jnp oracles, the merge primitives vs the reference, and — on a CUDA
device only — each kernel vs its twin (B4/B5/B8 on the inputs of
tests/test_torch_dist.py and tests/test_torch_pairwise_l2.py, which hold
their twins against the reference).

Inputs are made with numpy and handed to both packages.  The reference
side comes in through the ``R`` fixture, so that the CUDA cases also run
where JAX is not installed.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import merge_dedup_topk  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    candidate_dist,
    candidate_verify,
    fused_cand_search,
    fused_window_search,
    launches,
    merge_schedule,
    pairwise_l2,
    select_blocks,
    window_dist,
    window_verify,
)
from repro_torch.kernels import mode_launches  # noqa: E402
from repro_torch.kernels import ref as twin  # noqa: E402
# B4/B5/B8 on the card take the inputs of their CPU tests, which hold the
# twins against the reference
from test_torch_dist import CAND_SHAPES as DIST_CAND_SHAPES  # noqa: E402
from test_torch_dist import WINDOW_SHAPES as DIST_WINDOW_SHAPES  # noqa: E402
from test_torch_dist import _all_invalid_case  # noqa: E402
from test_torch_dist import _mk_cand as _mk_dist_cand  # noqa: E402
from test_torch_dist import _mk_window as _mk_dist_window  # noqa: E402
from test_torch_dist import _t as _td  # noqa: E402
from test_torch_pairwise_l2 import SHAPES as L2_SHAPES  # noqa: E402
from test_torch_pairwise_l2 import TORCH_DTYPE as TORCH_L2_DTYPE  # noqa: E402
from test_torch_pairwise_l2 import _inputs as _l2_inputs  # noqa: E402
from test_torch_pairwise_l2 import _t as _tl2  # noqa: E402

IMAX = np.iinfo(np.int32).max


@pytest.fixture(scope="module")
def R():
    return pytest.importorskip("_torch_parity")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _halves(steps):
    return np.asarray([0.4 * 1.5 ** j for j in range(steps)], np.float32)


def _mk_window(seed, Q, L, M, nb, B, K, d, steps):
    """test_kernels.py::_mk_window's construction, from numpy: each table
    holds every slot id at most once, ids >= n are +inf-padded slots, and
    the block ids include the invalid sentinel L*nb."""
    rng = np.random.default_rng(seed)
    lnb = L * nb
    n = lnb * B - 3
    data = rng.standard_normal((n, d)).astype(np.float32)
    ids = rng.permutation(lnb * B).reshape(lnb, B).astype(np.int32)
    vec = np.where((ids < n)[..., None], data[np.minimum(ids, n - 1)], 0.0).astype(np.float32)
    nrm = np.where(ids < n, np.sum(vec * vec, axis=-1), np.inf).astype(np.float32)
    proj = np.where((ids < n)[..., None], rng.standard_normal((lnb, B, K)) * 2.0,
                    np.inf).astype(np.float32)
    blk = rng.integers(0, lnb + 1, (Q, L * M)).astype(np.int32)
    g = rng.standard_normal((Q, L, K)).astype(np.float32)
    q = rng.standard_normal((Q, d)).astype(np.float32)
    return (blk, _halves(steps), proj, vec, nrm, ids, g, q), n


def _mk_cand(seed, Q, L, Ct, K, d, steps, n=4096):
    """test_kernels.py's gathered inputs: every 7th slot invalid (+inf
    projection and norm)."""
    rng = np.random.default_rng(seed)
    cp = (rng.standard_normal((Q, L, Ct, K)) * 2.0).astype(np.float32)
    cx = rng.standard_normal((Q, L, Ct, d)).astype(np.float32)
    cn = np.sum(cx * cx, axis=-1).astype(np.float32)
    ci = rng.integers(0, n, (Q, L, Ct)).astype(np.int32)
    cp[:, :, ::7, :] = np.inf
    cn[:, :, ::7] = np.inf
    g = rng.standard_normal((Q, L, K)).astype(np.float32)
    q = rng.standard_normal((Q, d)).astype(np.float32)
    return (cp, cx, cn, ci, _halves(steps), g, q), n


def _t(arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


def _assert_bins_equal(got, ref):
    """test_kernels.py::_assert_bins_equal: counts exact, distances
    allclose, ids as sets per (query, bin) over the finite entries."""
    gd, gi, gc = (np.asarray(x.cpu()) if torch.is_tensor(x) else np.asarray(x) for x in got)
    rd, ri, rc = map(np.asarray, ref)
    np.testing.assert_array_equal(gc, rc)
    np.testing.assert_allclose(gd, rd, rtol=1e-5, atol=1e-5)
    Qn, steps, _ = gd.shape
    for qq in range(Qn):
        for j in range(steps):
            finite = np.isfinite(rd[qq, j])
            assert set(gi[qq, j][finite]) == set(ri[qq, j][finite]), (qq, j)
            assert (gi[qq, j][~np.isfinite(gd[qq, j])] != IMAX).all()


WINDOW_SHAPES = [  # (Q, L, M, nb, B, K, d, ks), test_kernels.py:223-226
    (2, 2, 4, 8, 32, 4, 16, 5),
    (1, 3, 8, 8, 64, 12, 96, 20),  # M == nb
]
CAND_SHAPES = [  # (Q, L, Ct, K, d, ks), test_kernels.py:252-255
    (2, 3, 64, 4, 16, 5),
    (1, 2, 300, 12, 96, 20),  # ragged Ct
]


@pytest.mark.parametrize("shape", WINDOW_SHAPES)
@pytest.mark.parametrize("steps", [1, 4, 8])
@pytest.mark.parametrize("mode", ["norm", "exact"])
def test_window_twin_matches_reference(R, shape, steps, mode):
    Q, L, M, nb, B, K, d, ks = shape
    args, n = _mk_window(Q + L * M + nb + steps, Q, L, M, nb, B, K, d, steps)
    pallas, oracle = R.fused_window(*args, M=M, ks=ks, n=n, mode=mode)
    got = fused_window_search(*_t(args), M=M, ks=ks, n=n, mode=mode)
    _assert_bins_equal(got, pallas)
    _assert_bins_equal(got, oracle)


@pytest.mark.parametrize("shape", CAND_SHAPES)
@pytest.mark.parametrize("steps", [1, 6])
@pytest.mark.parametrize("mode", ["norm", "exact"])
def test_cand_twin_matches_reference(R, shape, steps, mode):
    Q, L, Ct, K, d, ks = shape
    args, n = _mk_cand(Q * Ct + d + steps, Q, L, Ct, K, d, steps)
    pallas, oracle = R.fused_cand(*args, ks=ks, n=n, mode=mode)
    got = fused_cand_search(*_t(args), ks=ks, n=n, mode=mode)
    _assert_bins_equal(got, pallas)
    _assert_bins_equal(got, oracle)


def _invalid_slot_case():
    """test_kernels.py::test_invalid_slots_never_contribute: block 0
    matches the query exactly (hw = 0, d2 = 0) and must still contribute
    nothing through an invalid select slot."""
    L, M, nb, B, K, d = 1, 4, 4, 8, 4, 8
    lnb = L * nb
    n = lnb * B
    q = np.random.default_rng(5).standard_normal((1, d)).astype(np.float32)
    g = np.zeros((1, L, K), np.float32)
    proj = np.zeros((lnb, B, K), np.float32)
    vec = np.broadcast_to(q[0], (lnb, B, d)).copy()
    nrm = np.full((lnb, B), np.sum(q * q), np.float32)
    ids = np.arange(lnb * B, dtype=np.int32).reshape(lnb, B)
    return (proj, vec, nrm, ids, g, q), M, B, n, lnb


def _check_invalid_slots(device):
    (proj, vec, nrm, ids, g, q), M, B, n, lnb = _invalid_slot_case()
    halves = _halves(4)
    for blk, want_cnt in ((np.full((1, M), lnb, np.int32), 0),
                          (np.asarray([[2, lnb, lnb, lnb]], np.int32), B)):
        bd, bi, cnt = (x.cpu().numpy() for x in fused_window_search(
            *_t((blk, halves, proj, vec, nrm, ids, g, q), device),
            M=M, ks=B, n=n, mode="norm"))
        assert int(cnt.sum()) == want_cnt
        got_ids = set(bi[np.isfinite(bd)].tolist())
        assert got_ids == (set(ids[2].tolist()) if want_cnt else set())
        assert (bi[~np.isfinite(bd)] == n).all()


def test_invalid_slots_never_contribute():
    _check_invalid_slots("cpu")


def test_merge_topk_pins(R):
    """The two pins of test_kernels.py:415-440, against the reference."""
    cases = [
        ([1.0, 2.0, 3.0, np.inf], [7, 7, 9, 0], [1.0, 2.0, 3.0], [7, 7, 9]),
        ([2.0, 2.0, 2.0, 5.0], [4, 4, 4, 8], [2.0, 5.0, np.inf], [4, 8, IMAX]),
    ]
    for cd, ci, want_d, want_i in cases:
        cd = np.asarray(cd, np.float32)
        ci = np.asarray(ci, np.int32)
        out_d = np.full((3,), np.inf, np.float32)
        out_i = np.full((3,), IMAX, np.int32)
        nd, ni = twin.merge_topk(*_t((cd, ci, out_d, out_i)), 3)
        rd, ri = map(np.asarray, R.merge_topk(cd, ci, out_d, out_i, 3))
        np.testing.assert_array_equal(nd.numpy(), want_d)
        np.testing.assert_array_equal(ni.numpy(), want_i)
        np.testing.assert_array_equal(nd.numpy(), rd)
        np.testing.assert_array_equal(ni.numpy(), ri)


@pytest.mark.parametrize("seed", range(8))
def test_merge_dedup_topk_matches_reference(R, seed):
    """test_kernels.py::test_merge_dedup_topk_property: duplicates, exact
    ties and all-inf rows, against the reference and a host oracle."""
    rng = np.random.default_rng(seed)
    n, Qn = 64, 3
    k, a, b = int(rng.integers(1, 13)), int(rng.integers(1, 17)), int(rng.integers(1, 25))
    run_d = np.sort(rng.choice([0.5, 1.0, 2.0, np.inf], (Qn, a)), axis=1).astype(np.float32)
    run_i = np.where(np.isfinite(run_d), rng.integers(0, n, (Qn, a)), n).astype(np.int32)
    new_d = rng.choice([0.25, 0.5, 1.0, 3.0, np.inf], (Qn, b)).astype(np.float32)
    new_i = np.where(np.isfinite(new_d), rng.integers(0, n, (Qn, b)), n).astype(np.int32)
    if seed % 3 == 0:
        new_d[0, :] = np.inf
    gd, gi = (x.numpy() for x in merge_dedup_topk(*_t((run_d, run_i, new_d, new_i)), n, k))
    rd, ri = map(np.asarray, R.merge_dedup_topk(run_d, run_i, new_d, new_i, n, k))
    np.testing.assert_array_equal(gd, rd)
    np.testing.assert_array_equal(gi, ri)
    for qq in range(Qn):
        pairs = {(float(x), int(i)) for x, i in zip(np.r_[run_d[qq], new_d[qq]],
                                                    np.r_[run_i[qq], new_i[qq]])
                 if np.isfinite(x)}
        want = sorted(pairs)[:k]
        np.testing.assert_array_equal(gd[qq], [p[0] for p in want] + [np.inf] * (k - len(want)))
        np.testing.assert_array_equal(gi[qq], [p[1] for p in want] + [n] * (k - len(want)))


def test_merge_dedup_topk_tie_overflow():
    """More than k candidates at one distance: the k smallest ids win."""
    n, k = 100, 4
    run_d = torch.full((1, k), torch.inf)
    run_i = torch.full((1, k), n, dtype=torch.int32)
    new_d = torch.full((1, 8), 2.0)
    new_i = torch.tensor([[31, 3, 55, 14, 90, 2, 77, 41]], dtype=torch.int32)
    gd, gi = merge_dedup_topk(run_d, run_i, new_d, new_i, n, k)
    assert gd[0].tolist() == [2.0] * k
    assert gi[0].tolist() == [2, 3, 14, 31]


def test_wrappers_reject_unported_modes_and_mixed_devices():
    """Unknown modes, vectors of another dtype than the mode's, and a
    dequant scale missing (quantized modes) or given (float32 modes)
    raise before anything runs; so do operands on several devices."""
    args, n = _mk_window(0, 1, 2, 4, 8, 32, 4, 16, 2)
    with pytest.raises(ValueError, match="fp16"):
        fused_window_search(*_t(args), M=4, ks=5, n=n, mode="fp16")
    with pytest.raises(TypeError, match="bf16"):
        fused_window_search(*_t(args), M=4, ks=5, n=n, mode="bf16",
                            x_scale=torch.ones(args[3].shape[:2]))
    cargs, n = _mk_cand(0, 1, 2, 16, 4, 8, 2)
    cq = _t(cargs)
    cq[1] = cq[1].to(torch.int8)
    with pytest.raises(ValueError, match="cand_scale"):
        fused_cand_search(*cq, ks=5, n=n, mode="int8")
    with pytest.raises(ValueError, match="cand_scale"):
        fused_cand_search(*_t(cargs), ks=5, n=n, cand_scale=torch.ones(cargs[2].shape))
    with pytest.raises(TypeError, match="cand_scale"):
        fused_cand_search(*cq, ks=5, n=n, mode="int8",
                          cand_scale=torch.ones(cargs[2].shape, dtype=torch.float64))
    bad = _t(args)
    bad[0] = bad[0].to("meta")
    with pytest.raises(ValueError, match="devices"):
        fused_window_search(*bad, M=4, ks=5, n=n)


def _mk_verify_cand(seed, Q, C, K, d, n):
    """test_kernels.py::_mk_candidates from numpy: ids in [0, n], so some
    slots carry the invalid id n."""
    rng = np.random.default_rng(seed)
    cp = (rng.standard_normal((Q, C, K)) * 2.0).astype(np.float32)
    cv = rng.standard_normal((Q, C, d)).astype(np.float32)
    ci = rng.integers(0, n + 1, (Q, C)).astype(np.int32)
    g = rng.standard_normal((Q, K)).astype(np.float32)
    q = rng.standard_normal((Q, d)).astype(np.float32)
    return cp, cv, ci, g, q


def _mk_verify_window(seed, Q, M, nb, B, K, d):
    """test_kernels.py::test_window_verify_matches_ref's inputs from numpy:
    each id at most once in the table, ids >= n padding, block ids
    including the invalid sentinel nb."""
    rng = np.random.default_rng(seed)
    n = nb * B - 3
    proj = (rng.standard_normal((nb, B, K)) * 2.0).astype(np.float32)
    vec = rng.standard_normal((nb, B, d)).astype(np.float32)
    ids = rng.permutation(nb * B).reshape(nb, B).astype(np.int32)
    blk = rng.integers(0, nb + 1, (Q, M)).astype(np.int32)
    g = rng.standard_normal((Q, K)).astype(np.float32)
    q = rng.standard_normal((Q, d)).astype(np.float32)
    return (blk, proj, vec, ids, g, q), n


def _assert_topk_equal(got, ref):
    """test_kernels.py::_assert_topk_equal: distances allclose (the twin
    sums d in torch's order, the kernels in their own), ids as sets per
    query over the finite entries, unfilled ids ``n``-or-IMAX-free."""
    gd, gi = (np.asarray(x.cpu()) if torch.is_tensor(x) else np.asarray(x) for x in got)
    rd, ri = map(np.asarray, ref)
    np.testing.assert_allclose(gd, rd, rtol=1e-5, atol=1e-5)
    for qq in range(gd.shape[0]):
        finite = np.isfinite(rd[qq])
        assert set(gi[qq][finite]) == set(ri[qq][finite]), qq
        assert (gi[qq][~finite] != IMAX).all()


VERIFY_CAND_SHAPES = [  # (Q, C, K, d, k), test_kernels.py:55-60
    (1, 64, 4, 16, 5),
    (3, 256, 12, 128, 50),
    (2, 100, 8, 33, 10),  # non-multiple C and odd d
    (4, 32, 2, 8, 32),  # k == C
]
VERIFY_WINDOW_SHAPES = [  # (Q, M, nb, B, K, d, k), test_kernels.py:95-98
    (2, 4, 16, 32, 4, 16, 5),
    (1, 8, 8, 64, 12, 96, 20),  # M == nb
]


@pytest.mark.parametrize("shape", VERIFY_CAND_SHAPES)
def test_candidate_verify_twin_matches_reference(R, shape):
    Q, C, K, d, k = shape
    n = 1000
    args = _mk_verify_cand(Q * C + d, Q, C, K, d, n)
    pallas, oracle = R.candidate_verify_both(*args, 2.5, n=n, k=k)
    got = candidate_verify(*_t(args), 2.5, n=n, k=k)
    assert got[1].dtype == torch.int32 and tuple(got[0].shape) == (Q, k)
    _assert_topk_equal(got, pallas)
    _assert_topk_equal(got, oracle)
    np.testing.assert_array_equal(got[1].numpy()[~np.isfinite(pallas[0])], n)


def _verify_dedup_args():
    """test_kernels.py::test_candidate_verify_dedup: one candidate
    repeated 8x, all in the window."""
    Q, C, K, d, n = 1, 64, 4, 16, 100
    cp, cv, ci, g, q = _mk_verify_cand(0, Q, C, K, d, n)
    ci[ci == 7] = 8
    cp[:, :8, :] = g[:, None, :]
    cv[:, :8, :] = 0.5
    ci[:, :8] = 7
    return (cp, cv, ci, g, q), n


def test_candidate_verify_twin_dedup(R):
    """k == C: every distinct candidate is kept, the repeated one once."""
    args, n = _verify_dedup_args()
    got_d, got_i = (x.numpy() for x in candidate_verify(*_t(args), 100.0, n=n, k=64))
    assert (got_i[0][np.isfinite(got_d[0])] == 7).sum() == 1
    pallas, _ = R.candidate_verify_both(*args, 100.0, n=n, k=64)
    _assert_topk_equal((got_d, got_i), pallas)


def _verify_all_masked_args():
    """test_kernels.py::test_candidate_verify_all_masked: every box far
    from g, w = 0.5."""
    Q, C, K, d, n = 2, 64, 4, 16, 50
    cp, cv, ci, g, q = _mk_verify_cand(1, Q, C, K, d, n)
    return (cp + np.float32(100.0), cv, ci, g, q), n


def test_candidate_verify_twin_all_masked():
    args, n = _verify_all_masked_args()
    got_d, got_i = candidate_verify(*_t(args), 0.5, n=n, k=5)
    assert torch.isinf(got_d).all() and (got_i == n).all()


@pytest.mark.parametrize("shape", VERIFY_WINDOW_SHAPES)
def test_window_verify_twin_matches_reference(R, shape):
    Q, M, nb, B, K, d, k = shape
    args, n = _mk_verify_window(Q + M + nb, Q, M, nb, B, K, d)
    pallas, oracle = R.window_verify_both(*args, 3.0, n=n, k=k)
    got = window_verify(*_t(args), 3.0, n=n, k=k)
    _assert_topk_equal(got, pallas)
    _assert_topk_equal(got, oracle)
    np.testing.assert_array_equal(got[1].numpy()[~np.isfinite(pallas[0])], n)


def test_window_verify_invalid_block_ids():
    """Block ids outside [0, nb) — the sentinel nb, larger ids, negative
    ids — contribute nothing: the result equals that of the valid ids
    alone."""
    (blk, proj, vec, ids, g, q), n = _mk_verify_window(3, 2, 6, 8, 16, 4, 8)
    blk[:, :3] = np.arange(3)
    bad = blk.copy()
    bad[:, 3:] = [8, -1, 1 << 20]
    only = blk.copy()
    only[:, 3:] = 8
    got = window_verify(*_t((bad, proj, vec, ids, g, q)), 1e6, n=n, k=60)
    want = window_verify(*_t((only, proj, vec, ids, g, q)), 1e6, n=n, k=60)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (torch.isfinite(got[0]).sum(dim=1) == int((ids[:3] < n).sum())).all()


# ---------------------------------------------------- on a CUDA device only

@pytest.mark.cuda
@pytest.mark.parametrize("shape", WINDOW_SHAPES + [(8, 3, 8, 8, 64, 12, 24, 50)])
@pytest.mark.parametrize("steps", [1, 4, 8])
@pytest.mark.parametrize("mode", ["norm", "exact"])
def test_window_kernel_matches_twin(cuda, shape, steps, mode):
    Q, L, M, nb, B, K, d, ks = shape
    args, n = _mk_window(Q + L * M + nb + steps, Q, L, M, nb, B, K, d, steps)
    before = launches["fused_window_search"]
    got = fused_window_search(*_t(args, cuda), M=M, ks=ks, n=n, mode=mode)
    torch.cuda.synchronize()
    assert launches["fused_window_search"] == before + 1
    _assert_bins_equal(got, fused_window_search(*_t(args), M=M, ks=ks, n=n, mode=mode))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CAND_SHAPES + [(4, 3, 320, 10, 24, 50)])
@pytest.mark.parametrize("steps", [1, 6])
@pytest.mark.parametrize("mode", ["norm", "exact"])
def test_cand_kernel_matches_twin(cuda, shape, steps, mode):
    Q, L, Ct, K, d, ks = shape
    args, n = _mk_cand(Q * Ct + d + steps, Q, L, Ct, K, d, steps)
    before = launches["fused_cand_search"]
    got = fused_cand_search(*_t(args, cuda), ks=ks, n=n, mode=mode)
    torch.cuda.synchronize()
    assert launches["fused_cand_search"] == before + 1
    _assert_bins_equal(got, fused_cand_search(*_t(args), ks=ks, n=n, mode=mode))


def _quantize_case(args, x_idx, mode):
    """Quantize the float32 vectors args[x_idx] per slot (the reference's
    quantize_blocks rule, through the port's twin of it) and return the
    args with the quantized vectors, plus the slot scales."""
    from repro_torch.core import quantize_blocks

    x = torch.from_numpy(args[x_idx])
    flat = x.reshape(-1, x.shape[-1])
    qx, qs = quantize_blocks(flat, torch.arange(flat.shape[0], dtype=torch.int32), mode)
    out = list(_t(args))
    out[x_idx] = qx.reshape(x.shape)
    return out, qs.reshape(x.shape[:-1])


def _assert_b3_equal(got, want, mode):
    """Against the twin run on the same CUDA tensors.  int8: every output
    equal bit for bit (an exact integer dot, then the twin's rounded
    dequant steps on the same q2); bf16: as the float32 modes (the dot is
    summed in another order)."""
    if mode == "int8":
        for a, b in zip(got, want):
            assert torch.equal(a, b), (a, b)
    else:
        _assert_bins_equal(got, [x.cpu() for x in want])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 2, 4, 8, 32, 4, 16, 8), (2, 2, 4, 8, 32, 4, 24, 40),
                                   (8, 3, 8, 8, 64, 12, 24, 40)])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_window_kernel_quantized_matches_twin(cuda, shape, mode):
    """Kernel B3 in B1: test_kernels.py:280-357's shapes (invalid block
    ids, steps 6) and the quantized shortlist width ks = 40."""
    Q, L, M, nb, B, K, d, ks = shape
    args, n = _mk_window(Q + d + ks, Q, L, M, nb, B, K, d, 6)
    qargs, qs = _quantize_case(args, 3, mode)
    kw = dict(M=M, ks=ks, n=n, mode=mode)
    before = mode_launches["fused_window_search"][mode]
    cargs = [a.to(cuda) for a in qargs]
    got = fused_window_search(*cargs, x_scale=qs.to(cuda), **kw)
    torch.cuda.synchronize()
    assert mode_launches["fused_window_search"][mode] == before + 1
    _assert_b3_equal(got, twin.fused_window_search_ref(*cargs, x_scale=qs.to(cuda), **kw), mode)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 3, 64, 4, 16, 20), (1, 2, 300, 12, 96, 40),
                                   (4, 3, 320, 10, 24, 40)])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_cand_kernel_quantized_matches_twin(cuda, shape, mode):
    """Kernel B3 in B2, ragged Ct included."""
    Q, L, Ct, K, d, ks = shape
    args, n = _mk_cand(Q * Ct + d + ks, Q, L, Ct, K, d, 6)
    qargs, qs = _quantize_case(args, 1, mode)
    kw = dict(ks=ks, n=n, mode=mode)
    before = mode_launches["fused_cand_search"][mode]
    cargs = [a.to(cuda) for a in qargs]
    got = fused_cand_search(*cargs, cand_scale=qs.to(cuda), **kw)
    torch.cuda.synchronize()
    assert mode_launches["fused_cand_search"][mode] == before + 1
    _assert_b3_equal(got, twin.fused_cand_search_ref(*cargs, cand_scale=qs.to(cuda), **kw), mode)


@pytest.mark.cuda
def test_kernel_invalid_slots_never_contribute(cuda):
    _check_invalid_slots(cuda)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_kernel_rejects_oversized_pool(cuda):
    """More candidate slots than the block's shared memory holds raise
    before any launch."""
    args, n = _mk_cand(1, 1, 4, 8000, 4, 8, 2)
    with pytest.raises(ValueError, match="shared memory"):
        fused_cand_search(*_t(args, cuda), ks=5, n=n)


# The fused kernels' edges: bins sorted in registers and in chunks, the
# bucketing, the staging tiles, the element loads, the launch shapes.
# Integer-valued vectors and projections make every float32 sum exact, so
# the kernels equal their twins bit for bit in every mode (bf16 rounds
# small integers exactly; int8's dot is exact by construction).

def _int_proj(rng, g, Ct_shape, bins):
    """Projections around g: 'spread' over the schedule's bins, 'one'
    (hw = 0: every slot in bin 0), 'none' (outside every window)."""
    if bins == "one":
        return np.broadcast_to(g, Ct_shape).astype(np.float32).copy()
    if bins == "none":
        return (g + 1000.0).astype(np.float32) + np.zeros(Ct_shape, np.float32)
    return (g + rng.integers(-3, 4, Ct_shape) * 0.25).astype(np.float32)


def _int_cand(seed, Q, L, Ct, K, d, steps, *, vals=2, bins="spread", dup=False, n=4096):
    """Gathered candidates with integer vectors in [-vals, vals]; dup: every
    table holds the same Ct points (same rows, same ids) in its own order,
    so each point sits in L slots of one query."""
    rng = np.random.default_rng(seed)
    if dup:
        pts = rng.integers(-vals, vals + 1, (Q, Ct, d)).astype(np.float32)
        pid = np.stack([rng.choice(n, Ct, replace=False) for _ in range(Q)]).astype(np.int32)
        perm = np.stack([[rng.permutation(Ct) for _ in range(L)] for _ in range(Q)])
        qq = np.arange(Q)[:, None, None]
        cx, ci = pts[qq, perm], pid[qq, perm]
    else:
        cx = rng.integers(-vals, vals + 1, (Q, L, Ct, d)).astype(np.float32)
        ci = rng.integers(0, n, (Q, L, Ct)).astype(np.int32)
    g = rng.integers(-4, 5, (Q, L, 1, K)).astype(np.float32)
    cp = _int_proj(rng, g, (Q, L, Ct, K), bins)
    cn = np.sum(cx * cx, axis=-1).astype(np.float32)
    if bins == "spread":
        cp[:, :, ::7, :] = np.inf
        cn[:, :, ::7] = np.inf
    return (cp, np.ascontiguousarray(cx), cn, np.ascontiguousarray(ci), _halves(steps),
            np.ascontiguousarray(g[:, :, 0]), rng.integers(-vals, vals + 1, (Q, d)).astype(
                np.float32)), n


def _int_window(seed, Q, L, M, nb, B, K, d, steps, *, vals=2, bins="spread"):
    """STR blocks with integer vectors; each table holds every point once
    (so with M == nb each point sits in L selected blocks); block ids
    include the invalid sentinel L*nb where bins == 'spread'."""
    rng = np.random.default_rng(seed)
    lnb, n = L * nb, nb * B
    data = rng.integers(-vals, vals + 1, (n, d)).astype(np.float32)
    ids = np.concatenate([rng.permutation(n) for _ in range(L)]).reshape(lnb, B)
    ids = ids.astype(np.int32)
    vec = data[ids]
    nrm = np.sum(vec * vec, axis=-1).astype(np.float32)
    g = rng.integers(-4, 5, (Q, L, K)).astype(np.float32)
    # each block's projections around table 0's query projection of query 0
    proj = _int_proj(rng, g[0, 0], (lnb, B, K), bins)
    if bins != "spread":
        blk = np.stack([np.concatenate([rng.permutation(nb)[:M] + l * nb for l in range(L)])
                        for _ in range(Q)])
    else:
        blk = rng.integers(0, lnb + 1, (Q, L * M))
    g[:] = g[0, 0]  # every query and table shares the blocks' centre
    return (blk.astype(np.int32), _halves(steps), proj, vec, nrm, ids, g,
            rng.integers(-vals, vals + 1, (Q, d)).astype(np.float32)), n


def _fused_bits(kind, args, n, mode, ks, device, M=None, misalign=False):
    """The kernel on ``device`` against its twin on the same tensors: every
    output equal bit for bit.  Returns the kernel's outputs."""
    x_idx = 3 if kind == "window" else 1
    if mode in ("bf16", "int8"):
        targs, scale = _quantize_case(args, x_idx, mode)
        scale = scale.to(device)
    else:
        targs, scale = _t(args), None
    targs = [a.to(device) for a in targs]
    if misalign:
        targs[x_idx] = _misaligned(targs[x_idx])
        assert targs[x_idx].data_ptr() % 16 != 0
    if kind == "window":
        kw = dict(M=M, ks=ks, n=n, mode=mode, x_scale=scale)
        wrapper, ref = fused_window_search, twin.fused_window_search_ref
    else:
        kw = dict(ks=ks, n=n, mode=mode, cand_scale=scale)
        wrapper, ref = fused_cand_search, twin.fused_cand_search_ref
    before = launches[wrapper.__name__]
    got = wrapper(*targs, **kw)
    torch.cuda.synchronize()
    assert launches[wrapper.__name__] == before + 1
    want = ref(*targs, **kw)
    for name, a, b in zip(("bins_d", "bins_i", "cnt"), got, want):
        assert torch.equal(a, b), name
    return got


FUSED_MODES = ["norm", "exact", "bf16", "int8"]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", FUSED_MODES)
@pytest.mark.parametrize("ks", [10, 40])
def test_fused_kernels_dedup_across_tables(cuda, mode, ks):
    """Every point in L = 5 slots of its query, 120 or 128 distinct points
    per bin (more than ks, and 600 or 640 slots: past one 512-key buffer,
    so the bin is cut more than once); each bin keeps each id once."""
    for kind, args, n, M in (
            ("cand", *_int_cand(ks, 3, 5, 120, 6, 16, 4, bins="one", dup=True), None),
            ("window", *_int_window(ks + 1, 3, 5, 4, 4, 32, 6, 16, 4, bins="one"), 4)):
        bd, bi, cnt = _fused_bits(kind, args, n, mode, ks, cuda, M=M)
        assert bool((cnt[:, 0] == (600 if kind == "cand" else 640)).all())
        for row_d, row_i in zip(bd.reshape(-1, ks).cpu(), bi.reshape(-1, ks).cpu()):
            kept = row_i[torch.isfinite(row_d)].tolist()
            assert len(kept) == len(set(kept))
        assert bool(torch.isfinite(bd[:, 0]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", FUSED_MODES)
@pytest.mark.parametrize("kind", ["cand", "window"])
def test_fused_kernels_ties_on_d2(cuda, mode, kind):
    """Vectors in {-1, 0, 1}^4: few distinct distances, many ids on each;
    ties resolve to the smallest ids, as in the twin."""
    if kind == "cand":
        args, n = _int_cand(5, 4, 3, 200, 4, 4, 6, vals=1)
        _fused_bits(kind, args, n, mode, 40, cuda)
    else:
        args, n = _int_window(6, 4, 3, 5, 8, 40, 4, 4, 6, vals=1)
        _fused_bits(kind, args, n, mode, 40, cuda, M=5)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", FUSED_MODES)
@pytest.mark.parametrize("ks", [10, 40, 490])
def test_fused_kernels_one_big_bin(cuda, mode, ks):
    """Every slot in bin 0, 3,000 of them (many 512-key buffers), and
    ks = 490, past the buffer's room, which takes the argmin rounds."""
    args, n = _int_cand(ks + 2, 2, 5, 600, 10, 8, 8, vals=6, bins="one")
    bd, _, cnt = _fused_bits("cand", args, n, mode, ks, cuda)
    assert bool((cnt[:, 0] == 3000).all()) and bool((cnt[:, 1:] == 0).all())
    assert bool(torch.isinf(bd[:, 1:]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", FUSED_MODES)
def test_fused_kernels_every_slot_outside(cuda, mode):
    """No slot in any window: counts 0, every bin unfilled (+inf, n)."""
    for kind, args, n, M in (("cand", *_int_cand(7, 3, 4, 90, 6, 8, 5, bins="none"), None),
                             ("window", *_int_window(8, 3, 2, 3, 6, 32, 6, 8, 5,
                                                     bins="none"), 3)):
        bd, bi, cnt = _fused_bits(kind, args, n, mode, 12, cuda, M=M)
        assert bool((cnt == 0).all()) and bool(torch.isinf(bd).all()) and bool((bi == n).all())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", FUSED_MODES)
@pytest.mark.parametrize("d", [33, 12, 64])
@pytest.mark.parametrize("misalign", [False, True])
def test_fused_kernels_ragged_tiles_and_element_loads(cuda, mode, d, misalign):
    """C not a multiple of the staging tile (B2: 3 x 101 slots; B1: blocks
    of 24 rows), d % 4 != 0 or rows not whole 16-byte chunks (d = 33, and
    d = 12 in bf16/int8) and x bases one element into their buffers: the
    element loads, the same values in the same order."""
    args, n = _int_cand(d, 5, 3, 101, 7, d, 6)
    _fused_bits("cand", args, n, mode, 20, cuda, misalign=misalign)
    args, n = _int_window(d + 1, 5, 3, 7, 9, 24, 7, d, 6)
    _fused_bits("window", args, n, mode, 20, cuda, M=7, misalign=misalign)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", FUSED_MODES)
@pytest.mark.parametrize("Q", [1, 5, 64, 200])
def test_fused_kernels_launch_shapes(cuda, mode, Q):
    """The main path's shape (L = 5, M = 5, B = 64, K = 10, d = 64, steps
    8; ks = 40 as the quantized shortlist) at Q below 132 (a cluster of 4
    or 2 blocks per query) and above (one block)."""
    args, n = _int_window(Q, Q, 5, 5, 12, 64, 10, 64, 8, vals=3)
    _fused_bits("window", args, n, mode, 40, cuda, M=5)
    args, n = _int_cand(Q + 1, Q, 5, 320, 10, 64, 8, vals=3)
    _fused_bits("cand", args, n, mode, 40, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["norm", "exact"])
@pytest.mark.parametrize("K", [10, 3077])
@pytest.mark.parametrize("Q", [1, 4, 64])
def test_fused_kernels_at_lm_width(cuda, mode, K, Q):
    """The kNN-LM datastore's width: Yi-9B's hidden states (d = 4096), at
    K = 10 and at the K = 3077, L = 2, M = 5, B = 64 derived for 262,144
    keys, steps 6, ks = 8, Q = 1, the serving engine's 4 slots and 64: a
    staged x row is 16 KB and a projection row 12 KB, so a stage holds a
    few rows; bit-equal to the twin on integer inputs."""
    args, n = _int_window(Q + K, Q, 2, 5, 8, 64, K, 4096, 6)
    _fused_bits("window", args, n, mode, 8, cuda, M=5)
    args, n = _int_cand(Q + K + 1, Q, 2, 320, K, 4096, 6)
    _fused_bits("cand", args, n, mode, 8, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", VERIFY_CAND_SHAPES)
def test_candidate_verify_kernel_matches_twin(cuda, shape):
    Q, C, K, d, k = shape
    n = 1000
    args = _mk_verify_cand(Q * C + d, Q, C, K, d, n)
    for w in (2.5, 1e6):
        before = launches["candidate_verify"]
        got = candidate_verify(*_t(args, cuda), w, n=n, k=k)
        torch.cuda.synchronize()
        assert launches["candidate_verify"] == before + 1
        _assert_topk_equal(got, candidate_verify(*_t(args), w, n=n, k=k))


@pytest.mark.cuda
def test_candidate_verify_kernel_dedup_and_all_masked(cuda):
    args, n = _verify_dedup_args()
    got = candidate_verify(*_t(args, cuda), 100.0, n=n, k=64)
    _assert_topk_equal(got, candidate_verify(*_t(args), 100.0, n=n, k=64))
    assert int((got[1][0][torch.isfinite(got[0][0])] == 7).sum()) == 1
    args, n = _verify_all_masked_args()
    got_d, got_i = candidate_verify(*_t(args, cuda), 0.5, n=n, k=5)
    assert torch.isinf(got_d).all() and (got_i == n).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", VERIFY_WINDOW_SHAPES)
def test_window_verify_kernel_matches_twin(cuda, shape):
    Q, M, nb, B, K, d, k = shape
    args, n = _mk_verify_window(Q + M + nb, Q, M, nb, B, K, d)
    args[0][0, -1] = -1  # invalid ids besides the sentinel nb
    args[0][-1, 0] = 1 << 20
    for w in (3.0, 1e6):
        before = launches["window_verify"]
        got = window_verify(*_t(args, cuda), w, n=n, k=k)
        torch.cuda.synchronize()
        assert launches["window_verify"] == before + 1
        _assert_topk_equal(got, window_verify(*_t(args), w, n=n, k=k))


@pytest.mark.cuda
def test_verify_kernels_reject_oversized_pool(cuda):
    args = _mk_verify_cand(1, 1, 30000, 4, 8, 100)
    with pytest.raises(ValueError, match="shared memory"):
        candidate_verify(*_t(args, cuda), 1.0, n=100, k=5)


# The verify kernels' edges: the staging tiles, the element loads, the
# block-wide selection, the cluster shares.  Integer-valued vectors make
# every d2 exact, and projections g + {0, +-0.75} put a slot's hw at 0 or
# 0.75 exactly, so at w = 1 the kernels equal their twins bit for bit.

def _int_levels(rng, g, shape, p_in):
    """Projections around g (broadcast to ``shape``): a slot lies in the
    window of w = 1 (hw = 0) with probability p_in, else hw = 0.75."""
    out = rng.random(shape[:-1]) >= p_in
    off = rng.integers(-1, 2, shape) * 0.75
    off[..., 0] = 0.75
    return (g + np.where(out[..., None], off, 0.0)).astype(np.float32)


def _int_verify_cand(seed, Q, C, K, d, *, vals=2, p_in=0.7, n=4096):
    """Gathered candidates with integer vectors in [-vals, vals]; ids in
    [0, n] (some slots carry the invalid id n), every 7th slot invalid
    (+inf projection)."""
    rng = np.random.default_rng(seed)
    g = rng.integers(-4, 5, (Q, K)).astype(np.float32)
    cp = _int_levels(rng, g[:, None, :], (Q, C, K), p_in)
    cp[:, ::7] = np.inf
    cv = rng.integers(-vals, vals + 1, (Q, C, d)).astype(np.float32)
    ci = rng.integers(0, n + 1, (Q, C)).astype(np.int32)
    q = rng.integers(-vals, vals + 1, (Q, d)).astype(np.float32)
    return (cp, cv, ci, g, q), n


def _int_verify_window(seed, Q, M, nb, B, K, d, *, vals=2, p_in=0.7):
    """STR blocks of one table with integer vectors, each id at most once,
    ids >= n padding; every query shares the blocks' centre g; block ids
    include the sentinel nb, -1 and 2^20 (M >= 3)."""
    rng = np.random.default_rng(seed)
    n = nb * B - 3
    g = np.repeat(rng.integers(-4, 5, (1, K)), Q, axis=0).astype(np.float32)
    proj = _int_levels(rng, g[0], (nb, B, K), p_in)
    vec = rng.integers(-vals, vals + 1, (nb, B, d)).astype(np.float32)
    ids = rng.permutation(nb * B).reshape(nb, B).astype(np.int32)
    blk = rng.integers(0, nb, (Q, M)).astype(np.int32)
    if M >= 3:
        blk[:, -1] = nb
        blk[0, 0] = -1
        blk[-1, 1] = 1 << 20
    q = rng.integers(-vals, vals + 1, (Q, d)).astype(np.float32)
    return (blk, proj, vec, ids, g, q), n


def _verify_bits(kind, args, n, k, device, w=1.0, misalign=False):
    """The verify kernel on ``device`` against its twin on the same tensors:
    both outputs equal bit for bit.  Returns the kernel's outputs."""
    targs = [a.to(device) for a in _t(args)]
    x_idx = 2 if kind == "window" else 1
    if misalign:
        targs[x_idx] = _misaligned(targs[x_idx])
        assert targs[x_idx].data_ptr() % 16 != 0
    wrapper, ref = ((window_verify, twin.window_verify_ref) if kind == "window"
                    else (candidate_verify, twin.candidate_verify_ref))
    before = launches[wrapper.__name__]
    got = wrapper(*targs, w, n=n, k=k)
    torch.cuda.synchronize()
    assert launches[wrapper.__name__] == before + 1
    want = ref(*targs, w, n=n, k=k)
    assert torch.equal(got[0], want[0]), "distances"
    assert torch.equal(got[1], want[1]), "ids"
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    ("cand", 1, 1000, 10, 64),   # a cluster of 4, 250 slots a block: past one stage tile
    ("cand", 200, 301, 10, 64),  # one block a query, 128-slot tiles, the last ragged
    ("window", 200, 5, 12, 64),  # the main path's blocks (M = 5, B = 64) at Q = 200
    ("window", 3, 7, 9, 24),     # blocks of 24 rows, a share not a multiple of a tile
])
def test_verify_kernels_stage_tiles(cuda, case):
    kind, Q, a, b, c = case
    if kind == "cand":
        args, n = _int_verify_cand(Q + a, Q, a, b, c)
    else:
        args, n = _int_verify_window(Q + a, Q, a, b, c, 7 if c == 24 else 10, 64)
    _verify_bits(kind, args, n, 10, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [12, 33])
@pytest.mark.parametrize("misalign", [False, True])
def test_verify_kernels_element_loads(cuda, d, misalign):
    """d = 33 (rows not whole 16-byte chunks), K = 7 (4-byte projection
    copies) and x bases one element into their buffers: the element
    copies, the same values in the same order."""
    args, n = _int_verify_cand(d, 5, 101, 7, d)
    _verify_bits("cand", args, n, 20, cuda, misalign=misalign)
    args, n = _int_verify_window(d + 1, 5, 7, 9, 24, 7, d)
    _verify_bits("window", args, n, 20, cuda, misalign=misalign)


@pytest.mark.cuda
def test_verify_kernels_dedup(cuda):
    """One point in many slots of its query: B7 with one candidate (at
    d2 = 0) repeated in 40 slots spread over the cluster's shares, the
    other ids distinct; B6 with one block selected five times; B7 again
    on a pool too large to rank by counting.  Each id is kept once."""
    args, n = _int_verify_cand(11, 3, 320, 10, 16, p_in=1.0)
    cp, cv, ci, g, q = args
    rep = np.arange(0, 320, 8)
    ci[:] = 3 * np.arange(320) + 1
    cp[:, rep] = g[:, None, :]
    cv[:, rep] = q[:, None, :]
    ci[:, rep] = 17
    got = _verify_bits("cand", (cp, cv, ci, g, q), n, 64, cuda)
    for row_d, row_i in zip(*(x.cpu() for x in got)):
        kept = row_i[torch.isfinite(row_d)].tolist()
        assert len(kept) == len(set(kept)) and 17 in kept
    args, n = _int_verify_window(12, 4, 6, 8, 32, 10, 16, p_in=1.0)
    args[0][:, :4] = args[0][:, 4:5]
    bd, bi = _verify_bits("window", args, n, 64, cuda)
    for row_d, row_i in zip(bd.cpu(), bi.cpu()):
        kept = row_i[torch.isfinite(row_d)].tolist()
        assert len(kept) == len(set(kept))
    # a pool too large to rank by counting (selected by the warps' lists)
    args, n = _int_verify_cand(19, 1, 1600, 10, 16, p_in=1.0)
    cp, cv, ci, g, q = args
    rep = np.arange(0, 1600, 50)
    ci[:] = 3 * np.arange(1600) + 1
    cp[:, rep] = g[:, None, :]
    cv[:, rep] = q[:, None, :]
    ci[:, rep] = 17
    bd, bi = _verify_bits("cand", (cp, cv, ci, g, q), n, 10, cuda)
    kept = bi[0][torch.isfinite(bd[0])].tolist()
    assert kept[0] == 17 and len(kept) == len(set(kept))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["cand", "window"])
@pytest.mark.parametrize("Q", [4, 200])
def test_verify_kernels_ties_on_d2(cuda, kind, Q):
    """Vectors in {-1, 0, 1}^4: few distinct distances, many ids on each;
    ties resolve to the smallest ids, as in the twin (Q = 4 ranks by
    counting, Q = 200 by the warps' lists)."""
    if kind == "cand":
        args, n = _int_verify_cand(13 + Q, Q, 320, 4, 4, vals=1)
    else:
        args, n = _int_verify_window(14 + Q, Q, 5, 8, 64, 4, 4, vals=1)
    _verify_bits(kind, args, n, 64, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["cand", "window"])
def test_verify_kernels_sparse_windows(cuda, kind):
    """Fewer in-window slots than k (unfilled entries +inf, n), and no slot
    in the window at all."""
    for p_in, k in ((0.01, 40), (0.0, 10)):
        if kind == "cand":
            args, n = _int_verify_cand(15, 5, 320, 10, 64, p_in=p_in)
        else:
            args, n = _int_verify_window(16, 5, 5, 12, 64, 10, 64, p_in=p_in)
        bd, bi = _verify_bits(kind, args, n, k, cuda)
        filled = torch.isfinite(bd)
        assert bool((~filled[:, -1]).all()) and bool((bi[~filled] == n).all())
        if p_in == 0.0:
            assert not bool(filled.any())


@pytest.mark.cuda
def test_verify_kernels_invalid_block_ids(cuda):
    """Block ids outside [0, nb) (the sentinel nb, -1, 2^20) contribute
    nothing: bit-equal to the call with every invalid id replaced by nb."""
    args, n = _int_verify_window(17, 6, 6, 10, 64, 10, 64)
    blk = args[0]
    blk[:, 3:] = [10, -1, 1 << 20]
    got = _verify_bits("window", args, n, 64, cuda)
    only = blk.copy()
    only[:, 3:] = 10
    want = _verify_bits("window", (only, *args[1:]), n, 64, cuda)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [1, 5, 64, 200])
@pytest.mark.parametrize("k", [1, 10, 64])
def test_verify_kernels_launch_shapes(cuda, Q, k):
    """The main path's shape (M = 5, B = 64, K = 10, d = 64; C = 320) at Q
    below 132 (clusters of 4, 4 and 2 blocks) and above (one block)."""
    args, n = _int_verify_window(Q + k, Q, 5, 12, 64, 10, 64, vals=3)
    _verify_bits("window", args, n, k, cuda)
    args, n = _int_verify_cand(Q + k + 1, Q, 320, 10, 64, vals=3)
    _verify_bits("cand", args, n, k, cuda)


@pytest.mark.cuda
def test_verify_kernels_argmin_rounds(cuda):
    """k = 500, past a warp's buffer: k argmin rounds over the cluster's
    keys, with more than k distinct in-window slots."""
    args, n = _int_verify_cand(18, 2, 1200, 10, 16, vals=6, p_in=0.9, n=100_000)
    bd, _ = _verify_bits("cand", args, n, 500, cuda)
    assert bool(torch.isfinite(bd).all())


# ------------------------------------------- B4, B5 and B8 on the card


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DIST_WINDOW_SHAPES + [(4, 5, 5, 40, 64, 10, 64)])
@pytest.mark.parametrize("exact", [False, True])
def test_window_dist_kernel_matches_twin(cuda, shape, exact):
    """B4 vs its twin on the card: hw bit-equal, d2 where hw is finite to
    rtol = atol = 1e-5 (the twin sums the dot in another order), both +inf
    on every slot of an invalid block; one launch per call."""
    Q, L, M, nb, B, K, d = shape
    args = _td(_mk_dist_window(Q + M + nb + L, Q, L, M, nb, B, K, d), cuda)
    before = launches["window_dist"]
    got = window_dist(*args, M=M, exact=exact)
    torch.cuda.synchronize()
    assert launches["window_dist"] == before + 1
    want = twin.window_dist_ref(*args, M=M, exact=exact)
    assert torch.equal(got[1], want[1])
    fin = torch.isfinite(want[1])
    torch.testing.assert_close(got[0][fin], want[0][fin], rtol=1e-5, atol=1e-5)
    invalid = torch.repeat_interleave(args[0] >= L * nb, B, dim=1)
    assert torch.isinf(got[0][invalid]).all() and torch.isinf(got[1][invalid]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DIST_CAND_SHAPES)
@pytest.mark.parametrize("exact", [False, True])
def test_candidate_dist_kernel_matches_twin(cuda, shape, exact):
    """B5 vs its twin on the card: hw bit-equal, d2 where hw is finite to
    rtol = atol = 1e-5; one launch per call."""
    Q, L, Ct, K, d = shape
    args = _td(_mk_dist_cand(Q * Ct + d, Q, L, Ct, K, d), cuda)
    before = launches["candidate_dist"]
    got = candidate_dist(*args, exact=exact)
    torch.cuda.synchronize()
    assert launches["candidate_dist"] == before + 1
    want = twin.candidate_dist_ref(*args, exact=exact)
    assert torch.equal(got[1], want[1])
    fin = torch.isfinite(want[1])
    torch.testing.assert_close(got[0][fin], want[0][fin], rtol=1e-5, atol=1e-5)
    if not exact:
        assert torch.isinf(got[0][torch.isinf(args[2]).reshape(Q, -1)]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [False, True])
def test_window_dist_kernel_all_invalid(cuda, exact):
    args, M = _all_invalid_case()
    d2, hw = window_dist(*_td(args, cuda), M=M, exact=exact)
    assert torch.isinf(d2).all() and torch.isinf(hw).all()


# B4/B5's edges: integer-valued inputs make every sum exact in float32, so
# both forms equal the twin bit for bit whatever the order of the sums


def _int_dist_window(seed, Q, L, M, nb, B, K, d, *, p_invalid=0.2):
    """B4 inputs in small integers: block ids drawn from every table, a
    share of them invalid (-1, the sentinel L*nb, 2^20) between valid ones;
    the last block's back half +inf-padded."""
    rng = np.random.default_rng(seed)
    lnb = L * nb
    proj = rng.integers(-3, 4, (lnb, B, K)).astype(np.float32)
    vec = rng.integers(-2, 3, (lnb, B, d)).astype(np.float32)
    nrm = np.sum(vec * vec, axis=-1).astype(np.float32)
    proj[-1, B // 2:] = np.inf
    nrm[-1, B // 2:] = np.inf
    blk = rng.integers(0, lnb, (Q, L * M)).astype(np.int32)
    bad = rng.random((Q, L * M)) < p_invalid
    blk[bad] = rng.choice(np.array([-1, lnb, 1 << 20], np.int32), int(bad.sum()))
    g = rng.integers(-3, 4, (Q, L, K)).astype(np.float32)
    q = rng.integers(-2, 3, (Q, d)).astype(np.float32)
    return blk, proj, vec, nrm, g, q


def _int_dist_cand(seed, Q, L, Ct, K, d):
    """B5 inputs in small integers; every 7th slot invalid (+inf projection
    and norm)."""
    rng = np.random.default_rng(seed)
    cp = rng.integers(-3, 4, (Q, L, Ct, K)).astype(np.float32)
    cv = rng.integers(-2, 3, (Q, L, Ct, d)).astype(np.float32)
    cn = np.sum(cv * cv, axis=-1).astype(np.float32)
    cp[:, :, ::7] = np.inf
    cn[:, :, ::7] = np.inf
    g = rng.integers(-3, 4, (Q, L, K)).astype(np.float32)
    q = rng.integers(-2, 3, (Q, d)).astype(np.float32)
    return cp, cv, cn, g, q


def _dist_bits(kind, args, exact, device, M=None, misalign=False):
    """B4 (kind 'window') or B5 ('cand') on the card, one launch, both
    outputs bit-equal to the twin; with ``misalign``, the vectors, the
    projections and the queries on bases not 16-byte aligned (element
    copies), and bit-equal to the aligned call too.  Returns (d2, hw)."""
    ts = _td(args, device)
    name, fn = ("window_dist", window_dist) if kind == "window" else (
        "candidate_dist", candidate_dist)
    kw = dict(exact=exact, **({"M": M} if kind == "window" else {}))
    moved = [(_misaligned(t) if misalign and i in (1, 2, 5) else t)
             for i, t in enumerate(ts)] if kind == "window" else [
        (_misaligned(t) if misalign and i in (0, 1, 4) else t) for i, t in enumerate(ts)]
    before = launches[name]
    got = fn(*moved, **kw)
    torch.cuda.synchronize()
    assert launches[name] == before + 1
    ref = (twin.window_dist_ref if kind == "window" else twin.candidate_dist_ref)(*ts, **kw)
    assert torch.equal(got[1], ref[1]), "hw"
    assert torch.equal(got[0], ref[0]), "d2"
    if misalign:
        aligned = fn(*ts, **kw)
        assert torch.equal(got[0], aligned[0]) and torch.equal(got[1], aligned[1])
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["window", "cand"])
@pytest.mark.parametrize("exact", [False, True])
def test_dist_kernels_walk_many_units(cuda, kind, exact):
    """5,000 units of 64 rows at the main widths: several times the
    persistent grid's blocks, so every block refills its stage."""
    if kind == "window":
        args = _int_dist_window(11, 200, 5, 5, 40, 64, 10, 64)
        _dist_bits(kind, args, exact, cuda, M=5)
    else:
        _dist_bits(kind, _int_dist_cand(12, 200, 5, 320, 10, 64), exact, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,rows", [("window", 7), ("window", 100), ("window", 130),
                                       ("cand", 1), ("cand", 65), ("cand", 100),
                                       ("cand", 333)])
@pytest.mark.parametrize("exact", [False, True])
def test_dist_kernels_ragged_units(cuda, kind, rows, exact):
    """A block of B != 64 rows (B4: 7, 100 = 64 + 36, 130 = 64 + 64 + 2)
    and Ct not a multiple of the 64-slot unit (B5): ragged units."""
    if kind == "window":
        _dist_bits(kind, _int_dist_window(rows, 6, 3, 4, 9, rows, 10, 64), exact, cuda, M=4)
    else:
        _dist_bits(kind, _int_dist_cand(rows, 6, 3, rows, 10, 64), exact, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["window", "cand"])
@pytest.mark.parametrize("d", [12, 33])
@pytest.mark.parametrize("misalign", [False, True])
@pytest.mark.parametrize("exact", [False, True])
def test_dist_kernels_element_loads(cuda, kind, d, misalign, exact):
    """d = 12 (16-byte rows on an aligned base; element copies when the
    base is moved) and d = 33 (element copies always), also with the
    projections (even K) and the queries on unaligned bases."""
    if kind == "window":
        _dist_bits(kind, _int_dist_window(d, 9, 3, 5, 12, 64, 10, d), exact, cuda, M=5,
                   misalign=misalign)
    else:
        _dist_bits(kind, _int_dist_cand(d, 9, 3, 150, 10, d), exact, cuda, misalign=misalign)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["window", "cand"])
@pytest.mark.parametrize("K", [1, 5, 7])
@pytest.mark.parametrize("exact", [False, True])
def test_dist_kernels_odd_k(cuda, kind, K, exact):
    """Odd K: the projections in 4-byte copies, read one word at a time."""
    if kind == "window":
        _dist_bits(kind, _int_dist_window(K, 7, 3, 5, 12, 64, K, 64), exact, cuda, M=5)
    else:
        _dist_bits(kind, _int_dist_cand(K, 7, 3, 130, K, 64), exact, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("exact", [False, True])
def test_window_dist_kernel_invalid_blocks(cuda, exact):
    """Invalid block ids (-1, L*nb, 2^20) between valid ones, and a query
    whose every block is invalid: +inf in both outputs on exactly those
    slots, bit-equal to the twin elsewhere."""
    Q, L, M, nb, B, K, d = 6, 3, 5, 12, 64, 10, 64
    args = _int_dist_window(21, Q, L, M, nb, B, K, d, p_invalid=0.4)
    args[0][2] = np.array([-1, L * nb, 1 << 20] * 5, np.int32)
    d2, hw = _dist_bits("window", args, exact, cuda, M=M)
    blk = torch.from_numpy(args[0]).to(cuda)
    invalid = torch.repeat_interleave((blk < 0) | (blk >= L * nb), B, dim=1)
    assert bool(invalid[2].all()) and bool((~invalid).any())
    assert torch.isinf(d2[invalid]).all() and torch.isinf(hw[invalid]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["window", "cand"])
@pytest.mark.parametrize("Q", [1, 5, 64, 200])
@pytest.mark.parametrize("exact", [False, True])
def test_dist_kernels_launch_shapes(cuda, kind, Q, exact):
    """Q = 1 (fewer units than the grid could hold) to 200, at the main
    widths, bit-equal to the twin on integer inputs."""
    if kind == "window":
        _dist_bits(kind, _int_dist_window(Q, Q, 5, 5, 30, 64, 10, 64), exact, cuda, M=5)
    else:
        _dist_bits(kind, _int_dist_cand(Q, Q, 5, 320, 10, 64), exact, cuda)


def _pairwise_l2_twin(q, x):
    """B8's twin on the card, TF32 off."""
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return twin.pairwise_l2_ref(q, x)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


# the edges of the bf16 kernel's tile (128 x 128, d in steps of 64): nq
# above one row tile and ragged (129, 3000); nn % 4 != 0 (4099: scalar
# stores on rows not 16-byte aligned); d = 1, 33, 65 (element loads), 72
# (16-byte cp.async, not a multiple of 64) and 960 (15 steps)
L2_EDGE_SHAPES = [(129, 4099, 72), (3000, 4099, 65), (129, 300, 1), (3000, 4096, 64),
                  (129, 4099, 33), (129, 4099, 960)]
# the edges of the float32 kernel's tiles (64 x 256 for nq <= 64, else
# 128 x 128; d in steps of 16): nq on both sides of one warp's 64 rows
# (63..65: the tile changes, the rows past nq are skipped per warp) and of
# one row tile (127..129), with nn % 4 != 0; d = 1, 3, 33, 65 (element
# loads) and 960 (60 steps), in both tiles
L2_FP32_EDGE_SHAPES = ([(nq, 4099, 64) for nq in (63, 64, 65, 127, 128, 129)]
                       + [(nq, 1030, d) for nq in (64, 65) for d in (1, 3, 33, 65, 960)])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", L2_SHAPES + [(1, 1, 1), (65, 129, 33), (3000, 70, 64)]
                         + L2_EDGE_SHAPES + L2_FP32_EDGE_SHAPES)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_pairwise_l2_kernel_matches_twin(cuda, shape, dtype):
    """B8 vs its twin on the card (TF32 off): the same tolerances as
    against the reference, fp32 rtol 1e-4 / atol 1e-4 * d, bf16 the same
    (both sum the exact products of the same bf16 values in float32, in
    other orders: the tensor cores' against the twin's widened matmul);
    one launch per call."""
    nq, nn, d = shape
    Q, X = _l2_inputs(nq + nn, nq, nn, d)
    q, x = _tl2(Q, dtype, cuda), _tl2(X, dtype, cuda)
    before = launches["pairwise_l2"]
    got = pairwise_l2(q, x)
    torch.cuda.synchronize()
    assert launches["pairwise_l2"] == before + 1
    torch.testing.assert_close(got, _pairwise_l2_twin(q, x), rtol=1e-4, atol=1e-4 * d)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(129, 4099, 64), (3000, 1000, 33), (65, 4096, 1),
                                   (300, 515, 56), (63, 4099, 64), (127, 1030, 3)])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_pairwise_l2_kernel_bit_equal_on_integers(cuda, shape, dtype):
    """Inputs in -4..4 with d <= 64: every product, partial sum and norm
    is an integer below 2^24, exact in float32 in any order, so the kernel
    equals its twin bit for bit; in bf16 a mix-up of the ldmatrix / mma
    fragment indices shows as a wrong value, not as a tolerance miss."""
    nq, nn, d = shape
    rng = np.random.default_rng(nq * 31 + nn + d)
    q, x = (torch.from_numpy(rng.integers(-4, 5, (m, d)).astype(np.float32))
            .to(cuda, TORCH_L2_DTYPE[dtype]) for m in (nq, nn))
    got = pairwise_l2(q, x)
    torch.cuda.synchronize()
    assert torch.equal(got, _pairwise_l2_twin(q, x))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1000, 4099, 64), (129, 300, 960)])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_pairwise_l2_kernel_deterministic(cuda, shape, dtype):
    """Two calls on the same inputs give bit-equal matrices."""
    nq, nn, d = shape
    Q, X = _l2_inputs(nq * 7 + nn, nq, nn, d)
    q, x = _tl2(Q, dtype, cuda), _tl2(X, dtype, cuda)
    first = pairwise_l2(q, x)
    assert torch.equal(pairwise_l2(q, x), first)


def _misaligned(t):
    """A contiguous copy of ``t`` whose base lies one element into its
    buffer: not 16-byte aligned."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["Q", "X", "both"])
@pytest.mark.parametrize("nq", [64, 129])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_pairwise_l2_kernel_misaligned_base(cuda, which, nq, dtype):
    """An operand whose base pointer is not 16-byte aligned takes the
    element loads: the same matrix as from aligned copies, bit for bit (the
    same values staged, summed in the same order), and within the twin's
    tolerance; in both float32 tiles."""
    nn, d = 1030, 64
    Q, X = _l2_inputs(nq * 3 + nn, nq, nn, d)
    q, x = _tl2(Q, dtype, cuda), _tl2(X, dtype, cuda)
    qm = _misaligned(q) if which in ("Q", "both") else q
    xm = _misaligned(x) if which in ("X", "both") else x
    assert (qm.data_ptr() % 16 != 0) or (xm.data_ptr() % 16 != 0)
    got = pairwise_l2(qm, xm)
    torch.cuda.synchronize()
    assert torch.equal(got, pairwise_l2(q, x))
    torch.testing.assert_close(got, _pairwise_l2_twin(q, x), rtol=1e-4, atol=1e-4 * d)


@pytest.mark.cuda
def test_pairwise_l2_kernel_grid_limits(cuda):
    """The grid's y extent counts X's 128-row tiles in both input types:
    one X row past the limit raises in float32 and in bf16, and a Q past
    the float32 kernel's former limit (65,535 tiles of 64 rows) is taken
    in both."""
    ymax = 65_535
    for dt in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="too large"):
            pairwise_l2(torch.zeros((3, 8), device=cuda, dtype=dt),
                        torch.zeros((ymax * 128 + 1, 8), device=cuda, dtype=dt))
    Q, X = _l2_inputs(5, ymax * 64 + 1, 3, 8)
    for dtype in ("fp32", "bf16"):
        q, x = _tl2(Q, dtype, cuda), _tl2(X, dtype, cuda)
        got = pairwise_l2(q, x)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, _pairwise_l2_twin(q, x), rtol=1e-4, atol=1e-4 * 8)


# ---------------------------------------------------------------- S1

def _select_case(seed, Q, L, nb, K, kind="random"):
    """Boxes and query projections for the block selection, from numpy:
    float32 values off any grid, with the half width set so that ~20
    blocks a (table, query) overlap.  ``grid``: values on a 1/16 grid, a
    third nudged by 2^-18, so that MINDIST ties exactly and nearly at the M
    cut; ``zeros``: every third block's box holds every query, so more
    than M blocks score 0; ``few``: a half width under which most
    (table, query) pairs see fewer than M overlapping blocks."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1, 1, (L, nb, K))
    e = rng.uniform(0, 0.3, (L, nb, K))
    g = rng.uniform(-1, 1, (Q, L, K))
    p = min(1.0, 20.0 / nb) ** (1.0 / K)  # a dimension's overlap probability
    half = max(2.0 * (1.0 - np.sqrt(1.0 - p)) - 0.15, 0.01)
    if kind == "grid":
        c, e, g = (np.round(x * 16) / 16 for x in (c, e, g))
        c += rng.integers(-1, 2, c.shape) * 2.0 ** -18
        half = float(np.round(half * 16) / 16)
    if kind == "few":
        half = 0.02
    lo, hi = (c - e).astype(np.float32), (c + e).astype(np.float32)
    if kind == "zeros":
        lo[:, ::3], hi[:, ::3] = -1e6, 1e6
    return lo, hi, g.astype(np.float32), float(np.float32(half))


def _select_on(case, device):
    lo, hi, g, half = case
    return (*(torch.from_numpy(x).to(device) for x in (lo, hi, g)), half)


SELECT_CASES = [  # (Q, L, nb, K, kind, M)
    (256, 5, 156_250, 10, "random", 5),  # sift10m.batch256
    (1024, 5, 15_625, 10, "random", 5),  # gist1m.batch1024
    (256, 5, 156_250, 10, "grid", 5),
    (1024, 5, 15_625, 10, "grid", 5),
    (64, 3, 5_000, 10, "zeros", 5),
    (64, 3, 5_000, 10, "few", 5),
    (1, 5, 20_000, 10, "grid", 5),
    (77, 2, 1_237, 10, "grid", 6),
    (130, 3, 999, 10, "random", 16),
    (5, 2, 40, 10, "random", 40),
    (3, 2, 5, 10, "zeros", 5),
    (50, 2, 3_001, 8, "grid", 5),
    (50, 2, 3_001, 16, "grid", 5),
    (50, 2, 3_001, 17, "grid", 5),
    (50, 2, 3_001, 32, "grid", 5),
    (9, 2, 2_001, 3, "grid", 8),
    (33, 2, 700, 100, "grid", 64),
    (40, 2, 3_001, 10, "grid", 100),  # M past a thread's list: the warp path at K < 32
    (6, 3, 700, 17, "zeros", 700),  # M = nb
    (9, 2, 2_001, 100, "zeros", 300),
    (5, 2, 40, 10, "random", 45),  # M > nb: the twin keeps nb slots
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SELECT_CASES, ids=lambda c: "-".join(map(str, c)))
def test_select_blocks_kernel_matches_twin(cuda, case):
    """S1 against its twin on the card, ``torch.equal`` on both outputs:
    the benchmark cells' shapes, near and exact MINDIST ties at the M cut,
    more than M blocks at MINDIST 0, fewer than M overlapping blocks (the
    nb / +inf slots), Q = 1, ragged tiles, the thread path's widths and the
    warp path below K = 128 (torch's summation order on both), and M past
    what a thread's list holds, up to nb and beyond it."""
    Q, L, nb, K, kind, M = case
    args = _select_on(_select_case(Q * 7 + nb + K, Q, L, nb, K, kind), cuda)
    before = launches["select_blocks"]
    blk, bhw = select_blocks(*args, M=M)
    torch.cuda.synchronize()
    assert launches["select_blocks"] == before + 1
    want_blk, want_bhw = twin.select_blocks_ref(*args, M=M)
    assert blk.shape == (L, Q, min(M, nb)) and blk.dtype == torch.int32
    assert torch.equal(blk, want_blk)
    assert torch.equal(bhw, want_bhw)
    if kind == "few":
        assert (blk == nb).any()
    if kind == "zeros" and nb > 3 * M:
        assert torch.equal(blk[..., :M], torch.arange(0, 3 * M, 3, dtype=torch.int32,
                                                     device=cuda).expand(L, Q, M))


@pytest.mark.cuda
def test_select_blocks_kernel_wide_k(cuda):
    """The LM datastores' width, K = 3,077: torch vectorises its sum there
    and S1 keeps its own fixed order, so block sets are equal except where
    the M-th and (M+1)-th MINDIST lie within float32 rounding, as
    test_torch_serve_search.py::test_select_blocks_matches_reference
    allows; halfwidths of equal sets are equal."""
    Q, L, nb, K, M = 4, 2, 2_048, 3_077, 5
    rng = np.random.default_rng(11)
    lo = (-1 + rng.uniform(0, 0.1, (L, nb, K))).astype(np.float32)
    hi = (1 - rng.uniform(0, 0.1, (L, nb, K))).astype(np.float32)
    far = rng.integers(0, K, (L, nb))
    for li in range(L):  # a third of the blocks fail in one dimension
        rows = np.arange(0, nb, 3)
        lo[li, rows, far[li, rows]] = hi[li, rows, far[li, rows]] = 5.0
    g = rng.uniform(-1.05, 1.05, (Q, L, K)).astype(np.float32)
    half = 0.2
    blk, bhw = select_blocks(*_select_on((lo, hi, g, half), cuda), M=M)
    want_blk, want_bhw = twin.select_blocks_ref(*_select_on((lo, hi, g, half), cuda), M=M)
    blk, bhw, want_blk, want_bhw = (x.cpu().numpy() for x in (blk, bhw, want_blk, want_bhw))
    kept = 0
    for li in range(L):
        g64 = g[:, li, None, :].astype(np.float64)
        pd = np.maximum(lo[li][None] - g64, 0) + np.maximum(g64 - hi[li][None], 0)
        ok = ((lo[li][None] <= g64 + half) & (hi[li][None] >= g64 - half)).all(-1)
        score = np.sort(np.where(ok, (pd ** 2).sum(-1), np.inf), axis=1)
        for qq in range(Q):
            a, b = score[qq, M - 1], score[qq, M]
            if a != b and np.isfinite(b) and b - a <= 1e-5 * max(1.0, b):
                continue
            kept += 1
            assert set(blk[li, qq].tolist()) == set(want_blk[li, qq].tolist()), (li, qq)
            np.testing.assert_array_equal(np.sort(bhw[li, qq]), np.sort(want_bhw[li, qq]))
    assert kept >= L * Q // 2


@pytest.mark.cuda
def test_select_blocks_wrapper_checks(cuda):
    """Each call counts one launch; a wrong dtype, a wrong shape, operands
    on two devices and an M below 1 raise."""
    lo, hi, g, half = _select_on(_select_case(3, 8, 2, 300, 10), cuda)
    before = launches["select_blocks"]
    for _ in range(3):
        select_blocks(lo, hi, g, half, M=5)
    assert launches["select_blocks"] == before + 3
    with pytest.raises(TypeError):
        select_blocks(lo, hi, g.double(), half, M=5)
    with pytest.raises(ValueError):
        select_blocks(lo, hi, g[:, :1].contiguous(), half, M=5)
    with pytest.raises(ValueError):
        select_blocks(lo, hi[:, :-1].contiguous(), g, half, M=5)
    with pytest.raises(ValueError, match="several devices"):
        select_blocks(lo, hi, g.cpu(), half, M=5)
    with pytest.raises(ValueError):
        select_blocks(lo, hi, g, half, M=0)
    assert launches["select_blocks"] == before + 3


@pytest.mark.cuda
def test_select_blocks_on_the_search_path(cuda, monkeypatch):
    """A search on the card selects through S1: one launch a one-pass call
    on every engine, one a step in the multi-pass oracle, and the twin
    never sees a CUDA tensor."""
    from repro_torch.core import DBLSHParams, build, search_batch_fixed, search_batch_fixed_ref
    from repro_torch.kernels import ops

    rng = np.random.default_rng(7)
    data = torch.from_numpy(rng.standard_normal((4096, 16)).astype(np.float32))
    params = DBLSHParams.derive(n=4096, d=16, k=5, K=6, L=3, inline_vectors=True)
    proj = torch.from_numpy(rng.standard_normal((params.L, params.K, 16)).astype(np.float32))
    index = build(data.to(cuda), params, proj_vecs=proj.to(cuda), device=cuda)
    Q = data[:7].to(cuda)
    monkeypatch.setattr(ops, "select_blocks_ref", lambda *a, **k: pytest.fail("twin on CUDA"))
    for engine in ("torch", "kernel", "inline"):
        before = launches["select_blocks"]
        search_batch_fixed(index, Q, k=5, r0=0.5, steps=4, engine=engine, device=cuda)
        assert launches["select_blocks"] == before + 1, engine
        before = launches["select_blocks"]
        search_batch_fixed_ref(index, Q, k=5, r0=0.5, steps=4, engine=engine, device=cuda)
        assert launches["select_blocks"] == before + 4, engine
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["torch", "inline"])
def test_select_blocks_search_past_a_threads_list(cuda, engine, monkeypatch):
    """An index whose max_blocks (100) is past what a thread's list holds
    searches on the card through S1 (its warp path) and answers as the same
    search with the twin selecting on the same tensors, bit for bit."""
    import repro_torch.kernels as kernels_mod
    from repro_torch.core import DBLSHParams, build, search_batch_fixed

    rng = np.random.default_rng(13)
    data = torch.from_numpy(rng.standard_normal((8192, 16)).astype(np.float32))
    params = DBLSHParams.derive(n=8192, d=16, k=5, K=6, L=3, max_blocks=100,
                                inline_vectors=True)
    proj = torch.from_numpy(rng.standard_normal((params.L, params.K, 16)).astype(np.float32))
    index = build(data.to(cuda), params, proj_vecs=proj.to(cuda), device=cuda)
    assert index.params.max_blocks == 100 < index.nb
    Q = data[:9].to(cuda)
    kw = dict(k=5, r0=0.5, steps=4, engine=engine, with_stats=True, device=cuda)
    before = launches["select_blocks"]
    got = search_batch_fixed(index, Q, **kw)
    assert launches["select_blocks"] == before + 1
    monkeypatch.setattr(kernels_mod, "select_blocks", twin.select_blocks_ref)
    want = search_batch_fixed(index, Q, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_select_blocks_cpu_is_the_twin():
    """On CPU tensors the wrapper returns the twin's outputs and counts no
    launch."""
    args = _select_on(_select_case(5, 9, 3, 400, 10, "grid"), "cpu")
    before = dict(launches)
    got = select_blocks(*args, M=5)
    want = twin.select_blocks_ref(*args, M=5)
    assert launches == before
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------- M1

MERGE_KINDS = ("ties", "dups", "allinf", "nonfinite", "mixed")
# at the kernel's level: (c1_thr, use_c2, early_exit); "c2" is what a
# search with termination=None runs
MERGE_TERMS = {"neither": (None, False, False), "c1": (60, False, False),
               "c2": (None, True, False), "both": (60, True, False),
               "early_exit": (60, True, True)}
MERGE_STATS = {"plain": (False, False), "stats": (True, False), "explain": (True, True)}


def _merge_case(seed, Q, S, k, kb, kind="mixed"):
    """Bins, block halfwidths, admitted counts and a schedule for the merge
    schedule, from numpy.  Bins are in no order; distances lie on a grid of
    quarters and ids in [0, 4(k + kb)), so equal distances at different ids
    are common (``ties``).  ``dups``: the same pair in every bin of a query
    and twice in each bin; ``allinf``: bin 0 and every third bin all +inf /
    ``n``, and one query all +inf; ``nonfinite``: NaN, -inf, -0, +0 and
    negative distances; ``mixed``: all of them.  The C2 bounds and C1's
    budget fire at steps spread over the schedule."""
    rng = np.random.default_rng(seed)
    n = 100_000
    d = (rng.integers(0, 32, (Q, S, kb)) / 4).astype(np.float32)
    i = rng.integers(0, 4 * (k + kb), (Q, S, kb)).astype(np.int32)
    if kind in ("dups", "mixed"):
        d[:, :, 0], i[:, :, 0] = d[:, :1, 0], i[:, :1, 0]
        d[:, :, -1], i[:, :, -1] = d[:, :, 0], i[:, :, 0]
    if kind in ("allinf", "mixed"):
        d[:, ::3], i[:, ::3] = np.inf, n
        d[-1], i[-1] = np.inf, n
        masked = rng.random((Q, S, kb)) < 0.2
        d[masked], i[masked] = np.inf, n
    if kind in ("nonfinite", "mixed"):
        u = rng.random((Q, S, kb))
        d[u < 0.04] = np.nan
        d[(u >= 0.04) & (u < 0.08)] = -np.inf
        d[(u >= 0.08) & (u < 0.14)] = -0.0
        d[(u >= 0.14) & (u < 0.2)] = 0.0
        d[(u >= 0.2) & (u < 0.23)] = -1.25
    bhw = rng.uniform(0, 4, (Q, 25)).astype(np.float32)
    bhw[rng.random((Q, 25)) < 0.2] = np.inf
    cum = np.cumsum(rng.integers(0, 30, (Q, S)), axis=1).astype(np.int64)
    # the half widths grow by 1.5 a step up to step 60, then stay (no overflow)
    halves = (np.float32(0.4) * np.float32(1.5) ** np.minimum(np.arange(S), 60)).astype(
        np.float32)
    c2 = np.linspace(0.5, 6.0, S).astype(np.float32)
    sched = np.stack([halves, c2, 2 * halves]).astype(np.float32)
    return d, i, bhw, cum, sched, n


def _merge_on(case, device, term="both", stats="explain", *, k, B=64):
    """(args, kwargs) of a merge_schedule call on ``device``."""
    d, i, bhw, cum, sched, n = case
    c1_thr, use_c2, early_exit = MERGE_TERMS[term]
    with_stats, with_explain = MERGE_STATS[stats]
    t = [torch.from_numpy(x).to(device) for x in (d, i, bhw, cum, sched)]
    args = (t[0], t[1], t[2] if with_stats else None, None if c1_thr is None else t[3], t[4])
    return args, dict(k=k, n=n, B=B, c1_thr=c1_thr, use_c2=use_c2, early_exit=early_exit,
                      with_stats=with_stats, with_explain=with_explain)


def _assert_merge_equal(got, want):
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (got[2] is None) == (want[2] is None)
    if want[2] is not None:
        assert got[2].keys() == want[2].keys()
        for key in want[2]:
            assert torch.equal(got[2][key], want[2][key]), key


def _merge_oracle(case, k, B, term):
    """The merge schedule written out per query on Python sets: at each
    step, the k smallest distinct (d2, id) pairs of the running list and
    the bin's finite entries, sorted; then the C2 and C1 marks."""
    d, i, bhw, cum, sched, n = case
    c1_thr, use_c2, _ = MERGE_TERMS[term]
    Q, S, _ = d.shape
    out_d, out_i, rs, cands = [], [], [], []
    for q in range(Q):
        best, steps_run, cand, prev = [], 0, 0, -np.inf
        for j in range(S):
            steps_run += 1
            cand += int(((bhw[q] <= sched[0, j]) & (bhw[q] > prev)).sum()) * B
            prev = sched[0, j]
            pairs = set(best) | {(float(a), int(b)) for a, b in zip(d[q, j], i[q, j])
                                 if np.isfinite(a)}
            best = sorted(pairs)[:k]
            kth = best[k - 1][0] if len(best) == k else np.inf
            if (use_c2 and kth <= sched[1, j]) or (c1_thr is not None
                                                   and cum[q, j] >= c1_thr):
                break
        best += [(np.inf, n)] * (k - len(best))
        out_d.append([a for a, _ in best])
        out_i.append([b for _, b in best])
        rs.append(steps_run)
        cands.append(cand)
    return (np.asarray(out_d, np.float32), np.asarray(out_i, np.int32),
            np.asarray(rs, np.int32), np.asarray(cands, np.int32))


@pytest.mark.parametrize("kind", MERGE_KINDS)
@pytest.mark.parametrize("term", ["neither", "c1", "c2", "both"])
@pytest.mark.parametrize("k,kb", [(1, 4), (5, 5), (10, 40)])
def test_merge_schedule_twin_matches_oracle(kind, term, k, kb):
    """The twin (the eager loop M1 replaced) against the schedule written
    out on Python sets: results, radius steps and candidates."""
    case = _merge_case(k * 31 + kb + len(kind), 9, 5, k, kb, kind)
    args, kw = _merge_on(case, "cpu", term, "stats", k=k)
    bd, bi, stats, span = twin.merge_schedule_ref(*args, **kw)
    want = _merge_oracle(case, k, 64, term)
    np.testing.assert_array_equal(bd.numpy(), want[0])
    np.testing.assert_array_equal(bi.numpy(), want[1])
    np.testing.assert_array_equal(stats["radius_steps"].numpy(), want[2])
    np.testing.assert_array_equal(stats["candidates"].numpy(), want[3])
    assert span == {"steps": 5, "syncs": 0}


def test_merge_schedule_cpu_is_the_twin():
    """On CPU tensors the wrapper returns the twin's outputs (and only
    the tensors: the twin's span args are the search's), under early exit
    with explain, and counts no launch."""
    case = _merge_case(3, 9, 5, 10, 10)
    args, kw = _merge_on(case, "cpu", "early_exit", "explain", k=10)
    before = dict(launches)
    got = merge_schedule(*args, **kw)
    want = twin.merge_schedule_ref(*args, **kw)
    assert launches == before
    assert len(got) == 3 and want[3]["syncs"] >= 1
    _assert_merge_equal(got, want)


def _merge_bad_calls(device):
    """(expected error, call) pairs the wrapper must refuse."""
    case = _merge_case(5, 4, 3, 5, 5)
    args, kw = _merge_on(case, device, "both", "stats", k=5)
    bd, bi, bhw, cum, sched = args
    return [
        (TypeError, lambda: merge_schedule(bd.double(), bi, bhw, cum, sched, **kw)),
        (TypeError, lambda: merge_schedule(bd, bi.long(), bhw, cum, sched, **kw)),
        (TypeError, lambda: merge_schedule(bd, bi, bhw, cum.int(), sched, **kw)),
        (ValueError, lambda: merge_schedule(bd, bi[:, :2].contiguous(), bhw, cum, sched, **kw)),
        (ValueError, lambda: merge_schedule(bd, bi, bhw, cum, sched[:, :2].contiguous(), **kw)),
        (ValueError, lambda: merge_schedule(bd.transpose(1, 2).contiguous().transpose(1, 2),
                                            bi, bhw, cum, sched, **kw)),
        (ValueError, lambda: merge_schedule(bd, bi, None, cum, sched, **kw)),
        (ValueError, lambda: merge_schedule(bd, bi, bhw, None, sched, **kw)),
        (ValueError, lambda: merge_schedule(bd, bi, bhw, cum, sched, **dict(kw, c1_thr=None))),
        (ValueError, lambda: merge_schedule(bd, bi, bhw, cum, sched, **dict(kw, k=0))),
        (ValueError, lambda: merge_schedule(bd[:, :0].contiguous(), bi[:, :0].contiguous(),
                                            bhw, cum[:, :0].contiguous(),
                                            sched[:, :0].contiguous(), **kw)),
        (ValueError, lambda: merge_schedule(bd[0], bi[0], bhw, cum, sched, **kw)),
    ]


@pytest.mark.parametrize("case", range(12))
def test_merge_schedule_wrapper_checks_cpu(case):
    """Wrong dtypes, shapes and layouts, stats or C1 inputs given without
    their flag (or the reverse), k or S below 1: refused before the twin
    runs, and no launch is counted."""
    err, call = _merge_bad_calls("cpu")[case]
    before = dict(launches)
    with pytest.raises(err):
        call()
    assert launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("Q", [1, 7, 256, 1024])
@pytest.mark.parametrize("k,kb", [(1, 1), (1, 4), (10, 10), (10, 40), (32, 32), (32, 128),
                                  (33, 33), (33, 132), (50, 50), (50, 200), (100, 100),
                                  (100, 400)])
def test_merge_schedule_kernel_matches_twin(cuda, Q, k, kb):
    """M1 against its twin on the card, ``torch.equal`` on every output:
    k and kb from 1 to 400, the cells' Q and tiny ones, on bins with ties,
    duplicates, all-inf bins and non-finite and signed-zero distances, C1
    and C2 both on, with explain."""
    case = _merge_case(Q * 7 + k + kb, Q, 8, k, kb, "mixed")
    args, kw = _merge_on(case, cuda, "both", "explain", k=k)
    before = launches["merge_schedule"]
    got = merge_schedule(*args, **kw)
    torch.cuda.synchronize()
    assert launches["merge_schedule"] == before + 1
    want = twin.merge_schedule_ref(*args, **kw)
    assert len(got) == 3
    _assert_merge_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("term", list(MERGE_TERMS))
@pytest.mark.parametrize("stats", list(MERGE_STATS))
@pytest.mark.parametrize("k,kb", [(10, 10), (10, 40), (50, 50)])
def test_merge_schedule_kernel_terminations(cuda, term, stats, k, kb):
    """Every termination (neither rule, C1, C2, both, early exit) with and
    without stats and explain, at three widths: equal to the twin."""
    case = _merge_case(k + kb + len(term) * 13 + len(stats), 256, 8, k, kb, "mixed")
    args, kw = _merge_on(case, cuda, term, stats, k=k)
    got = merge_schedule(*args, **kw)
    want = twin.merge_schedule_ref(*args, **kw)
    _assert_merge_equal(got, want)
    if MERGE_STATS[stats][1] and term != "neither":
        assert bool((got[2]["term_cause"] != 0).any())  # the rules do fire


@pytest.mark.cuda
@pytest.mark.parametrize("kind", MERGE_KINDS)
@pytest.mark.parametrize("k,kb", [(10, 10), (50, 200)])
def test_merge_schedule_kernel_bin_kinds(cuda, kind, k, kb):
    """Each hard kind of bin alone, at the cells' widths and a quantized
    shortlist's: equal to the twin."""
    case = _merge_case(len(kind) + k, 64, 8, k, kb, kind)
    args, kw = _merge_on(case, cuda, "c2", "explain", k=k)
    _assert_merge_equal(merge_schedule(*args, **kw), twin.merge_schedule_ref(*args, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("S,k,kb", [(40, 10, 32), (300, 8, 32), (300, 50, 50)])
def test_merge_schedule_kernel_long_schedules(cuda, S, k, kb):
    """Long schedules, Q = 130 (a ragged last block): equal to the
    twin."""
    case = _merge_case(S + k, 130, S, k, kb, "mixed")
    args, kw = _merge_on(case, cuda, "both", "explain", k=k)
    _assert_merge_equal(merge_schedule(*args, **kw), twin.merge_schedule_ref(*args, **kw))


@pytest.mark.cuda
def test_merge_schedule_wrapper_checks(cuda):
    """On the card: the CPU checks, operands on two devices, and no launch
    counted for a refused call."""
    before = launches["merge_schedule"]
    for err, call in _merge_bad_calls(cuda):
        with pytest.raises(err):
            call()
    args, kw = _merge_on(_merge_case(5, 4, 3, 5, 5), cuda, k=5)
    with pytest.raises(ValueError, match="several devices"):
        merge_schedule(*args[:4], args[4].cpu(), **kw)
    assert launches["merge_schedule"] == before


def _merge_search_index(device, quant_dtype="none"):
    from repro_torch.core import DBLSHParams, build

    rng = np.random.default_rng(17)
    data = torch.from_numpy(rng.standard_normal((4096, 16)).astype(np.float32))
    params = DBLSHParams.derive(n=4096, d=16, k=5, K=6, L=3, inline_vectors=True,
                                quant_dtype=quant_dtype)
    proj = torch.from_numpy(rng.standard_normal((params.L, params.K, 16)).astype(np.float32))
    return build(data.to(device), params, proj_vecs=proj.to(device), device=device), data


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["fp32", "bf16", "int8"])
@pytest.mark.parametrize("engine", ["inline", "kernel"])
def test_merge_schedule_on_the_search_path(cuda, engine, dtype, monkeypatch):
    """A fused search on the card merges through M1, one launch a call, and
    answers as the same search with the twin merging on the same bins, bit
    for bit, with every termination and explain; the 'torch' fp32 engine
    launches none; exact=True stays bit-equal to the multi-pass oracle."""
    import repro_torch.kernels as kernels_mod
    from repro_torch.core import Termination, search_batch_fixed, search_batch_fixed_ref

    index, data = _merge_search_index(cuda, "none" if dtype == "fp32" else dtype)
    Q = data[:33].to(cuda)
    terms = (None, Termination(), Termination(use_c2=False), Termination(use_c1=False),
             Termination(early_exit=False))
    got = []
    for term in terms:
        before = launches["merge_schedule"]
        got.append(search_batch_fixed(index, Q, k=5, r0=0.5, steps=6, engine=engine,
                                      dtype=dtype, termination=term, with_explain=True,
                                      device=cuda))
        assert launches["merge_schedule"] == before + 1
    monkeypatch.setattr(kernels_mod, "merge_schedule",
                        lambda *a, **kw: twin.merge_schedule_ref(*a, **kw)[:3])
    for term, g in zip(terms, got):
        want = search_batch_fixed(index, Q, k=5, r0=0.5, steps=6, engine=engine, dtype=dtype,
                                  termination=term, with_explain=True, device=cuda)
        assert torch.equal(g[0], want[0]) and torch.equal(g[1], want[1])
        for part in (2, 3):
            for key in want[part]:
                assert torch.equal(g[part][key], want[part][key]), key
    monkeypatch.undo()
    if dtype == "fp32":
        before = launches["merge_schedule"]
        search_batch_fixed(index, Q, k=5, r0=0.5, steps=6, engine="torch", device=cuda)
        assert launches["merge_schedule"] == before
        d, i = search_batch_fixed(index, Q, k=5, r0=0.5, steps=6, engine=engine, exact=True,
                                  device=cuda)
        rd, ri = search_batch_fixed_ref(index, Q, k=5, r0=0.5, steps=6, engine=engine,
                                        device=cuda)
        assert torch.equal(d, rd) and torch.equal(i, ri)
    torch.cuda.synchronize()
