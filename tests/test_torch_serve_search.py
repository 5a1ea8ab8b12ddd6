"""The port's ``search_batch_fixed`` vs the reference's, engine for engine.

The fixture is tests/test_onepass_search.py's (n = 2048, d = 24,
max_blocks == nb, so selection never truncates); the reference index is
carried across with ``from_arrays``, so both sides search the same
arrays.  The reference's Pallas engines run in interpret mode.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
R = pytest.importorskip("_torch_parity")

from repro_torch.core import (  # noqa: E402
    ENGINES,
    from_arrays,
    search_batch_fixed,
    search_batch_fixed_ref,
)
from repro_torch.core.serve_search import _select_blocks  # noqa: E402

K_TEST = 8
REF_ENGINE = {"torch": "jnp", "kernel": "kernel", "inline": "inline"}


@pytest.fixture(scope="module")
def setup():
    data, queries, ref = R.onepass_fixture()
    assert ref.params.max_blocks == ref.nb
    index = from_arrays(R.index_arrays(ref), R.index_params(ref), device="cpu")
    return data, queries, ref, index


def _idsets(d, i):
    d, i = np.asarray(d), np.asarray(i)
    return [set(i[q][np.isfinite(d[q])].tolist()) for q in range(d.shape[0])]


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("steps", [1, 4, 8])
@pytest.mark.parametrize("engine", ENGINES)
def test_search_matches_reference(setup, engine, steps, exact):
    """Equal id sets and stats; distances within the norm-form tolerance
    of tests/test_onepass_search.py:91, or, with exact=True, within a few
    float32 ulps: the two frameworks sum the d squared differences in
    different orders, so distances near 8 may differ by 2 ulps (1.9e-6),
    and atol 5e-7 alone holds only below ~4 (ROADMAP queue C)."""
    _, queries, ref, index = setup
    rd, ri, rs = R.search_batch_fixed(
        ref, queries, k=K_TEST, r0=0.5, steps=steps, engine=REF_ENGINE[engine],
        interpret=True, with_stats=True, exact=exact)
    gd, gi, gs = search_batch_fixed(
        index, queries, k=K_TEST, r0=0.5, steps=steps, engine=engine,
        with_stats=True, exact=exact, device="cpu")
    assert gi.dtype == torch.int32 and gd.shape == (queries.shape[0], K_TEST)
    assert _idsets(gd, gi) == _idsets(rd, ri)
    if exact:
        np.testing.assert_allclose(gd.numpy(), np.asarray(rd), rtol=3e-7, atol=5e-7)
    else:
        np.testing.assert_allclose(gd.numpy(), np.asarray(rd), rtol=1e-2, atol=1e-2)
    for key in ("radius_steps", "candidates"):
        np.testing.assert_array_equal(gs[key].numpy(), np.asarray(rs[key]), err_msg=key)


@pytest.mark.parametrize("steps", [1, 4, 8])
def test_exact_bit_equal_across_engines(setup, steps):
    """Within the port on one device, exact=True gives bit-equal results
    through the pool path and both fused twins (the bins decomposition IS
    the flat per-step merge)."""
    _, queries, _, index = setup
    out = {e: search_batch_fixed(index, queries, k=K_TEST, r0=0.5, steps=steps,
                                 engine=e, exact=True, device="cpu")
           for e in ENGINES}
    for e in ("kernel", "inline"):
        assert torch.equal(out[e][0], out["torch"][0]), e
        assert torch.equal(out[e][1], out["torch"][1]), e


def test_gather_layout_matches_inline(setup):
    """The 'gather' layout (no vec_blocks: vectors fetched from data by
    id) gives the same results as the inline layout."""
    _, queries, ref, index = setup
    params = R.index_params(ref)
    params["inline_vectors"] = False
    arrays = R.index_arrays(ref)
    arrays["vec_blocks"] = np.zeros((0,), np.float32)
    gather = from_arrays(arrays, params, device="cpu")
    for engine in ("torch", "kernel"):
        a = search_batch_fixed(index, queries, k=K_TEST, r0=0.5, engine=engine,
                               exact=True, device="cpu")
        b = search_batch_fixed(gather, queries, k=K_TEST, r0=0.5, engine=engine,
                               exact=True, device="cpu")
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="inline_vectors"):
        search_batch_fixed(gather, queries, engine="inline", device="cpu")


@pytest.mark.parametrize("steps", [1, 4, 8])
def test_select_blocks_matches_reference(steps):
    """Selection at max_blocks < nb, where the M-of-nb cut and its tie
    order matter: equal block sets per (table, query) and equal
    halfwidths.  A row is skipped only when its M-th and (M+1)-th MINDIST
    differ but lie within float32 rounding of each other (the frameworks
    round the query projections differently); exact ties, such as the
    common MINDIST == 0, are kept: they pin the lowest-index tie order."""
    _, queries, ref = R.onepass_fixture(max_blocks=6)
    p = ref.params
    assert p.max_blocks < ref.nb
    index = from_arrays(R.index_arrays(ref), R.index_params(ref), device="cpu")
    w = float(np.float32(p.w0) * np.float32(0.5 * 1.5 ** (steps - 1)))
    rblk, rbhw, G = R.select_blocks(ref, queries, w)
    Gt = torch.einsum("lkd,qd->qlk", index.proj_vecs, torch.from_numpy(queries))
    gblk, gbhw = (x.numpy() for x in _select_blocks(index, Gt, w))

    lo, hi = np.asarray(ref.mbr_lo, np.float64), np.asarray(ref.mbr_hi, np.float64)
    M = p.max_blocks
    skipped = total = 0
    for li in range(p.L):
        g = G[:, li, None, :].astype(np.float64)
        pd = np.maximum(lo[li][None] - g, 0) + np.maximum(g - hi[li][None], 0)
        overlap = ((lo[li][None] <= g + w / 2) & (hi[li][None] >= g - w / 2)).all(-1)
        score = np.sort(np.where(overlap, (pd ** 2).sum(-1), np.inf), axis=1)
        for qq in range(queries.shape[0]):
            total += 1
            a, b = score[qq, M - 1], score[qq, M]
            if a != b and np.isfinite(b) and b - a <= 1e-5 * max(1.0, b):
                skipped += 1
                continue
            want, got = set(rblk[li, qq].tolist()), set(gblk[li, qq].tolist())
            assert got == want, (li, qq)
            np.testing.assert_allclose(np.sort(gbhw[li, qq]), np.sort(rbhw[li, qq]),
                                       rtol=1e-5, atol=1e-5)
    assert skipped < 0.02 * total, (skipped, total)


def test_select_blocks_zero_tie_order():
    """Every even block's MBR is made to contain every query projection,
    so more than M blocks score MINDIST 0: both sides must pick the M
    lowest block indices among them."""
    _, queries, ref = R.onepass_fixture(max_blocks=6)
    arrays, params = R.index_arrays(ref), R.index_params(ref)
    arrays["mbr_lo"][:, ::2] = -1e6
    arrays["mbr_hi"][:, ::2] = 1e6
    ref = R.ref_index_from_arrays(arrays, params)
    index = from_arrays(arrays, params, device="cpu")
    w = float(np.float32(ref.params.w0) * np.float32(0.5))
    rblk, _, _ = R.select_blocks(ref, queries, w)
    Gt = torch.einsum("lkd,qd->qlk", index.proj_vecs, torch.from_numpy(queries))
    gblk, _ = _select_blocks(index, Gt, w)
    np.testing.assert_array_equal(gblk.numpy(), rblk)
    # the selection is the M lowest indices among the MINDIST-0 blocks
    # (even blocks, plus any odd block whose own MBR contains g)
    assert (rblk[..., :-1] < rblk[..., 1:]).all()
    assert (rblk[..., -1] <= 10).all() and (rblk % 2 == 0).mean() > 0.9


def test_unported_options_raise(setup):
    """A quantized dtype needs an index built with that quant_dtype (this
    one has none); the multi-pass oracle takes only the port's engines,
    and 'inline' only on an index with inline vectors."""
    _, queries, ref, index = setup
    with pytest.raises(ValueError, match="quant_dtype"):
        search_batch_fixed(index, queries, device="cpu", dtype="int8")
    with pytest.raises(ValueError, match="engine"):
        search_batch_fixed(index, queries, engine="jnp", device="cpu")
    with pytest.raises(ValueError, match="engine"):
        search_batch_fixed_ref(index, queries, engine="jnp", device="cpu")
    params = R.index_params(ref)
    params["inline_vectors"] = False
    arrays = R.index_arrays(ref)
    arrays["vec_blocks"] = np.zeros((0,), np.float32)
    gather = from_arrays(arrays, params, device="cpu")
    with pytest.raises(ValueError, match="inline_vectors"):
        search_batch_fixed_ref(gather, queries, engine="inline", device="cpu")
