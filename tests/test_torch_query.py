"""The paper's query path (``repro_torch.core.query``: Algorithm 2's
``search``/``search_batch``, the (r,c)-NN probe ``rc_nn``,
``probe_radius`` and the lexsort ``_dedup_merge``) vs the reference, on
tests/test_core.py's fixture (n = 4000, d = 32, K = 10, L = 4, the gather
layout) carried across with ``from_arrays``.

Ids are compared position for position, unfilled slots included (the
reference leaves the id its sort put there, not ``n``).  Distances are
diff-form square roots: the frameworks sum the d squared differences in
different orders and project the queries with different rounding, so
they agree to a few float32 ulps (rtol 1e-6, atol 1e-6).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
R = pytest.importorskip("_torch_parity")

from _hypothesis_compat import given, settings, st  # noqa: E402
from repro_torch.core import (  # noqa: E402
    brute_force,
    from_arrays,
    probe_radius,
    rc_nn,
    search,
    search_batch,
)
from repro_torch.core.query import _dedup_merge  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def setup():
    data, queries, ref = R.core_fixture()
    index = from_arrays(R.index_arrays(ref), R.index_params(ref), device="cpu")
    return data, queries, ref, index


def _assert_same(got, want):
    gd, gi = (x.numpy() for x in got)
    wd, wi = map(np.asarray, want)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(np.isfinite(gd), np.isfinite(wd))
    np.testing.assert_allclose(gd, wd, **TOL)


@pytest.mark.parametrize("k", [1, 10])
def test_search_batch_matches_reference(setup, k):
    _, queries, ref, index = setup
    got = search_batch(index, queries, k=k, r0=0.5)
    assert got[1].dtype == torch.int32 and got[0].shape == (queries.shape[0], k)
    _assert_same(got, R.search_batch(ref, queries, k=k, r0=0.5))


def test_search_is_search_batch_per_query(setup):
    """A query searched alone gets its row of the batch: done queries are
    frozen, so the batch's lockstep changes nothing."""
    _, queries, _, index = setup
    bd, bi = search_batch(index, queries[:6], k=5, r0=0.5)
    for qi in range(6):
        d, i = search(index, queries[qi], k=5, r0=0.5)
        assert torch.equal(d, bd[qi]) and torch.equal(i, bi[qi])


@pytest.mark.parametrize("r", [0.3, 0.6, 1.0])
def test_rc_nn_matches_reference(setup, r):
    _, queries, ref, index = setup
    for qi in range(6):
        _assert_same(rc_nn(index, queries[qi], r, k=3), R.rc_nn(ref, queries[qi], r, k=3))


def test_probe_radius_matches_reference(setup):
    """One window probe at several widths: equal ids slot for slot, equal
    window membership, d2 to ulps."""
    _, queries, ref, index = setup
    w0 = np.float32(index.params.w0)
    for qi in range(4):
        q = queries[qi]
        g_ref = R.project_one(ref, q)
        for r in (0.4, 0.8):
            w = w0 * np.float32(r)
            gd, gi = probe_radius(index, q, g_ref, w)
            rd, ri = map(np.asarray, R.probe_radius(ref, q, g_ref, w))
            np.testing.assert_array_equal(gi.numpy(), ri)
            np.testing.assert_array_equal(np.isfinite(gd.numpy()), np.isfinite(rd))
            np.testing.assert_allclose(gd.numpy(), rd, rtol=1e-6)


@given(seed=st.integers(0, 2**31 - 1))
@settings(deadline=None, max_examples=6)
def test_dedup_merge_matches_reference(seed):
    """The paper path's merge, tie order and unfilled ids included:
    duplicate ids at several distances, equal distances across ids,
    ids >= n, all-inf rows."""
    rng = np.random.default_rng(seed)
    n, Qn, k = 30, 3, int(rng.integers(1, 8))
    best_d = np.sort(rng.choice([0.5, 1.0, np.inf], (Qn, k)), axis=1).astype(np.float32)
    best_i = np.where(np.isfinite(best_d), rng.integers(0, n, (Qn, k)), n).astype(np.int32)
    m = int(rng.integers(1, 24))
    new_d = rng.choice([0.25, 0.5, 1.0, 2.0, np.inf], (Qn, m)).astype(np.float32)
    new_i = rng.integers(0, n + 2, (Qn, m)).astype(np.int32)
    new_d[seed % Qn] = np.inf
    got = _dedup_merge(*(torch.from_numpy(x) for x in (best_d, best_i, new_d, new_i)), n, k)
    want = R.dedup_merge(best_d, best_i, new_d, new_i, n, k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_search_finds_exact_nn_mostly(setup):
    """tests/test_core.py's recall floor and distance checks, on the port."""
    data, queries, _, index = setup
    k = 10
    dists, ids = search_batch(index, queries, k=k, r0=0.5)
    _, gt = brute_force(data, queries, k=k, device="cpu")
    recall = np.mean([len(set(a.tolist()) & set(b.tolist())) / k for a, b in zip(ids, gt)])
    assert recall > 0.5, recall
    got = dists.numpy()
    for qi in range(queries.shape[0]):
        valid = ids[qi].numpy() < data.shape[0]
        real = np.linalg.norm(data[ids[qi].numpy()[valid]] - queries[qi], axis=-1)
        np.testing.assert_allclose(got[qi][valid], real, rtol=1e-3, atol=1e-3)
    assert np.all(np.diff(got, axis=-1) >= -1e-6)


def test_c2ann_guarantee(setup):
    """tests/test_core.py: >= 80 % of returned 1-NNs are c²-approximate."""
    data, queries, _, index = setup
    dists, _ = search_batch(index, queries, k=1, r0=0.5)
    gt_d, _ = brute_force(data, queries, k=1, device="cpu")
    ratio = dists[:, 0].numpy() / np.maximum(gt_d[:, 0].numpy(), 1e-9)
    assert np.mean(ratio <= index.params.c ** 2 + 1e-3) >= 0.8
