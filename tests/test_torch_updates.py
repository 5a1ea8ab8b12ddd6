"""The port's index maintenance (``core.updates``) vs the reference's,
and the invariants of tests/test_updates.py on the port.

The fixture is tests/test_updates.py's (n = 2000, d = 24, K = 8, L = 3,
the gather layout); the reference index is carried across with
``from_arrays`` and both packages apply the same updates to it.  Where
the port projects new points itself (insert, compact), the two
frameworks round projections differently (ROADMAP queue C), so the
arrays are bit-equal on integer data and equal to that rounding on the
real fixture.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
R = pytest.importorskip("_torch_parity")

from repro_torch.core import (  # noqa: E402
    ENGINES,
    DBLSHParams,
    brute_force,
    build,
    compact,
    delete,
    from_arrays,
    grown_params,
    insert,
    live_count,
    live_ids_padded,
    search_batch_fixed,
)

CPU = "cpu"
SKW = dict(r0=0.5, steps=8, device=CPU)
FIELDS = R.INDEX_FIELDS + ("qvec_blocks", "qvec_scale")


def _port(ref):
    return from_arrays(R.index_arrays(ref), R.index_params(ref), device=CPU)


def _np(t: torch.Tensor) -> np.ndarray:
    """bf16 as its 16-bit pattern, everything else as is."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _ref_np(ref, f: str) -> np.ndarray:
    a = np.asarray(getattr(ref, f))
    return a.view(np.uint16) if str(a.dtype) == "bfloat16" else a


def _assert_index_equal(got, ref):
    for f in FIELDS:
        np.testing.assert_array_equal(_np(getattr(got, f)), _ref_np(ref, f), err_msg=f)
    assert got.params == DBLSHParams(**R.index_params(ref))


@pytest.fixture(scope="module")
def setup():
    data, extra, queries, ref = R.updates_fixture()
    return data, extra, queries, ref, _port(ref)


@pytest.fixture(scope="module")
def victims(setup):
    """tests/test_updates.py::test_delete_never_returned's victims: 50 of
    the queries' true 5-NN."""
    data, _, queries, _, _ = setup
    _, gt = brute_force(data, queries, k=5, device=CPU)
    return np.unique(gt.numpy().reshape(-1))[:50].astype(np.int32)


# ------------------------------------------------------ vs the reference

@pytest.mark.parametrize("n_total", [2001, 2048, 2100, 4000, 50_000])
@pytest.mark.parametrize("max_blocks", [0, 3, 500])
def test_grown_params_matches_reference(n_total, max_blocks):
    """Field for field, with max_blocks derived, capped, or set above the
    grown value."""
    ref = R.DBLSHParams.derive(n=2000, d=24, c=1.5, t=48, k=10, K=8, L=3,
                               max_blocks=max_blocks)
    got = grown_params(DBLSHParams(**dataclasses.asdict(ref)), n_total)
    assert dataclasses.asdict(got) == dataclasses.asdict(R.updates.grown_params(ref, n_total))


def test_delete_matches_reference(setup, victims):
    """delete does no arithmetic beyond min/max: every array equal, and
    live_count / live_ids_padded equal.  The sentinel n and ids outside
    [0, n) are no-ops."""
    _, _, _, ref, index = setup
    dels = np.concatenate([victims, [2000, 5000, -3]]).astype(np.int32)
    rdel = R.updates.delete(ref, dels)
    gdel = delete(index, dels)
    _assert_index_equal(gdel, rdel)
    assert live_count(gdel) == R.updates.live_count(rdel) == 2000 - victims.size
    np.testing.assert_array_equal(live_ids_padded(gdel).numpy(),
                                  np.asarray(R.updates.live_ids_padded(rdel)))


@pytest.mark.parametrize("quant", ["none", "int8", "bf16"])
@pytest.mark.parametrize("inline", [False, True])
def test_update_chain_exact_on_integer_data(inline, quant):
    """Integer data and hash functions make every projection exact in
    float32, so insert -> delete -> compact must give bit-equal arrays,
    the quantized blocks included (compact under the reference's new
    hash functions); id maps and params equal."""
    rng = np.random.default_rng(3)
    n, d, m = 700, 16, 150  # m not a multiple of B: padded slots
    data = rng.integers(-3, 4, (n, d)).astype(np.float32)
    data[400:420] = data[:20]  # duplicate rows: STR tie order
    extra = rng.integers(-3, 4, (m, d)).astype(np.float32)
    extra[:5] = data[:5]
    params = R.DBLSHParams.derive(n=n, d=d, c=1.5, t=20, k=10, K=6, L=3, block_size=32,
                                  inline_vectors=inline, quant_dtype=quant)
    pv = rng.integers(-2, 3, (params.L, params.K, d)).astype(np.float32)
    ref = R.build_from(data, params, pv)
    got = build(data, DBLSHParams(**dataclasses.asdict(params)), proj_vecs=pv, device=CPU)
    _assert_index_equal(got, ref)

    ref, got = R.updates.insert(ref, extra), insert(got, extra)
    _assert_index_equal(got, ref)
    dels = rng.choice(n + m, 120, replace=False).astype(np.int32)
    ref, got = R.updates.delete(ref, dels), delete(got, dels)
    _assert_index_equal(got, ref)

    rc, rmap = R.compact(ref, seed=9, integer_projections=True)
    gc, gmap = compact(got, proj_vecs=np.asarray(rc.proj_vecs))
    np.testing.assert_array_equal(gmap.numpy(), np.asarray(rmap))
    _assert_index_equal(gc, rc)


def _assert_close_to_projection_rounding(got, ref):
    """test_torch_core.py::test_build_matches_reference_fixture's check:
    each table holds the same points, <= 0.1 % of the slots differ, and
    where the slot ids agree the arrays agree to projection rounding."""
    gi, ri = got.ids_blocks.numpy(), np.asarray(ref.ids_blocks)
    for li in range(gi.shape[0]):
        np.testing.assert_array_equal(np.sort(gi[li], None), np.sort(ri[li], None))
    same = gi == ri
    assert same.mean() >= 0.999, same.mean()
    b = np.asarray(ref.proj_blocks)[same]
    a = got.proj_blocks.numpy()[same]
    assert (np.isinf(a) == np.isinf(b)).all()
    fin = np.isfinite(b)
    np.testing.assert_allclose(a[fin], b[fin], rtol=0, atol=2e-6 * np.abs(b[fin]).max())
    np.testing.assert_allclose(got.norm_blocks.numpy()[same],
                               np.asarray(ref.norm_blocks)[same], rtol=1e-6)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(ref.data))
    if ref.params.quant_dtype != "none":
        np.testing.assert_array_equal(_np(got.qvec_blocks)[same], _ref_np(ref, "qvec_blocks")[same])
        np.testing.assert_array_equal(got.qvec_scale.numpy()[same],
                                      np.asarray(ref.qvec_scale)[same])
    assert got.params == DBLSHParams(**R.index_params(ref))


@pytest.mark.parametrize("quant", ["none", "bf16", "int8"])
def test_insert_matches_reference_fixture(quant):
    """Real data: insert on both sides from the same index, equal to
    projection rounding; the quantized blocks of the appended region
    (per-slot quantization of the same rows) bit-equal where the slots
    agree."""
    data, extra, _, ref = R.updates_fixture(quant_dtype=quant)
    got = insert(_port(ref), extra)
    _assert_close_to_projection_rounding(got, R.updates.insert(ref, extra))


@pytest.mark.parametrize("engine", ["torch", "kernel"])
def test_searches_after_updates_match_reference(setup, victims, engine):
    """After insert and delete, each side updating its own copy: the
    port's updated index searches exactly as the reference's updated
    arrays carried across do (equal id sets and stats), and the
    reference's own search agrees on >= 0.99 of the ids with equal
    stats.  Not all: this fixture selects M = 4 of nb = 49 blocks, and
    at that cut the M-th and (M+1)-th MINDIST of a query can lie within
    the frameworks' query-projection rounding (ROADMAP queue C,
    test_torch_serve_search.py::test_select_blocks_matches_reference),
    which moves one query's tenth neighbour here."""
    _, extra, queries, ref, index = setup
    ref2 = R.updates.delete(R.updates.insert(ref, extra), victims)
    got2 = delete(insert(index, extra), victims)
    rd, ri, rs = R.search_batch_fixed(ref2, queries, k=10, r0=0.5, steps=8,
                                      engine={"torch": "jnp"}.get(engine, engine),
                                      interpret=True, with_stats=True)
    gd, gi, gs = search_batch_fixed(got2, queries, k=10, engine=engine, with_stats=True, **SKW)
    cd, ci, cs = search_batch_fixed(_port(ref2), queries, k=10, engine=engine,
                                    with_stats=True, **SKW)
    rd, ri = np.asarray(rd), np.asarray(ri)
    agree = []
    for q in range(ri.shape[0]):
        got = set(gi[q][torch.isfinite(gd[q])].tolist())
        assert got == set(ci[q][torch.isfinite(cd[q])].tolist()), q
        want = set(ri[q][np.isfinite(rd[q])].tolist())
        agree.append(len(got & want) / len(want))
    assert np.mean(agree) >= 0.99, agree
    for key in ("radius_steps", "candidates"):
        np.testing.assert_array_equal(gs[key].numpy(), np.asarray(rs[key]), err_msg=key)
        np.testing.assert_array_equal(gs[key].numpy(), cs[key].numpy(), err_msg=key)
    same = gi.numpy() == ri
    np.testing.assert_allclose(gd.numpy()[same], rd[same], rtol=1e-2, atol=1e-2)


# --------------------------------------- tests/test_updates.py on the port

def _recall(index, data, queries, k=10, **kw):
    _, ids = search_batch_fixed(index, queries, k=k, **SKW, **kw)
    _, gt = brute_force(data, queries, k=k, device=CPU)
    return np.mean([len(set(a.tolist()) & set(b.tolist())) / k
                    for a, b in zip(ids.numpy(), gt.numpy())])


def test_insert_points_found(setup):
    data, extra, queries, _, index = setup
    idx2 = insert(index, extra)
    assert idx2.n == 2000 + extra.shape[0]
    assert _recall(idx2, np.concatenate([data, extra]), queries) > 0.6
    # a query placed on an inserted point returns it (the self-distance
    # check needs exact=True: the norm form's cancellation floor is
    # O(eps * ||x||^2), far above 1e-3 at this scale)
    q = extra[7:8]
    d, i = search_batch_fixed(idx2, q, k=1, r0=0.25, steps=8, device=CPU)
    assert int(i[0, 0]) == 2000 + 7
    d, i = search_batch_fixed(idx2, q, k=1, r0=0.25, steps=8, exact=True, device=CPU)
    assert int(i[0, 0]) == 2000 + 7 and float(d[0, 0]) < 1e-3


def test_delete_never_returned(setup, victims):
    _, _, queries, _, index = setup
    idx2 = delete(index, victims)
    assert live_count(idx2) == 2000 - victims.size
    _, ids = search_batch_fixed(idx2, queries, k=10, **SKW)
    assert not set(victims.tolist()) & set(ids.numpy().reshape(-1).tolist())


def test_compact_after_delete(setup):
    data, _, queries, _, index = setup
    idx2 = delete(index, np.arange(500, dtype=np.int32))
    idx3, id_map = compact(idx2, generator=torch.Generator().manual_seed(5))
    assert idx3.n == 1500 and int((id_map >= 0).sum()) == 1500
    assert (id_map[:500] == -1).all()
    survivors = id_map[500:].long()
    np.testing.assert_array_equal(idx3.data.numpy()[survivors.numpy()], data[500:])
    _, ids = search_batch_fixed(idx3, queries, k=5, **SKW)
    assert int(ids.max()) <= 1500


@pytest.mark.parametrize("m", [1, 63, 64, 130])
def test_insert_partition_invariant(setup, m):
    """Every id 0..n+m-1 appears exactly once per table after insert."""
    _, extra, _, _, index = setup
    idx2 = insert(index, extra[:m])
    for li in range(idx2.params.L):
        ids = idx2.ids_blocks[li].reshape(-1)
        assert sorted(ids[ids < 2000 + m].tolist()) == list(range(2000 + m))


@pytest.fixture(scope="module")
def int8_setup(victims):
    """The fixture's data indexed with quant_dtype='int8', after an insert
    and a delete of the victims (and of two inserted points)."""
    data, extra, queries, ref = R.updates_fixture(quant_dtype="int8", inline_vectors=True)
    dels = np.concatenate([victims, [2003, 2010]]).astype(np.int32)
    return data, extra, queries, delete(insert(_port(ref), extra[:200]), dels), dels


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("dtype", ["fp32", "int8"])
def test_deleted_never_returned_quantized(int8_setup, engine, dtype):
    """Tombstones keep their quantized rows; the +inf projection keeps
    them out of every bin and the re-rank masks their ids, so no deleted
    id is returned, and the inserted points are found."""
    data, extra, queries, index, dels = int8_setup
    d, ids = search_batch_fixed(index, queries, k=10, engine=engine, dtype=dtype, **SKW)
    assert not set(dels.tolist()) & set(ids.numpy().reshape(-1).tolist())
    assert bool(torch.isfinite(d[:, 0]).all())
    d, i = search_batch_fixed(index, extra[7:8], k=1, r0=0.25, steps=8, engine=engine,
                              dtype=dtype, device=CPU)
    assert int(i[0, 0]) == 2000 + 7
