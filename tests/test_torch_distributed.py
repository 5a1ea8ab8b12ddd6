"""The port's ``core.distributed`` and the sharded snapshot held against the
reference's own four-device fleet.

A module-scoped fixture runs the reference once, in a subprocess with four
forced host devices (``_torch_parity.sharded_reference``), on integer data
under small-integer hash functions (every projection exact in float32 in
both frameworks): ``build_sharded``; ``search_sharded`` plain, with stats,
with explain, ``exact=True``, under ``Termination()`` and C1 alone, and
with unfilled slots; a fleet whose shards hold the same points (every
distance tied across shards); ``insert_sharded`` / ``delete_sharded``;
``compact_sharded``; and the snapshots of a ``ShardedCollection`` after
updates, in fp32 and int8.  The port builds its fleet from the drawn hash
functions on a CPU mesh of four and must match: per-shard arrays, ids,
stats (``shard_*`` included) and id maps exactly; distances within the
norm form's rtol = atol = 1e-2 and the exact form's 1e-6; the reference's
snapshots, restored by the port onto a CPU mesh of four, search equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
R = pytest.importorskip("_torch_parity")

from repro_torch.core import DBLSHParams, Termination, build  # noqa: E402
from repro_torch.core.distributed import (  # noqa: E402
    ShardedDBLSH,
    build_sharded,
    compact_sharded,
    delete_sharded,
    id_stride,
    insert_sharded,
    make_mesh,
    search_sharded,
    shard_arrays,
    shard_live_counts,
)
from repro_torch.store import ShardedCollection, restore_collection  # noqa: E402

P = R.SHARDS
MESH = make_mesh(P, devices=["cpu"] * P)
N_LOCAL = 1024
STRIDE = id_stride(N_LOCAL, 1.25)
FIELDS = R.INDEX_FIELDS
# the reference's search settings, by the name its outputs are saved under
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
FLOAT_KEYS = ("final_radius", "step_half")


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_reference")
    arrays, meta = R.sharded_reference(out)
    return out, arrays, meta


@pytest.fixture(scope="module")
def fleet(ref):
    _, a, _ = ref
    params = DBLSHParams.derive(n=N_LOCAL, d=16, **R.SHARDED_KW)
    return build_sharded(None, a["data"], params, MESH, stride=STRIDE,
                         proj_vecs=a["build/proj"])


def _assert_arrays(s: ShardedDBLSH, a: dict, tag: str, meta: dict):
    """The fleet's global layout and each shard equal to the reference's."""
    m = meta[tag]
    assert (s.n_total, s.n_local, s.stride) == (m["n_total"], m["n_local"], m["stride"])
    assert dataclasses.asdict(s.params) == m["params"]
    got = s.global_arrays()
    want = {f: a[f"{tag}/{f}"] for f in FIELDS}
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"{tag}/{f}")
    for r, part in enumerate(shard_arrays(want, P, s.params)):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(s.shards[r], f).numpy(), part[f],
                                          err_msg=f"{tag}/shard {r}/{f}")


def _assert_search(out, a: dict, prefix: str, exact: bool):
    """ids and every stats/explain array exactly; distances to the form's
    tolerance (and +inf exactly where the reference has it)."""
    d, i = out[0].numpy(), out[1].numpy()
    np.testing.assert_array_equal(i, a[f"{prefix}/i"], err_msg=prefix)
    want_d = a[f"{prefix}/d"]
    np.testing.assert_array_equal(np.isfinite(d), np.isfinite(want_d))
    fin = np.isfinite(want_d)
    tol = dict(rtol=1e-6, atol=1e-6) if exact else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(d[fin], want_d[fin], **tol)
    for extra in out[2:]:
        for key, v in extra.items():
            want = a[f"{prefix}/{key}"]
            assert v.shape == want.shape, (prefix, key)
            if key in FLOAT_KEYS:
                np.testing.assert_allclose(v.numpy(), want, rtol=1e-6, err_msg=key)
            else:
                np.testing.assert_array_equal(v.numpy(), want, err_msg=f"{prefix}/{key}")


def test_build_sharded_matches_reference(ref, fleet):
    """Every shard built from its slice under the shared hash functions:
    the reference's global layout and per-shard arrays exactly, and each
    shard equal to a local ``build`` of its slice."""
    _, a, meta = ref
    _assert_arrays(fleet, a, "build", meta)
    for r in (0, P - 1):
        part = torch.from_numpy(a["data"][r * N_LOCAL:(r + 1) * N_LOCAL])
        local = build(part, fleet.params, proj_vecs=torch.from_numpy(a["build/proj"]),
                      device="cpu")
        for f in FIELDS:
            assert torch.equal(getattr(local, f), getattr(fleet.shards[r], f)), (r, f)


@pytest.mark.parametrize("name", list(SEARCHES))
def test_search_sharded_matches_reference(ref, fleet, name):
    _, a, _ = ref
    kw = SEARCHES[name]
    out = search_sharded(fleet, torch.from_numpy(a["queries"]), k=10, mesh=MESH, **kw)
    _assert_search(out, a, f"build/{name}", kw.get("exact", False))
    ids, d = out[1], out[0]
    # the merge sentinel is the id space, not n
    assert bool((ids[~torch.isfinite(d)] == fleet.id_space).all())
    if name == "unfilled":
        assert not bool(torch.isfinite(d).all())


def test_critical_path_takes_the_lowest_rank_on_ties(ref, fleet):
    """With no termination every shard runs the whole schedule, so
    ``shard_steps`` tie everywhere and the critical path is rank 0 (the
    first maximum, as ``jnp.argmax``); under termination the deepest
    shard's cause is taken, as in the reference."""
    _, a, _ = ref
    Q = torch.from_numpy(a["queries"])
    ex = search_sharded(fleet, Q, k=10, mesh=MESH, **SEARCHES["explain"])[3]
    assert bool((ex["shard_steps"] == ex["shard_steps"][0]).all())
    assert torch.equal(ex["term_cause"], ex["shard_cause"][0])
    ex = search_sharded(fleet, Q, k=10, mesh=MESH, **SEARCHES["term"])[3]
    steps = ex["shard_steps"]
    assert bool((steps != steps[0]).any()), "no query's shards differ in depth"
    deepest = steps.argmax(0)
    for q in range(steps.shape[1]):
        top = int(steps[:, q].max())
        assert int(deepest[q]) == int(torch.nonzero(steps[:, q] == top)[0, 0])
        assert int(ex["term_cause"][q]) == int(ex["shard_cause"][deepest[q], q])


def test_merge_ties_break_to_the_lowest_shard(ref):
    """Every shard holds the same points, so each distance appears once a
    shard: the merged ids equal the reference's, and within a run of equal
    distances the ranks ascend (``lax.top_k``'s lowest position first)."""
    _, a, meta = ref
    params = DBLSHParams.derive(n=256, d=16, **R.SHARDED_KW)
    tied = build_sharded(None, a["tied"], params, MESH, proj_vecs=a["tied/proj"])
    _assert_arrays(tied, a, "tied", meta)
    for name in ("stats", "exact"):
        kw = SEARCHES[name]
        out = search_sharded(tied, torch.from_numpy(a["queries"]), k=10, mesh=MESH, **kw)
        _assert_search(out, a, f"tied/{name}", kw.get("exact", False))
        d, rank = out[0], torch.div(out[1], tied.stride, rounding_mode="floor")
        same = (d[:, 1:] == d[:, :-1]) & torch.isfinite(d[:, 1:])
        assert bool(same.any())
        assert bool((rank[:, 1:][same] >= rank[:, :-1][same]).all())


def test_insert_and_delete_match_reference(ref, fleet):
    """The batch appended to every shard and tombstoned on all but the
    target; deletes by global id (live ids on every shard, inserted ids,
    a headroom id and the sentinel) translated per shard."""
    _, a, meta = ref
    grown = insert_sharded(fleet, a["extra"], 2, mesh=MESH)
    _assert_arrays(grown, a, "insert", meta)
    assert grown.n_total == P * grown.n_local
    s3 = delete_sharded(grown, a["delete/gids"], mesh=MESH)
    _assert_arrays(s3, a, "delete", meta)
    np.testing.assert_array_equal(shard_live_counts(s3, MESH).numpy(), a["delete/counts"])
    for name in ("stats", "exact", "explain"):
        kw = SEARCHES[name]
        out = search_sharded(s3, torch.from_numpy(a["queries"]), k=10, mesh=MESH, **kw)
        _assert_search(out, a, f"delete/{name}", kw.get("exact", False))
    with pytest.raises(ValueError, match="stride exhausted"):
        insert_sharded(fleet, np.zeros((STRIDE - N_LOCAL + 1, 16), np.float32), 0, mesh=MESH)


def test_compact_sharded_matches_reference(ref, fleet):
    """The balanced rebuild under the reference's new hash functions: the
    id map (ascending new ids, -1 for deleted ids and headroom holes), the
    re-derived params, every shard's arrays and the searches."""
    _, a, meta = ref
    s3 = delete_sharded(insert_sharded(fleet, a["extra"], 2, mesh=MESH), a["delete/gids"],
                        mesh=MESH)
    s4, id_map = compact_sharded(s3, None, MESH, headroom=1.25, proj_vecs=a["compact/proj"])
    np.testing.assert_array_equal(id_map.numpy(), a["compact/id_map"])
    live = id_map[id_map >= 0]
    assert bool((live[1:] > live[:-1]).all())
    _assert_arrays(s4, a, "compact", meta)
    counts = shard_live_counts(s4, MESH)
    assert int(counts.max() - counts.min()) <= 1
    for name in ("stats", "exact"):
        kw = SEARCHES[name]
        out = search_sharded(s4, torch.from_numpy(a["queries"]), k=10, mesh=MESH, **kw)
        _assert_search(out, a, f"compact/{name}", kw.get("exact", False))


@pytest.mark.parametrize("tag", ["col", "col8"])
def test_reference_snapshot_restores_in_port(ref, tag):
    """The reference's ``ShardedCollection`` snapshot (after an add and a
    remove) placed on a CPU mesh of four: the geometry, lifecycle state,
    strided payload and key as written, the quantized blocks re-derived
    per shard equal to those the reference's own restore derives, and
    searches equal."""
    out, a, meta = ref
    col = restore_collection(str(out / tag), mesh=MESH)
    m = meta[tag]
    assert isinstance(col, ShardedCollection) and col.name == tag
    assert col.fixed_engine == "torch" and col.device == torch.device("cpu")
    assert (col.n, col.sharded.stride, col.built_n) == (m["n_total"], m["stride"], m["built_n"])
    assert col.stats.as_dict() == m["stats"] and col.live_count() == m["live"]
    np.testing.assert_array_equal(col._key, np.asarray(m["key"], np.uint32))
    np.testing.assert_array_equal(col.payload.numpy(), a[f"{tag}/payload"])
    if tag == "col8":
        for f in ("qvec_blocks", "qvec_scale"):
            got = torch.cat([getattr(sh, f) for sh in col.sharded.shards], dim=1)
            want = a[f"{tag}/{f}"]
            np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32),
                                          err_msg=f)
    for dt in ("fp32",) + (("int8",) if tag == "col8" else ()):
        got = col.search(a["queries"], k=10, r0=1.0, steps=6, with_stats=True, dtype=dt)
        _assert_search(got, a, f"{tag}/{dt}", False)


def test_reference_snapshot_restores_elastically(ref, tmp_path):
    """Four shards onto two and back onto four: balanced counts, and every
    live point found at distance 0 by an exact search of itself, its
    payload tag carried to its new id."""
    out, _, meta = ref
    four = restore_collection(str(out / "col"), mesh=MESH)
    _, gids = four._live_rows_and_ids()
    s = four.sharded
    pts = torch.stack([s.shards[g // s.stride].data[g % s.stride] for g in gids.tolist()])
    tags = four.payload[torch.from_numpy(gids)]
    mesh2 = make_mesh(2, devices=["cpu"] * 2)
    two = restore_collection(str(out / "col"), mesh=mesh2)
    two.snapshot(str(tmp_path / "two"))
    back = restore_collection(str(tmp_path / "two"), mesh=MESH)
    for col in (two, back):
        counts = col.shard_counts()
        assert counts.sum() == meta["col"]["live"] and counts.max() - counts.min() <= 1
        assert col.calibration is None and col.n == col.sharded.n_local * len(counts)
        d, i = col.search(pts, k=1, r0=0.25, steps=8, exact=True)
        assert bool((d[:, 0] == 0).all())
        assert torch.equal(col.get_payload(i[:, 0]), tags)
