"""The port's ``store`` (``Collection`` and its lifecycle) held to
tests/test_store.py and to the reference's own collections.

* tests/test_store.py:105-239 — auto-compaction, hollowness, payload
  alignment, snapshot/restore before and after updates — and :294-363,
  the engine defaults, on the port's collections (the fixture's data, the
  port's own hash functions);
* the local half of :409, the quantized lifecycle, on the reference's
  int8 index carried across: searches against the reference's (id-set
  agreement >= 0.99 and stats equal, test_torch_quant.py's gates), and
  the snapshot round trip bit-identical;
* a snapshot written by the reference's ``Collection`` restores in the
  port: stats and lifecycle fields exactly equal, the calibration table
  and search policy field for field, searches to the reference's id sets
  and stats (squared distances within the norm form's norm-scaled atol);
* compaction against the reference's: on integer data under the same
  integer hash functions (drawn by the reference, handed to the port),
  id maps, re-derived params (an explicit K/L is not kept: the
  reference's behaviour), index arrays, payload and searches equal.

The service, router and sharded cases wait for the ports of
``store/service.py`` and ``store/router.py``.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
R = pytest.importorskip("_torch_parity")

import repro_torch.core.hashing as port_hashing  # noqa: E402
from repro_torch.core import brute_force, from_arrays, search_batch_fixed  # noqa: E402
from repro_torch.store import (  # noqa: E402
    Collection,
    CollectionStats,
    CompactionPolicy,
    restore_collection,
)
from repro_torch.tune import RecallTarget, policy_to_dict  # noqa: E402

CPU = "cpu"
DERIVE = dict(c=1.5, w0=3.6, t=32, k=10)
# the norm form's d² = ||q||² - 2q·x + ||x||² cancels: its float32 rounding
# scales with the norms (~1.2e5 on this fixture), not with d², so d² is held
# to rtol 1e-5 + atol 4e-6 x (max ||x||² + max ||q||²), chip_smoke.py's NORM_ATOL
NORM_ATOL = 4e-6


def _assert_norm_close(got_d, want_d, data, queries):
    g = np.square(np.asarray(got_d, np.float64))
    w = np.square(np.asarray(want_d, np.float64))
    scale = float(np.square(data).sum(1).max() + np.square(queries).sum(1).max())
    fin = np.isfinite(w)
    assert (np.isfinite(g) == fin).all()
    np.testing.assert_allclose(g[fin], w[fin], rtol=1e-5, atol=NORM_ATOL * scale)


@pytest.fixture(scope="module")
def setup():
    return R.store_fixture()


def _gen(seed: int = 17) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _recall(ids, gt_i, k):
    return np.mean(
        [len(set(a.tolist()) & set(b.tolist())) / k
         for a, b in zip(np.asarray(ids), np.asarray(gt_i))]
    )


def _idsets(d, i):
    d, i = np.asarray(d), np.asarray(i)
    return [set(i[q][np.isfinite(d[q])].tolist()) for q in range(d.shape[0])]


def _agreement(a_d, a_i, b_d, b_i):
    """Mean per-query id-set agreement |A & B| / |B| over finite entries."""
    return float(np.mean([len(a & b) / max(len(b), 1)
                          for a, b in zip(_idsets(a_d, a_i), _idsets(b_d, b_i))]))


# ---------------------------------------------------------------------------
# Auto-compaction policy
# ---------------------------------------------------------------------------


def test_auto_compaction_restores_recall(setup):
    """A stream of small adds growing the collection past 2x the built n
    must trigger compact, and recall@10 vs brute force on the grown
    dataset must be >= the never-compacted recall."""
    data, queries, _ = setup
    base, extra = data[:500], data[500:1200]
    k = 10

    def make(auto):
        return Collection.create(
            "g", _gen(), base, **DERIVE, device=CPU,
            policy=CompactionPolicy(growth_ratio=2.0, auto=auto),
        )

    frozen, managed = make(False), make(True)
    for j in range(0, 700, 35):  # 20 small appends -> sparse padded blocks
        frozen.add(extra[j:j + 35])
        managed.add(extra[j:j + 35])

    assert frozen.stats.compactions == 0
    assert managed.stats.compactions >= 1
    assert managed.n == frozen.n == 1200
    assert managed.built_n >= 1000  # policy fired at the 2x threshold
    # the rebuild re-derives K for the grown n (K ~ log n)
    assert managed.index.params.K >= frozen.index.params.K
    # and packs away the per-add padding waste
    assert managed.index.nb < frozen.index.nb

    _, gt_i = brute_force(data, queries, k=k, device=CPU)
    _, ids_pre = frozen.search(queries, k=k, r0=0.5, steps=8)
    _, ids_post = managed.search(queries, k=k, r0=0.5, steps=8)
    rec_pre, rec_post = _recall(ids_pre, gt_i, k), _recall(ids_post, gt_i, k)
    assert rec_post >= rec_pre, (rec_pre, rec_post)
    assert rec_post > 0.85, rec_post


def test_hollowness_triggers_compaction(setup):
    """Deleting past min_live_ratio triggers a rebuild that reclaims
    tombstoned slots and remaps payload ids."""
    data, _, _ = setup
    col = Collection.create(
        "h", _gen(), data[:600], **DERIVE, device=CPU,
        payload=np.arange(600),
        policy=CompactionPolicy(min_live_ratio=0.5),
    )
    id_map = col.remove(np.arange(0, 301))  # live 299/600 < 0.5
    assert col.stats.compactions == 1
    assert col.n == 299
    assert col.live_count() == 299
    assert isinstance(id_map, np.ndarray) and (id_map[:301] == -1).all()
    np.testing.assert_array_equal(id_map[301:], np.arange(299))
    # payload rows followed the compaction id map
    np.testing.assert_array_equal(col.payload.numpy(), np.arange(301, 600))


def test_payload_alignment_through_updates(setup):
    """add -> remove -> compact keeps payload aligned: querying exactly on
    a surviving point returns its original payload tag."""
    data, _, _ = setup
    base, extra = data[:500], data[500:600]
    col = Collection.create(
        "p", _gen(), base, **DERIVE, device=CPU,
        payload=np.arange(500), policy=CompactionPolicy(auto=False),
    )
    new_ids = col.add(extra, payload=np.arange(500, 600))
    np.testing.assert_array_equal(new_ids, np.arange(500, 600))
    col.remove(np.arange(0, 50))
    col.compact()
    assert col.stats.compactions == 1 and col.n == 550

    probe_tag = 570  # an inserted, surviving point
    d, ids = col.search(data[probe_tag:probe_tag + 1], k=1, r0=0.25, steps=8)
    assert float(d[0, 0]) < 1e-3
    tag = int(col.get_payload(ids)[0, 0])
    assert tag == probe_tag


def test_get_payload_clamps_both_ends(setup):
    """The unfilled-slot sentinel clamps to the last row, -1 (a deleted
    point in an id map) to row 0: never a wrap to the tail."""
    data, _, _ = setup
    col = Collection.create("gp", _gen(), data[:100], **DERIVE, device=CPU,
                            payload=np.arange(100) * 10)
    got = col.get_payload(np.array([[-1, 0, 99, 100, 5000]]))
    np.testing.assert_array_equal(got.numpy(), [[0, 0, 990, 990, 990]])
    with pytest.raises(ValueError, match="no payload"):
        Collection.from_index("np", col.index).get_payload([0])
    with pytest.raises(ValueError, match="payload must be provided"):
        col.add(data[100:101])
    with pytest.raises(ValueError, match="payload has 99 rows"):
        Collection.from_index("short", col.index, payload=np.arange(99))


# ---------------------------------------------------------------------------
# Persistence: snapshot / restore round-trip
# ---------------------------------------------------------------------------


def test_snapshot_restore_identical_results(setup, tmp_path):
    """save -> restore -> bit-identical search results, with payload,
    policy, counters, and the compaction key preserved."""
    data, queries, _ = setup
    col = Collection.create(
        "ck", _gen(), data, **DERIVE, device=CPU, payload=np.arange(1200),
        policy=CompactionPolicy(growth_ratio=3.0),
    )
    d0, i0 = col.search(queries, k=10, r0=0.5, steps=8)
    step = col.snapshot(str(tmp_path))

    col2 = Collection.restore(str(tmp_path), step, device=CPU)
    assert col2.name == "ck"
    assert col2.index.params == col.index.params
    assert col2.policy == col.policy
    assert col2.built_n == col.built_n
    assert col2.version > col.version
    d1, i1 = col2.search(queries, k=10, r0=0.5, steps=8)
    assert torch.equal(i1, i0) and torch.equal(d1, d0)
    assert torch.equal(col2.payload, col.payload)

    # restored collections keep evolving: the preserved key makes the next
    # compaction deterministic across the save/restore boundary
    col.remove(np.arange(100))
    col2.remove(np.arange(100))
    col.compact()
    col2.compact()
    assert torch.equal(col.index.proj_vecs, col2.index.proj_vecs)
    d2a, i2a = col.search(queries, k=10, r0=0.5, steps=8)
    d2b, i2b = col2.search(queries, k=10, r0=0.5, steps=8)
    assert torch.equal(i2a, i2b)


def test_snapshot_restore_after_updates(setup, tmp_path):
    """The round-trip also holds for a mutated (inserted + tombstoned)
    index — the exact dynamic state is what persists."""
    data, queries, _ = setup
    col = Collection.create(
        "ck2", _gen(), data[:800], **DERIVE, device=CPU,
        policy=CompactionPolicy(auto=False),
    )
    col.add(data[800:1000])
    col.remove(np.arange(40, 80))
    d0, i0 = col.search(queries, k=10, r0=0.5, steps=8)
    col.snapshot(str(tmp_path))
    col2 = restore_collection(str(tmp_path), device=CPU)
    assert col2.live_count() == col.live_count() == 960
    d1, i1 = col2.search(queries, k=10, r0=0.5, steps=8)
    assert torch.equal(i1, i0) and torch.equal(d1, d0)


def test_sharded_snapshot_is_refused(setup, tmp_path):
    """A snapshot whose manifest says ``sharded`` raises, naming the
    placement that is not ported, with or without ``mesh=``; it is never
    restored locally in its place."""
    data, _, _ = setup
    col = Collection.create("sh", _gen(), data[:200], **DERIVE, device=CPU)
    col.snapshot(str(tmp_path))
    mpath = tmp_path / "step_00000000" / "manifest.json"
    manifest = json.loads(mpath.read_text())
    manifest["meta"].update(placement="sharded", shards=4)
    mpath.write_text(json.dumps(manifest))
    for mesh in (None, object()):
        with pytest.raises(NotImplementedError, match="A15"):
            restore_collection(str(tmp_path), mesh=mesh, device=CPU)
    with pytest.raises(NotImplementedError, match="A15"):
        Collection.restore(str(tmp_path), device=CPU)


# ---------------------------------------------------------------------------
# Per-collection engine defaults
# ---------------------------------------------------------------------------


def test_collection_engine_default_resolution(setup, tmp_path):
    """The collection default engine: validated at create, used by
    search, and persisted through snapshot/restore; without one, search
    falls back to 'torch'."""
    data, queries, _ = setup
    col = Collection.create("eng", _gen(), data, **DERIVE, engine="inline",
                            inline_vectors=True, device=CPU)
    assert col.default_engine == "inline"
    col2 = Collection.create("plain", _gen(), data, **DERIVE, device=CPU)
    assert col2.default_engine is None
    got = col2.search(queries[:4], k=10, r0=0.5, steps=8)
    want = search_batch_fixed(col2.index, queries[:4], k=10, r0=0.5, steps=8,
                              engine="torch", device=CPU)
    assert all(torch.equal(a, b) for a, b in zip(got, want))

    with pytest.raises(ValueError):
        Collection.create("bad", _gen(), data, **DERIVE, engine="vulkan", device=CPU)
    with pytest.raises(ValueError):
        Collection.create("bad", _gen(), data, **DERIVE, engine="jnp", device=CPU)
    # an inline default needs the inline layout — fail at create, not at
    # the first dispatch
    with pytest.raises(ValueError):
        Collection.create("bad2", _gen(), data, **DERIVE, engine="inline", device=CPU)

    step = col.snapshot(str(tmp_path / "eng"))
    col3 = Collection.restore(str(tmp_path / "eng"), step, device=CPU)
    assert col3.default_engine == "inline"


@pytest.mark.parametrize("engine", ["kernel", "inline"])
def test_engine_default_results_match_explicit(setup, engine):
    """A collection-default engine must produce the same results as the
    same engine passed explicitly (resolution changes routing only)."""
    data, queries, _ = setup
    col = Collection.create("engeq", _gen(), data, **DERIVE, engine=engine,
                            inline_vectors=True, device=CPU)
    d_def, i_def = col.search(queries[:4], k=10, r0=0.5, steps=8)
    d_exp, i_exp = col.search(queries[:4], k=10, r0=0.5, steps=8, engine=engine)
    assert torch.equal(d_def, d_exp) and torch.equal(i_def, i_exp)
    assert col.stats.queries == 8


# ---------------------------------------------------------------------------
# Quantized distance path through the collection lifecycle
# ---------------------------------------------------------------------------


def test_quant_collection_lifecycle(setup, tmp_path):
    """The reference's int8 collection carried across: quantized searches
    against the reference's, through add / remove; then the port's
    compact keeps the quantized blocks slot-aligned and snapshot ->
    restore re-quantizes bit-identically.

    The reference's own gate at tests/test_store.py:424 (int8 recall vs
    fp32 >= 0.995) fails on this tree at 0.975 (ROADMAP queue C); the
    port returns the reference's int8 id sets, so its recall vs its own
    fp32 is recorded beside it, not made the port's target."""
    data, queries, kb = setup
    k, skw = 10, dict(k=10, r0=0.5, steps=8)
    RM = R.ref_modules()
    rcol = RM.store.Collection.create("q8", kb, data, **DERIVE, quant_dtype="int8")
    col = Collection.from_index("q8", from_arrays(R.index_arrays(rcol.index),
                                                  R.index_params(rcol.index), device=CPU))

    def both(dtype):
        r = [np.asarray(x) for x in rcol.search(queries, dtype=dtype, with_stats=True, **skw)[:2]]
        g = col.search(queries, dtype=dtype, with_stats=True, **skw)
        rs = rcol.search(queries, dtype=dtype, with_stats=True, **skw)[2]
        assert _agreement(g[0].numpy(), g[1].numpy(), *r) >= 0.99
        for key in ("radius_steps", "candidates"):
            np.testing.assert_array_equal(g[2][key].numpy(), np.asarray(rs[key]), err_msg=key)
        return g[0].numpy(), g[1].numpy(), r

    g_fp, i_fp, r_fp = both("fp32")
    g_q, i_q, r_q = both("int8")
    port_recall, ref_recall = _recall(i_q, i_fp, k), _recall(r_q[1], r_fp[1], k)
    print(f"int8 vs fp32 recall@{k}: port {port_recall:.4f}, reference {ref_recall:.4f}")
    assert abs(port_recall - ref_recall) <= 0.01

    with pytest.raises(ValueError, match="quant_dtype"):
        col.search(queries, k=k, dtype="bf16")

    # mutations keep the quantized blocks slot-aligned
    rng = np.random.default_rng(3)
    new = rng.normal(size=(48, data.shape[1])).astype(np.float32) * 0.1
    ids, rids = col.add(new), rcol.add(new)
    np.testing.assert_array_equal(ids, np.asarray(rids))
    col.remove(ids[:8])
    rcol.remove(np.asarray(rids)[:8])
    assert col.index.qvec_blocks.shape[:2] == col.index.ids_blocks.shape[:2]
    both("int8")
    both("fp32")

    # compaction rebuilds with the same quant_dtype
    col.compact()
    assert col.index.params.quant_dtype == "int8"
    assert col.index.qvec_blocks.shape[:2] == col.index.ids_blocks.shape[:2]

    # snapshot -> restore: re-quantization is bit-identical
    col.snapshot(str(tmp_path / "q8"))
    col2 = Collection.restore(str(tmp_path / "q8"), device=CPU)
    assert torch.equal(col2.index.qvec_blocks, col.index.qvec_blocks)
    assert torch.equal(col2.index.qvec_scale, col.index.qvec_scale)
    d3, i3 = col.search(queries, dtype="int8", **skw)
    d4, i4 = col2.search(queries, dtype="int8", **skw)
    assert torch.equal(i3, i4) and torch.equal(d3, d4)


# ---------------------------------------------------------------------------
# Across the packages
# ---------------------------------------------------------------------------


def test_reference_snapshot_restores_in_port(setup, tmp_path):
    """A snapshot the reference's ``Collection`` wrote (after updates, a
    calibration and a search policy) restores in the port: lifecycle
    fields and stats exactly, the table and policy field for field, the
    engine 'jnp' as 'torch', and searches to the reference's id sets and
    stats."""
    data, queries, kb = setup
    RM = R.ref_modules()
    skw = dict(k=10, r0=0.5, steps=8, with_stats=True)
    rcol = RM.store.Collection.create(
        "x", kb, data[:1000], **DERIVE, payload=np.arange(1000), engine="jnp",
        policy=RM.store.CompactionPolicy(growth_ratio=3.0, min_live_ratio=0.25))
    rcol.add(data[1000:1100], payload=np.arange(1000, 1100))
    rcol.remove(np.arange(40, 80))
    rcol.search_policy = RM.tune.RecallTarget(0.8, max_steps=9)
    rcol.calibrate(queries[:12], k=8, steps_max=5)
    rcol.search(queries, **skw)
    rcol.snapshot(str(tmp_path))
    snap_stats = rcol.stats.as_dict()
    want_d, want_i, want_s = rcol.search(queries, **skw)

    col = Collection.restore(str(tmp_path), device=CPU)
    assert col.name == "x" and col.default_engine == "torch"
    assert col.stats == CollectionStats(**snap_stats)
    assert col.built_n == rcol.built_n and col.version > rcol.version
    assert dataclasses.asdict(col.policy) == dataclasses.asdict(rcol.policy)
    assert col.index.params == type(col.index.params)(**R.index_params(rcol.index))
    assert col.calibration.to_dict().keys() == rcol.calibration.to_dict().keys()
    for f, v in rcol.calibration.to_dict().items():
        np.testing.assert_array_equal(np.asarray(getattr(col.calibration, f)), np.asarray(v),
                                      err_msg=f)
    assert policy_to_dict(col.search_policy) == RM.tune.policy_to_dict(rcol.search_policy)
    assert col.search_policy == RecallTarget(0.8, max_steps=9)
    np.testing.assert_array_equal(col.payload.numpy(), np.asarray(rcol.payload))
    np.testing.assert_array_equal(col._key, np.asarray(R.jax.random.key_data(rcol._key)))
    assert col.live_count() == rcol.live_count() == 1060

    gd, gi, gs = col.search(queries, **skw)
    assert _idsets(gd, gi) == _idsets(want_d, want_i)
    _assert_norm_close(gd.numpy(), want_d, data, queries)
    for key in ("radius_steps", "candidates"):
        np.testing.assert_array_equal(gs[key].numpy(), np.asarray(want_s[key]), err_msg=key)
    # the reference's calibration plans the same in the port
    assert col.plan() == col.plan(RecallTarget(0.8, max_steps=9))
    assert (col.plan().r0, col.plan().steps) == (rcol.plan().r0, rcol.plan().steps)


def test_reference_snapshot_without_norm_cache(setup, tmp_path):
    """A reference snapshot from before the norm cache (no
    ``norm_blocks`` leaf) is told by its leaf count: the port rebuilds
    the norms, equal to the reference's; a leaf count that fits no known
    layout raises instead of a guess."""
    data, queries, kb = setup
    RM = R.ref_modules()
    rcol = RM.store.Collection.create("old", kb, data[:400], **DERIVE)
    rcol.snapshot(str(tmp_path))
    mpath = tmp_path / "step_00000000" / "manifest.json"
    manifest = json.loads(mpath.read_text())
    leaves = manifest["leaves"]
    names = sorted([*R.INDEX_FIELDS, "prng_key"])
    manifest["leaves"] = [spec for name, spec in zip(names, leaves) if name != "norm_blocks"]
    mpath.write_text(json.dumps(manifest))
    col = Collection.restore(str(tmp_path), device=CPU)
    np.testing.assert_allclose(col.index.norm_blocks.numpy(),
                               np.asarray(rcol.index.norm_blocks), rtol=1e-6)
    manifest["leaves"] = manifest["leaves"][1:]
    mpath.write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="key paths for 7 leaves"):
        Collection.restore(str(tmp_path), device=CPU)


def test_calibrate_on_live_rows_matches_reference(setup):
    """After deletes the oracle runs on live rows only, as the
    reference's: with its r0 the port's table is the reference's."""
    data, queries, kb = setup
    RM = R.ref_modules()
    rcol = RM.store.Collection.create("cl", kb, data[:800], **DERIVE)
    rcol.remove(np.arange(0, 200))
    col = Collection.from_index("cl", from_arrays(R.index_arrays(rcol.index),
                                                  R.index_params(rcol.index), device=CPU))
    want = rcol.calibrate(queries[:16], k=8, steps_max=5)
    got = col.calibrate(queries[:16], k=8, r0=want.r0, steps_max=5)
    assert got.recall == want.recall and got.cost_slots == want.cost_slots


def test_compact_matches_reference_and_rederives_explicit_kl(monkeypatch):
    """Compaction against the reference's: integer data, the same integer
    hash functions on both sides (the reference draws them, the port is
    handed the same arrays), so every projection is exact in float32.
    The id maps, the re-derived params — an explicit K/L is not kept, K
    and L come from the paper's formulas at the live n, as in the
    reference (``src/repro/core/updates.py:192-196``) — the index arrays,
    the payload and the searches are equal."""
    rng = np.random.default_rng(5)
    n, d = 700, 16
    data = rng.integers(-3, 4, (n, d)).astype(np.float32)
    extra = rng.integers(-3, 4, (90, d)).astype(np.float32)
    queries = rng.integers(-3, 4, (24, d)).astype(np.float32)
    kw = dict(c=1.5, w0=3.6, t=16, k=10, K=6, L=3, block_size=32, inline_vectors=True)
    RM = R.ref_modules()
    with R.integer_projections(seed=8) as proj:
        rcol = RM.store.Collection.create(
            "cp", R.key(3), data, **kw, payload=np.arange(n),
            policy=RM.store.CompactionPolicy(auto=False))
        col = Collection.from_index(
            "cp", from_arrays(R.index_arrays(rcol.index), R.index_params(rcol.index),
                              device=CPU),
            payload=np.arange(n), policy=CompactionPolicy(auto=False))
        assert (col.index.params.K, col.index.params.L) == (6, 3)
        for c in (rcol, col):
            c.add(extra, payload=np.arange(n, n + 90))
            c.remove(np.arange(100, 400))
        rmap = rcol.compact()
    drawn = torch.from_numpy(proj.drawn[-1])
    monkeypatch.setattr(port_hashing, "sample_projections",
                        lambda generator, d, K, L, device=None: drawn.clone())
    gmap = col.compact()
    np.testing.assert_array_equal(gmap, np.asarray(rmap))
    rp = R.index_params(rcol.index)
    assert dataclasses.asdict(col.index.params) == rp
    assert (rp["K"], rp["L"]) != (6, 3)  # re-derived, not the explicit K/L
    for f in R.INDEX_FIELDS:
        np.testing.assert_array_equal(getattr(col.index, f).numpy(),
                                      np.asarray(getattr(rcol.index, f)), err_msg=f)
    np.testing.assert_array_equal(col.payload.numpy(), np.asarray(rcol.payload))
    skw = dict(k=10, r0=1.0, steps=6, exact=True, with_stats=True)
    gd, gi, gs = col.search(queries, **skw)
    rd, ri, rs = rcol.search(queries, **skw)
    assert _idsets(gd, gi) == _idsets(rd, ri)
    np.testing.assert_array_equal(gd.numpy(), np.asarray(rd))
    for key in ("radius_steps", "candidates"):
        np.testing.assert_array_equal(gs[key].numpy(), np.asarray(rs[key]), err_msg=key)
