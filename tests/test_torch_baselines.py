"""The paper's baselines (``core.baselines``: FBLSH, MQIndex, C2Index)
against the reference on the same arrays, and tests/test_core.py's
recall bars on the port's own draws.

The reference builds each baseline on tests/test_core.py's fixture (n =
4000, d = 32) with that file's settings; the port takes the drawn arrays
through ``from_arrays`` and searches the same queries.  Ids must be equal
wherever the distances are distinct (the two frameworks sum the
distances in different orders, so equal distances may come out in either
order), distances within rtol 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
R = pytest.importorskip("_torch_parity")

from repro_torch.core import C2Index, DBLSHParams, FBLSH, MQIndex, brute_force  # noqa: E402
from repro_torch.core import baselines  # noqa: E402

K_NN = 10
RTOL = 1e-5
CLASSES = {"FBLSH": FBLSH, "MQIndex": MQIndex, "C2Index": C2Index}


def _specs(w0):
    """tests/test_core.py::test_baselines_reasonable_recall's builds, plus
    an FBLSH at a small cap and r0 (most queries stop on C1, at several
    steps) and a C2Index whose cap cuts the hits."""
    return {
        "MQIndex": (1, dict(m=15, beta=0.08), {}),
        "C2Index": (2, dict(m=40, w=2.0), {}),
        "FBLSH": (3, dict(K=8, L=4, w0=w0, c=1.5, t=32), dict(r0=0.5)),
    }


@pytest.fixture(scope="module")
def setup():
    data, queries, index = R.core_fixture()
    w0 = DBLSHParams.derive(n=4000, d=32, c=1.5, t=64, k=10, K=10, L=4).w0
    specs = _specs(w0)
    ref = R.baselines_reference(data, queries, specs, k=K_NN)
    more = R.baselines_reference(data, queries, {
        "FBLSH": (5, dict(K=6, L=3, w0=w0, c=1.5, t=4, cand_cap=24), dict(r0=0.2)),
        "C2Index": (6, dict(m=20, collision_ratio=0.3, w=3.0, cand_cap=40), {}),
    }, k=K_NN)
    return data, queries, specs, ref, more


def _assert_same(got_d, got_i, want_d, want_i, n):
    got_d, got_i = got_d.numpy(), got_i.numpy()
    np.testing.assert_allclose(got_d, want_d, rtol=RTOL)
    assert got_i.dtype == np.int32
    for q in range(want_d.shape[0]):
        d = want_d[q]
        fin = np.isfinite(d)
        assert np.array_equal(np.isfinite(got_d[q]), fin)
        assert np.all(got_i[q][~fin] == want_i[q][~fin])
        for j in np.flatnonzero(fin):
            near = np.abs(d - d[j]) <= RTOL * max(d[j], 1e-6)
            if near.sum() == 1:  # a distinct distance: the same id
                assert got_i[q, j] == want_i[q, j], (q, j)
            else:  # a tie: the same ids among the tied slots
                assert set(got_i[q][near]) == set(want_i[q][near]), (q, j)


@pytest.mark.parametrize("name,which", [(name, "core") for name in sorted(CLASSES)]
                         + [("C2Index", "more"), ("FBLSH", "more")])
def test_baseline_matches_reference(setup, name, which):
    data, queries, _, ref, more = setup
    table = ref if which == "core" else more
    arrays, meta, want_d, want_i = table[name]
    idx = CLASSES[name].from_arrays(arrays, device="cpu", **meta)
    kw = {"r0": 0.5 if which == "core" else 0.2} if name == "FBLSH" else {}
    got_d, got_i = idx.search_batch(torch.from_numpy(queries), k=K_NN, **kw)
    _assert_same(got_d, got_i, want_d, want_i, data.shape[0])


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_query_chunks_change_nothing(setup, name, monkeypatch):
    """A batch taken a few queries at a time gives the same bits as one
    taken whole."""
    _, queries, _, ref, _ = setup
    arrays, meta, _, _ = ref[name]
    idx = CLASSES[name].from_arrays(arrays, device="cpu", **meta)
    kw = {"r0": 0.5} if name == "FBLSH" else {}
    whole = idx.search_batch(torch.from_numpy(queries), k=K_NN, **kw)
    monkeypatch.setattr(baselines, "_CHUNK_ELEMS", 50_000)
    parts = idx.search_batch(torch.from_numpy(queries), k=K_NN, **kw)
    for a, b in zip(whole, parts):
        assert torch.equal(a, b)


def test_baselines_reasonable_recall(setup):
    """tests/test_core.py::test_baselines_reasonable_recall on the port's
    own draws, with the same bars."""
    data, queries, _, _, _ = setup
    data, queries = torch.from_numpy(data), torch.from_numpy(queries)
    k = K_NN
    _, gt = brute_force(data, queries, k=k, device="cpu")
    gt = gt.numpy()
    w0 = DBLSHParams.derive(n=4000, d=32, c=1.5, t=64, k=10, K=10, L=4).w0

    def recall(ids):
        return np.mean([len(set(a.tolist()) & set(b.tolist())) / k
                        for a, b in zip(ids.numpy(), gt)])

    gen = torch.Generator().manual_seed(1)
    mq = MQIndex.build(gen, data, m=15, beta=0.08, device="cpu")
    rec_mq = recall(mq.search_batch(queries, k=k)[1])
    assert rec_mq > 0.5, rec_mq

    c2 = C2Index.build(gen, data, m=40, w=2.0, device="cpu")
    rec_c2 = recall(c2.search_batch(queries, k=k)[1])
    assert rec_c2 > 0.3, rec_c2

    fb = FBLSH.build(gen, data, K=8, L=4, w0=w0, c=1.5, t=32, device="cpu")
    rec_fb = recall(fb.search_batch(queries, k=k, r0=0.5)[1])
    assert rec_fb > 0.2, rec_fb


def test_build_draws_and_shapes():
    """``build`` draws from the generator (the same seed, the same index),
    derives the reference's meta fields and needs a device without CUDA."""
    data = torch.randn(300, 8, generator=torch.Generator().manual_seed(0))
    for cls, kw in ((FBLSH, dict(K=4, L=3, w0=4.0, c=1.5, t=8)),
                    (MQIndex, dict(m=6, beta=0.1)), (C2Index, dict(m=10))):
        a = cls.build(torch.Generator().manual_seed(3), data, device="cpu", **kw)
        b = cls.build(torch.Generator().manual_seed(3), data, device="cpu", **kw)
        assert torch.equal(a.proj_vecs, b.proj_vecs) and torch.equal(a.proj, b.proj)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                cls.build(torch.Generator().manual_seed(3), data, **kw)
    fb = FBLSH.build(torch.Generator().manual_seed(3), data, K=4, L=3, w0=4.0, c=1.5, t=8,
                     device="cpu")
    assert fb.proj.shape == (3, 300, 4) and fb.cand_cap == 2 * 8 + 64
    assert float(fb.offsets.min()) >= 0.0 and float(fb.offsets.max()) < 4.0
    c2 = C2Index.build(torch.Generator(), data, m=10, device="cpu")
    assert (c2.l, c2.cand_cap) == (4, 256)
