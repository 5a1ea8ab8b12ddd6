"""Serving stack (``serve.engine``, ``serve.retrieval``, ``data.pipeline``,
``launch.serve``): tests/test_serving.py case for case on the port, and
the port against the reference on the same weights and data.

The parity cases carry the reference's smoke yi-9b (two layers, fp32)
into the port with ``params_from_reference`` (and, for greedy engine
outputs, its smoke mamba2-1.3b and arctic-480b too): the datastore's keys are
the reference's hidden states within 1e-4, its index carried across with
``from_arrays`` searches to the same ids, ``knn_probs`` agrees within
1e-5, and greedy engine outputs (with and without retrieval) are the
reference's token for token.  Sampled outputs are not compared: the port
draws from a ``torch.Generator``, not JAX's stream.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
R = pytest.importorskip("_torch_parity")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import DBLSHParams, build, from_arrays  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    MemmapTokens,
    Prefetcher,
    SyntheticTokens,
    make_batch_fn,
)
from repro_torch.models.registry import build_model, params_from_reference  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    Datastore,
    Request,
    RetrievalLM,
    ServeEngine,
    build_datastore,
    knn_probs,
)
from repro_torch.store import CompactionPolicy, Collection, QueryResultCache, StoreService  # noqa: E402

CPU = "cpu"


@pytest.fixture(scope="module")
def tiny():
    cfg = get_config("yi-9b").smoke().scaled(n_layers=2)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device=CPU)
    return cfg, model, params


@pytest.fixture(scope="module")
def carried():
    """The reference's smoke yi-9b and the port's copy of its weights."""
    ref = R.RefLM("yi-9b")
    model = build_model(ref.cfg)
    return ref, model, params_from_reference(ref.tree, ref.cfg, device=CPU)


def _engine(model, params, **kw):
    return ServeEngine(model, params, device=CPU, **kw)


def test_engine_continuous_batching(tiny):
    cfg, model, params = tiny
    eng = _engine(model, params, slots=2, cache_len=64)
    reqs = [
        Request(uid=i, prompt=np.arange(3 + i, dtype=np.int32) % cfg.vocab_size,
                max_new_tokens=4 + i)
        for i in range(5)  # more requests than slots -> queueing
    ]
    for r in reqs:
        eng.submit(r)
    steps = eng.run()
    assert steps > 0
    for r in reqs:
        assert r.done
        assert len(r.output) == r.max_new_tokens
        assert all(0 <= t < cfg.padded_vocab for t in r.output)


def test_engine_matches_single_stream(tiny):
    """A request decoded alone == the same request decoded while another
    request shares the batch (per-slot positions + caches are isolated)."""
    cfg, model, params = tiny
    p1 = np.arange(5, dtype=np.int32)
    p2 = (np.arange(7, dtype=np.int32) * 3) % cfg.vocab_size

    solo = Request(uid=0, prompt=p1, max_new_tokens=6)
    eng1 = _engine(model, params, slots=1, cache_len=64)
    eng1.submit(solo)
    eng1.run()

    a = Request(uid=1, prompt=p1, max_new_tokens=6)
    b = Request(uid=2, prompt=p2, max_new_tokens=6)
    eng2 = _engine(model, params, slots=2, cache_len=64)
    eng2.submit(a)
    eng2.submit(b)
    eng2.run()

    assert solo.output == a.output


def test_engine_sampling_and_retirement(tiny):
    """Temperature top-k sampling draws from the engine's generator (the
    same seed, the same tokens; every token among the top k); a full cache
    retires a request early, and an EOS token ends it."""
    cfg, model, params = tiny

    def run(seed, **req_kw):
        eng = _engine(model, params, slots=2, cache_len=16, seed=seed)
        reqs = [Request(uid=i, prompt=np.arange(4 + i, dtype=np.int32), **req_kw)
                for i in range(3)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        return reqs

    a = run(3, max_new_tokens=6, temperature=0.8, top_k=5)
    b = run(3, max_new_tokens=6, temperature=0.8, top_k=5)
    assert [r.output for r in a] == [r.output for r in b]
    assert all(r.done and len(r.output) == 6 for r in a)
    full = run(0, max_new_tokens=100)
    # admitted at pos = len(prompt), retired once pos reaches cache_len - 1
    assert [len(r.output) for r in full] == [16 - 1 - (4 + i) + 1 for i in range(3)]
    # EOS is checked on decoded tokens (not the prefill's): the greedy
    # sequence up to the first decoded EOS, inclusive
    seq = full[0].output
    eos = seq[2]
    stop = next(j for j in range(1, len(seq)) if seq[j] == eos)
    eng = _engine(model, params, slots=1, cache_len=64, eos_id=eos)
    r = Request(uid=9, prompt=np.arange(4, dtype=np.int32), max_new_tokens=10)
    eng.submit(r)
    eng.run()
    assert r.done and r.output == seq[:stop + 1]


def test_engine_ssm_family():
    """tests/test_serving.py::test_engine_ssm_family: the engine splices the
    SSM state and conv tail of each admitted request (more requests than
    slots)."""
    cfg = get_config("mamba2-1.3b").smoke().scaled(n_layers=2)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(1), device=CPU)
    eng = _engine(model, params, slots=2, cache_len=32)
    assert set(eng.caches) == {"ssm", "conv"}
    reqs = [Request(uid=i, prompt=np.arange(4, dtype=np.int32), max_new_tokens=5)
            for i in range(3)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    assert all(r.done and len(r.output) == 5 for r in reqs)
    assert reqs[0].output == reqs[2].output  # the same prompt, another slot


def test_knn_probs_retrieves_neighbors():
    """Keys clustered around distinct centroids with distinct values: a
    query near a centroid must put most kNN mass on that value."""
    D, vocab = 16, 50
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((5, D)).astype(np.float32) * 10.0
    pts = (centers[:, None, :] + 0.01 * rng.standard_normal((5, 200, D))).reshape(-1, D)
    vals = np.repeat(np.arange(5, dtype=np.int32) + 10, 200)
    params_lsh = DBLSHParams.derive(n=1000, d=D, c=1.5, t=32, k=8, K=8, L=3)
    index = build(torch.from_numpy(pts.astype(np.float32)), params_lsh,
                  generator=torch.Generator().manual_seed(4), device=CPU)
    ds = Datastore.from_index(index, vals, temperature=1.0, lam=0.5, k=8)
    q = torch.from_numpy(centers[2:3] + 0.01)
    probs = knn_probs(ds, q, vocab, r0=0.05, steps=10)
    assert probs.shape == (1, vocab)
    assert float(probs[0, 12]) > 0.9  # value of cluster 2
    np.testing.assert_allclose(float(torch.sum(probs)), 1.0, rtol=1e-3)


def test_scatter_probs_masks_unfilled_slots():
    """Unfilled slots (+inf) weigh nothing; a row with none filled is all
    zeros; tokens outside the vocabulary are dropped."""
    from repro_torch.serve.retrieval import _scatter_probs

    d = torch.tensor([[0.0, 1.0, torch.inf], [torch.inf, torch.inf, torch.inf],
                      [0.5, 0.5, 0.5]])
    toks = torch.tensor([[3, 3, 4], [1, 2, 3], [1, 7, 9]])
    p = _scatter_probs(d, toks, 8, 2.0)
    w = torch.softmax(torch.tensor([0.0, -0.5]), 0)
    assert torch.allclose(p[0, 3], w.sum()) and float(p[0, 4]) == 0.0
    assert not p[1].any()
    assert torch.allclose(p[2, 1], torch.tensor(1 / 3)) and torch.allclose(p[2, 7], p[2, 1])
    assert torch.allclose(p[2].sum(), torch.tensor(2 / 3))


def test_retrieval_lm_end_to_end(tiny):
    """Datastore built from the model's own hidden states; retrieval-
    augmented decode returns a valid distribution and runs in the engine."""
    cfg, model, params = tiny
    src = SyntheticTokens(cfg.vocab_size, 16, 2, seed=1)
    batches = [make_batch_fn(src)(s) for s in range(3)]
    ds = build_datastore(model, params, batches, torch.Generator().manual_seed(5), t=16,
                         k=4, block_size=32, device=CPU)
    assert ds.index.n == 3 * 2 * 16

    # a key finds itself: its row of knn_probs is a distribution
    p = knn_probs(ds, ds.index.data[:4], cfg.padded_vocab, r0=0.5, steps=4)
    assert torch.allclose(p.sum(-1), torch.ones(4), rtol=1e-3)
    rlm = RetrievalLM(model, ds, r0=0.5, steps=4)
    caches = model.init_cache(2, 8, device=CPU)
    with torch.inference_mode():
        logp, hidden, _ = rlm.decode(params, torch.tensor([1, 2]), caches, 0)
        found = torch.isfinite(ds.search(hidden, r0=0.5, steps=4)[0][:, 0])
    # the interpolation sums to 1 where a neighbour was found, else to 1 - lam
    assert bool(torch.isfinite(logp).all())
    want = torch.where(found, 1.0, 1.0 - ds.lam)
    assert torch.allclose(torch.exp(logp).sum(-1), want, rtol=1e-4)
    eng = _engine(model, params, slots=2, cache_len=64, retrieval=rlm)
    req = Request(uid=0, prompt=np.arange(4, dtype=np.int32), max_new_tokens=4)
    eng.submit(req)
    eng.run()
    assert req.done and len(req.output) == 4


def test_datastore_matches_reference(carried):
    """``build_datastore`` on the same weights and batches: keys are the
    reference's hidden states, values its labels; the reference's index
    carried across with ``from_arrays`` gives the same neighbours, and
    ``knn_probs`` agrees."""
    ref, model, params = carried
    cfg = ref.cfg
    batches = [R.ref_token_batch(cfg.vocab_size, 16, 2, 1, s) for s in range(3)]
    rds = ref.datastore(batches, 5, t=16, k=4, block_size=32)
    ds = build_datastore(model, params, batches, torch.Generator().manual_seed(5), t=16,
                         k=4, block_size=32, device=CPU)
    ref_arrays = R.index_arrays(rds.index)
    np.testing.assert_allclose(ds.index.data.numpy(), ref_arrays["data"], rtol=1e-4,
                               atol=1e-4)
    assert np.array_equal(ds.values.numpy(), np.asarray(rds.values))
    assert ds.index.params == DBLSHParams(**R.index_params(rds.index))

    carried_ds = Datastore.from_index(from_arrays(ref_arrays, R.index_params(rds.index),
                                                  device=CPU),
                                      ds.values, temperature=10.0, lam=0.25, k=4)
    queries = ref_arrays["data"][::7][:12] + 0.01
    want_p, want_d, want_i = R.ref_knn_probs(rds, queries, cfg.padded_vocab, 0.5, 4)
    d, i = carried_ds.search(torch.from_numpy(queries), r0=0.5, steps=4)
    # the search's norm form cancels at these norms (||x||^2 ~ d_model):
    # squared distances within 4e-6 x (||x||^2 + ||q||^2), as chip_smoke.py
    scale = 2 * float(np.max(np.sum(ref_arrays["data"] ** 2, -1)))
    assert np.array_equal(np.isfinite(d.numpy()), np.isfinite(want_d))
    fin = np.isfinite(want_d)
    np.testing.assert_allclose(d.numpy()[fin] ** 2, want_d[fin] ** 2, rtol=0,
                               atol=4e-6 * scale)
    for got_row, want_row, dr in zip(i.numpy(), want_i, want_d):
        fin = np.isfinite(dr)
        assert set(got_row[fin]) == set(want_row[fin])
    p = knn_probs(carried_ds, torch.from_numpy(queries), cfg.padded_vocab, r0=0.5, steps=4)
    np.testing.assert_allclose(p.numpy(), want_p, rtol=1e-5, atol=1e-5)


def _greedy_requests(vocab):
    rng = np.random.default_rng(11)
    return [dict(uid=i, prompt=rng.integers(0, vocab, size=3 + 2 * i).astype(np.int32),
                 max_new_tokens=5 + i) for i in range(4)]


def test_greedy_engine_matches_reference(carried):
    """Greedy outputs of the port's engine equal the reference's on the
    same weights, requests queued over two slots."""
    ref, model, params = carried
    reqs = _greedy_requests(ref.cfg.vocab_size)
    want = ref.engine(reqs, slots=2, cache_len=32)
    eng = _engine(model, params, slots=2, cache_len=32)
    got = [Request(**r) for r in reqs]
    for r in got:
        eng.submit(r)
    eng.run()
    assert [r.output for r in got] == want


def test_greedy_retrieval_engine_matches_reference(carried):
    """The same with kNN-LM retrieval: the reference's datastore (its index
    carried across) mixed into every decode step."""
    ref, model, params = carried
    cfg = ref.cfg
    batches = [R.ref_token_batch(cfg.vocab_size, 16, 2, 1, s) for s in range(3)]
    rds = ref.datastore(batches, 5, t=16, k=4, block_size=32, lam=0.5)
    ds = Datastore.from_index(from_arrays(R.index_arrays(rds.index),
                                          R.index_params(rds.index), device=CPU),
                              np.asarray(rds.values), temperature=10.0, lam=0.5, k=4)
    reqs = _greedy_requests(cfg.vocab_size)
    want = ref.engine(reqs, retrieval=ref.retrieval(rds, 0.5, 4), slots=2, cache_len=32)
    eng = _engine(model, params, slots=2, cache_len=32,
                  retrieval=RetrievalLM(model, ds, r0=0.5, steps=4))
    got = [Request(**r) for r in reqs]
    for r in got:
        eng.submit(r)
    eng.run()
    assert [r.output for r in got] == want


@pytest.fixture(scope="module", params=("mamba2-1.3b", "arctic-480b"))
def carried_family(request):
    """The reference's smoke SSM or MoE model and the port's copy."""
    ref = R.RefLM(request.param)
    model = build_model(ref.cfg)
    return ref, model, params_from_reference(ref.tree, ref.cfg, device=CPU)


@pytest.mark.parametrize("retrieval", [False, True])
def test_greedy_family_engine_matches_reference(carried_family, retrieval):
    """Greedy engine outputs of the SSM and MoE families equal the
    reference's on the same weights, without and with the reference's
    datastore (its index carried across) mixed into every step."""
    ref, model, params = carried_family
    cfg = ref.cfg
    reqs = _greedy_requests(cfg.vocab_size)
    kw, ref_kw = {}, {}
    if retrieval:
        batches = [R.ref_token_batch(cfg.vocab_size, 16, 2, 1, s) for s in range(3)]
        rds = ref.datastore(batches, 5, t=16, k=4, block_size=32, lam=0.5)
        ds = Datastore.from_index(from_arrays(R.index_arrays(rds.index),
                                              R.index_params(rds.index), device=CPU),
                                  np.asarray(rds.values), temperature=10.0, lam=0.5, k=4)
        ref_kw["retrieval"] = ref.retrieval(rds, 0.5, 4)
        kw["retrieval"] = RetrievalLM(model, ds, r0=0.5, steps=4)
    want = ref.engine(reqs, slots=2, cache_len=32, **ref_kw)
    eng = _engine(model, params, slots=2, cache_len=32, **kw)
    got = [Request(**r) for r in reqs]
    for r in got:
        eng.submit(r)
    eng.run()
    assert [r.output for r in got] == want


def test_datastore_search_uses_cache():
    """tests/test_store_scheduler.py::test_datastore_search_uses_cache:
    repeated hidden-state queries hit the shared cache; a collection
    mutation invalidates by version; a StoreService on the same cache
    serves the datastore's entries, payload included."""
    data, queries, _ = R.scheduler_fixture()
    colk = Collection.create(
        "knn", torch.Generator().manual_seed(23), data[:200], c=1.5, w0=3.6, t=8, k=5,
        payload=np.arange(200), policy=CompactionPolicy(auto=False), device=CPU,
    )
    cache = QueryResultCache(64)
    ds = Datastore(colk, temperature=10.0, lam=0.25, k=5, cache=cache)
    Q = queries[:4]
    d0, i0 = ds.search(Q, r0=0.5, steps=4)
    assert cache.misses > 0 and cache.hits == 0
    d1, i1 = ds.search(Q, r0=0.5, steps=4)  # all rows hit
    assert cache.hits == 4
    assert torch.equal(i1, i0) and torch.equal(d1, d0)
    colk.add(data[200:208], payload=np.arange(200, 208))
    d2, i2 = ds.search(Q, r0=0.5, steps=4)  # version bumped -> recompute
    assert cache.hits == 4
    _, want_i = colk.search(Q, k=5, r0=0.5, steps=4)
    assert torch.equal(i2, want_i)

    svc = StoreService(batch_shapes=(4,), max_wait_ms=1e9, default_k=5, r0=0.5, steps=4,
                       cache=cache)
    svc.attach(colk)
    reqs = [svc.submit("knn", q) for q in Q]
    svc.flush()
    assert all(r.cached for r in reqs)
    np.testing.assert_array_equal(np.stack([r.ids for r in reqs]), i2.numpy())
    for r in reqs:
        assert r.payload is not None and r.payload.shape == (5,)
        np.testing.assert_array_equal(r.payload, colk.get_payload(r.ids[None])[0].numpy())


def test_token_pipeline_matches_reference(tmp_path):
    """``SyntheticTokens`` batches are the reference's bit for bit (the
    same Philox counters), host-sharded too; ``MemmapTokens`` windows and
    the prefetcher's step order."""
    for step in (0, 3):
        want = R.ref_token_batch(1000, 24, 4, 7, step)
        got = make_batch_fn(SyntheticTokens(1000, 24, 4, seed=7))(step)
        for key in ("tokens", "labels"):
            assert got[key].dtype == np.int32 and np.array_equal(got[key], want[key])
    half = SyntheticTokens(1000, 24, 4, seed=7).batch_at(3, host_id=1, n_hosts=2)
    assert half["tokens"].shape == (2, 24)
    corpus = np.arange(1000, dtype=np.int32)
    path = tmp_path / "corpus.bin"
    corpus.tofile(path)
    mm = MemmapTokens(str(path), seq_len=10, global_batch=4)
    b = mm.batch_at(2)
    assert np.array_equal(b["tokens"][0], corpus[80:90])
    assert np.array_equal(b["labels"][0], corpus[81:91])
    pf = Prefetcher(make_batch_fn(SyntheticTokens(50, 4, 2, seed=1)), start_step=5)
    try:
        s, batch = pf.next()
        assert s == 5 and np.array_equal(batch["tokens"],
                                         SyntheticTokens(50, 4, 2, seed=1).batch_at(5)["tokens"])
    finally:
        pf.close()


def test_launch_serve_cpu(capsys):
    """``python -m repro_torch.launch.serve --device cpu`` serves every
    request (the smoke config, two layers, fp32), with retrieval too."""
    from repro_torch.launch import serve as launch_serve

    done, steps = launch_serve.main(["--device", "cpu", "--requests", "3", "--retrieval"])
    assert done == 3 and steps > 0
    assert "served 3/3 requests" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "arctic-480b"])
def test_launch_serve_cpu_families(arch, capsys):
    """``python -m repro_torch.launch.serve --device cpu --arch <arch>``:
    the SSM and MoE smoke configs through the engine."""
    from repro_torch.launch import serve as launch_serve

    done, steps = launch_serve.main(["--device", "cpu", "--arch", arch, "--requests", "3"])
    assert done == 3 and steps > 0
    assert "served 3/3 requests" in capsys.readouterr().out


def test_engine_needs_a_device_without_cuda(tiny):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    cfg, model, params = tiny
    batches = [make_batch_fn(SyntheticTokens(cfg.vocab_size, 8, 2))(0)]
    for call in (lambda: ServeEngine(model, params),
                 lambda: build_datastore(model, params, batches, torch.Generator())):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
