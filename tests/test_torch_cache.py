"""The port's copy of ``store/cache.py`` held to its contract and to the
reference's ``QueryResultCache``.

LRU order and capacity, version keying (a mutation's new version never
matches an old entry), the ``quantize_eps`` and ``quantize`` key
wideners (tests/test_tune.py::test_quantized_cache_keys' key half),
termination in the key, ``invalidate``, the registry mirror, and the
same keys and stats as the reference's cache over one script of
operations.  Service-level copies (tickets never alias a cached row) are
in tests/test_torch_service.py.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
R = pytest.importorskip("_torch_parity")

from repro_torch.core import Termination  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402
from repro_torch.store import CachedResult, QueryResultCache  # noqa: E402


def _entry(v: float, k: int = 4) -> CachedResult:
    return CachedResult(dists=np.full(k, v, np.float32), ids=np.arange(k, dtype=np.int32),
                        payload=None, radius_steps=2, candidates=64)


def _q(seed: int, d: int = 8) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(d).astype(np.float32)


def test_lru_order_and_capacity():
    cache = QueryResultCache(capacity=2)
    keys = [cache.key("c", 1, _q(i), 4, "torch", 0.5, 6) for i in range(3)]
    cache.put(keys[0], _entry(0.0))
    cache.put(keys[1], _entry(1.0))
    assert cache.get(keys[0]) is not None  # 0 is now the most recent
    cache.put(keys[2], _entry(2.0))        # evicts 1, the least recent
    assert cache.get(keys[1]) is None
    assert cache.get(keys[0]).dists[0] == 0.0 and cache.get(keys[2]).dists[0] == 2.0
    assert len(cache) == 2
    assert cache.stats() == {"size": 2, "capacity": 2, "hits": 3, "misses": 1,
                             "hit_rate": 0.75}


def test_version_and_every_field_key_the_entry():
    cache = QueryResultCache(capacity=16)
    q = _q(0)
    base = ("c", 1, q, 4, "torch", 0.5, 6)
    cache.put(cache.key(*base), _entry(0.0))
    assert cache.get(cache.key(*base)) is not None
    # a mutation's new version, another collection, k, engine, r0, steps
    # or a termination policy: each a miss
    for i, other in enumerate(("d", 2, _q(1), 5, "inline", 0.75, 7)):
        args = list(base)
        args[i] = other
        assert cache.get(cache.key(*args)) is None, i
    assert cache.get(cache.key(*base, Termination())) is None
    assert cache.hits == 1 and cache.misses == 8


def test_quantize_eps_keys():
    """tests/test_tune.py::test_quantized_cache_keys, its key half:
    eps-bucketing widens hits to near-duplicate queries; the version
    still keys the entry; exact keys need bit-equal queries."""
    q = (np.round(_q(3) / 1e-3) * 1e-3).astype(np.float32)
    cache = QueryResultCache(capacity=16, quantize_eps=1e-3)
    k1 = cache.key("a", 1, q, 8, "torch", 0.5, 6)
    assert cache.key("a", 1, q + 1e-5, 8, "torch", 0.5, 6) == k1
    assert cache.key("a", 1, q + 1.0, 8, "torch", 0.5, 6) != k1
    assert cache.key("a", 2, q, 8, "torch", 0.5, 6) != k1
    assert cache.key("a", 1, q, 8, "torch", 0.5, 6, Termination()) != k1
    exact = QueryResultCache(capacity=16)
    assert exact.key("a", 1, q, 8, "torch", 0.5, 6) != exact.key(
        "a", 1, q + 1e-5, 8, "torch", 0.5, 6)
    dec = QueryResultCache(capacity=16, quantize=2)
    assert dec.key("a", 1, q, 8, "torch", 0.5, 6) == dec.key(
        "a", 1, q + 1e-4, 8, "torch", 0.5, 6)
    with pytest.raises(AssertionError):
        QueryResultCache(capacity=16, quantize=2, quantize_eps=1e-3)


def test_entries_are_frozen_and_invalidate_by_collection():
    cache = QueryResultCache(capacity=8)
    e = _entry(1.0)
    with pytest.raises(dataclasses.FrozenInstanceError):
        e.radius_steps = 3
    for name in ("a", "a", "b"):
        cache.put(cache.key(name, len(cache), _q(len(cache)), 4, "torch", 0.5, 6), e)
    assert cache.invalidate("a") == 2 and len(cache) == 1
    assert cache.invalidate() == 1 and len(cache) == 0


def test_registry_mirror():
    reg = MetricsRegistry()
    cache = QueryResultCache(capacity=4).bind_metrics(reg)
    key = cache.key("c", 1, _q(0), 4, "torch", 0.5, 6)
    cache.get(key)
    cache.put(key, _entry(0.0))
    cache.get(key)
    assert reg.get("repro_store_result_cache_hits_total").value() == 1
    assert reg.get("repro_store_result_cache_misses_total").value() == 1
    assert reg.get("repro_store_result_cache_size").value() == 1


@pytest.mark.parametrize("widen", [{}, {"quantize_eps": 1e-2}, {"quantize": 1}])
def test_same_keys_and_stats_as_reference(widen):
    """One script of puts and gets on both packages' caches: equal keys,
    equal hit/miss outcomes, equal stats."""
    ref_cache = R.ref_modules().store.QueryResultCache(capacity=5, **widen)
    port_cache = QueryResultCache(capacity=5, **widen)
    rng = np.random.default_rng(11)
    qs = [_q(i) for i in range(7)]
    for step in range(60):
        i, version = int(rng.integers(0, 7)), int(rng.integers(1, 3))
        q = qs[i] + np.float32(1e-4) * np.float32(rng.integers(0, 2))
        args = ("c", version, q, 4, "torch", 0.5, 6)
        kp, kr = port_cache.key(*args), ref_cache.key(*args)
        assert kp == kr
        hit_p, hit_r = port_cache.get(kp), ref_cache.get(kr)
        assert (hit_p is None) == (hit_r is None), step
        if hit_p is None:
            port_cache.put(kp, _entry(float(step)))
            ref_cache.put(kr, R.ref_modules().store.CachedResult(
                **dataclasses.asdict(_entry(float(step)))))
    assert port_cache.stats() == ref_cache.stats()
