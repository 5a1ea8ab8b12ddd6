"""Termination (C1/C2, early exit), explain and dispatch of the port's
``search_batch_fixed``: against the reference on the same arrays, and the
reference's own contracts within the port (tests/test_tune.py,
tests/test_obs.py::TestExplainDevice).

The fixture is tests/test_tune.py's (n = 2048, d = 24, max_blocks = 16 <
nb), carried across with ``from_arrays``.  The reference's Pallas engines
run in interpret mode.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
R = pytest.importorskip("_torch_parity")

from _hypothesis_compat import given, settings, st  # noqa: E402
from repro_torch.core import (  # noqa: E402
    ENGINES,
    TERM_C1,
    TERM_C2,
    TERM_EXHAUSTED,
    PendingSearch,
    Termination,
    from_arrays,
    search_batch_fixed,
    search_batch_fixed_dispatch,
)

K_TEST = 8
REF_ENGINE = {"torch": "jnp", "kernel": "kernel", "inline": "inline"}


@pytest.fixture(scope="module")
def setup():
    data, queries, ref = R.tune_fixture()
    index = from_arrays(R.index_arrays(ref), R.index_params(ref), device="cpu")
    return data, queries, ref, index


def _bit_equal(a, b):
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _idsets(d, i):
    d, i = np.asarray(d), np.asarray(i)
    return [set(i[q][np.isfinite(d[q])].tolist()) for q in range(d.shape[0])]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("steps", [1, 4, 8])
def test_c2_only_adaptive_bit_equal_to_fixed(setup, engine, steps):
    """With C1 off, the adaptive schedule (early exit on or off) is
    bit-equal to the fixed one, stats included: C2's done mask is the
    rule the fixed path applies, and done queries are frozen."""
    _, queries, _, index = setup
    kw = dict(k=K_TEST, r0=0.3, steps=steps, engine=engine, exact=True,
              with_stats=True, device="cpu")
    fixed = search_batch_fixed(index, queries, **kw)
    for early in (False, True):
        adaptive = search_batch_fixed(
            index, queries, termination=Termination(use_c1=False, early_exit=early), **kw)
        _bit_equal(fixed, adaptive)
        for key in ("radius_steps", "candidates"):
            assert torch.equal(fixed[2][key], adaptive[2][key]), key


@pytest.mark.parametrize("engine", ENGINES)
def test_c2_certification_property(setup, engine):
    """Whenever a query terminates early via C2 at radius r_i, its k-th
    distance is <= c·r_i and its top-1 is within c²·r_i of the true NN
    (float64 diff-form oracle)."""
    data, queries, _, index = setup
    c = index.params.c
    X, Qm = data.astype(np.float64), queries.astype(np.float64)
    nn = np.sqrt(((Qm[:, None, :] - X[None, :, :]) ** 2).sum(-1).min(axis=1))
    checked = 0
    for steps in (4, 8, 12):
        for r0 in (0.1, 0.3):
            d, _, stats = search_batch_fixed(
                index, queries, k=K_TEST, r0=r0, steps=steps, engine=engine, exact=True,
                with_stats=True, termination=Termination(use_c1=False), device="cpu")
            d, rs = d.numpy(), stats["radius_steps"].numpy()
            r_i = r0 * np.power(c, np.maximum(rs, 1) - 1)
            kth = d[:, K_TEST - 1]
            mask = (rs < steps) & np.isfinite(kth) & (kth <= c * r_i * (1 + 1e-6))
            tol = 1e-5
            for q in np.flatnonzero(mask):
                checked += 1
                assert d[q, K_TEST - 1] <= c * r_i[q] * (1 + tol)
                assert d[q, 0] - nn[q] <= c * c * r_i[q] * (1 + tol)
                assert d[q, 0] + tol >= nn[q] - tol
    assert checked > 0


@given(c1_budget=st.integers(16, 256))
@settings(deadline=None, max_examples=8)
def test_c1_budget_terminates_earlier(setup, c1_budget):
    """C1 can only stop queries no later, and with no more candidates,
    than the fixed schedule."""
    _, queries, _, index = setup
    kw = dict(k=K_TEST, r0=0.1, steps=10, with_stats=True, device="cpu")
    fixed = search_batch_fixed(index, queries, **kw)
    adaptive = search_batch_fixed(index, queries, termination=Termination(c1_budget=c1_budget),
                                  **kw)
    assert (adaptive[2]["radius_steps"] <= fixed[2]["radius_steps"]).all()
    assert (adaptive[2]["candidates"] <= fixed[2]["candidates"]).all()


TERMINATIONS = {
    "default": Termination(),
    "c2only": Termination(use_c1=False),
    "c1only": Termination(use_c2=False, c1_budget=200, early_exit=False),
}


@pytest.mark.parametrize("term", sorted(TERMINATIONS))
@pytest.mark.parametrize("engine", ENGINES)
def test_termination_and_explain_match_reference(setup, engine, term):
    """The same termination policy gives the reference's id sets, stats
    and explain record (step slots, causes, radii, halfwidths exactly);
    distances to a few float32 ulps (exact form)."""
    _, queries, ref, index = setup
    kw = dict(k=K_TEST, r0=0.3, steps=6, exact=True, with_explain=True)
    rd, ri, rs, rex = R.search_batch_fixed(ref, queries, engine=REF_ENGINE[engine],
                                           interpret=True, termination=TERMINATIONS[term], **kw)
    gd, gi, gs, gex = search_batch_fixed(index, queries, engine=engine,
                                         termination=TERMINATIONS[term], device="cpu", **kw)
    assert _idsets(gd, gi) == _idsets(rd, ri)
    np.testing.assert_allclose(gd.numpy(), np.asarray(rd), rtol=3e-7, atol=5e-7)
    for key in ("radius_steps", "candidates"):
        np.testing.assert_array_equal(gs[key].numpy(), np.asarray(rs[key]), err_msg=key)
    for key in ("step_half", "step_slots", "term_cause", "final_radius"):
        assert gex[key].dtype == {"step_slots": torch.int32, "term_cause": torch.int32}.get(
            key, torch.float32), key
        np.testing.assert_array_equal(gex[key].numpy(), np.asarray(rex[key]), err_msg=key)


@pytest.mark.parametrize("engine", ENGINES)
def test_explain_off_bit_equal(setup, engine):
    """Explain only observes: results and stats are bit-equal with it on
    and off; step slots partition the candidates; causes are in
    vocabulary; the halfwidths are the geometric ladder."""
    _, queries, _, index = setup
    for term in (None, Termination()):
        kw = dict(k=K_TEST, r0=0.5, steps=4, engine=engine, with_stats=True,
                  termination=term, device="cpu")
        d0, i0, s0 = search_batch_fixed(index, queries[:8], **kw)
        d1, i1, s1, ex = search_batch_fixed(index, queries[:8], with_explain=True, **kw)
        _bit_equal((d0, i0), (d1, i1))
        for key in ("radius_steps", "candidates"):
            assert torch.equal(s0[key], s1[key]), key
        assert torch.equal(ex["step_slots"].sum(dim=1, dtype=torch.int32), s0["candidates"])
        assert set(ex["term_cause"].tolist()) <= {TERM_EXHAUSTED, TERM_C1, TERM_C2}
        half = ex["step_half"].numpy()
        assert half.shape == (4,)
        np.testing.assert_allclose(half[1:] / half[:-1], 1.5, rtol=1e-5)


@pytest.mark.parametrize("with_explain", [False, True])
def test_dispatch_bit_equal(setup, with_explain):
    """The dispatch handle returns the synchronous call's results bit for
    bit; on the CPU it is ready at once."""
    _, queries, _, index = setup
    kw = dict(k=K_TEST, r0=0.3, steps=6, engine="kernel", with_stats=True,
              termination=Termination(), with_explain=with_explain, device="cpu")
    sync = search_batch_fixed(index, queries, **kw)
    pending = search_batch_fixed_dispatch(index, queries, **kw)
    assert isinstance(pending, PendingSearch) and pending.ready()
    d, i, stats = pending.result()
    _bit_equal(sync, (d, i))
    for key in ("radius_steps", "candidates"):
        assert torch.equal(sync[2][key], stats[key])
    if with_explain:
        assert all(torch.equal(sync[3][key], pending.explain[key]) for key in sync[3])
    else:
        assert pending.explain is None
    plain = search_batch_fixed_dispatch(index, queries, k=K_TEST, device="cpu")
    assert plain.stats is None and len(plain.result()) == 2


def test_dispatch_matches_reference_pending(setup):
    """The reference's PendingSearch contract: result() gives (d, i[,
    stats]) with explain kept on the handle; the port's agrees on ids."""
    _, queries, ref, index = setup
    kw = dict(k=K_TEST, r0=0.3, steps=6, with_stats=True, with_explain=True,
              termination=Termination())
    rp = R.search_batch_fixed_dispatch(ref, queries, engine="jnp", **kw)
    gp = search_batch_fixed_dispatch(index, queries, engine="torch", device="cpu", **kw)
    (rd, ri, rs), (gd, gi, gs) = rp.result(), gp.result()
    assert _idsets(gd, gi) == _idsets(rd, ri)
    np.testing.assert_array_equal(gs["radius_steps"].numpy(), np.asarray(rs["radius_steps"]))
    np.testing.assert_array_equal(gp.explain["term_cause"].numpy(),
                                  np.asarray(rp.explain["term_cause"]))
