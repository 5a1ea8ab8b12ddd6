"""The squared-distance matrix kernel B8 (``pairwise_l2``): its twin vs
the reference's Pallas kernel (interpret mode) at the parametrizations and
tolerances of tests/test_kernels.py:496-532, and the wrapper's checks.
The kernel itself is held against the twin on a CUDA device by
tests/test_torch_kernels.py, on these inputs.

Inputs are made as float32 with numpy; bf16 inputs are cast from them in
each framework (both round to nearest even).
"""

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")

from repro_torch.kernels import launches, pairwise_l2  # noqa: E402

SHAPES = [  # (nq, nn, d), test_kernels.py:496-501
    (8, 16, 8),
    (256, 512, 128),
    (100, 300, 65),  # ragged everything
    (1, 1000, 960),  # gist-shaped
]
TORCH_DTYPE = {"fp32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(scope="module")
def R():
    return pytest.importorskip("_torch_parity")


def _inputs(seed, nq, nn, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((nq, d)).astype(np.float32),
            rng.standard_normal((nn, d)).astype(np.float32))


def _t(a, dtype="fp32", device="cpu"):
    return torch.from_numpy(a).to(device=device, dtype=TORCH_DTYPE[dtype]).contiguous()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_pairwise_l2_twin_matches_reference(R, shape, dtype):
    """The twin (through the wrapper, on CPU tensors) against the
    reference's kernel in interpret mode and its jnp oracle, with
    tests/test_kernels.py's tolerances: rtol = tol, atol = tol * d, tol
    1e-4 (fp32) or 5e-2 (bf16)."""
    nq, nn, d = shape
    Q, X = _inputs(nq + nn, nq, nn, d)
    kern, oracle = R.pairwise_l2_both(Q, X, dtype)
    before = dict(launches)
    got = pairwise_l2(_t(Q, dtype), _t(X, dtype))
    assert launches == before
    assert got.dtype == torch.float32 and got.shape == (nq, nn)
    tol = 1e-4 if dtype == "fp32" else 5e-2
    for want in (kern, oracle):
        np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol * d)
    assert (got >= 0).all()


@given(nq=st.integers(1, 40), nn=st.integers(1, 80), d=st.integers(1, 70))
@settings(deadline=None, max_examples=10)
def test_pairwise_l2_property(R, nq, nn, d):
    """test_kernels.py::test_pairwise_l2_property: random shapes, the
    reference on small tiles (16, 16, 32, so that every dimension is
    ragged and d spans tiles), rtol 2e-4, atol 2e-3.  ``R`` is
    module-scoped, as hypothesis requires of a fixture."""
    Q, X = _inputs(nq * 7919 + nn * 31 + d, nq, nn, d)
    kern, _ = R.pairwise_l2_both(Q, X, tile_q=16, tile_n=16, tile_d=32)
    got = pairwise_l2(_t(Q), _t(X))
    np.testing.assert_allclose(got.numpy(), kern, rtol=2e-4, atol=2e-3)


def test_pairwise_l2_self_distance_zero():
    """test_kernels.py::test_pairwise_l2_self_distance_zero: the diagonal
    of X against itself is ~0 (the clamp keeps it non-negative)."""
    X = np.random.default_rng(3).standard_normal((64, 32)).astype(np.float32)
    got = pairwise_l2(_t(X), _t(X)).numpy()
    assert np.all(np.abs(np.diag(got)) < 1e-3) and (got >= 0).all()


def test_pairwise_l2_rejects_wrong_inputs():
    """Mixed dtypes, unsupported dtypes, other widths, non-matrices,
    non-contiguous operands and operands on several devices raise."""
    Q, X = (_t(a) for a in _inputs(0, 4, 8, 16))
    with pytest.raises(TypeError, match="X"):
        pairwise_l2(Q, X.to(torch.bfloat16))
    with pytest.raises(TypeError, match="Q"):
        pairwise_l2(Q.double(), X.double())
    with pytest.raises(ValueError, match="X"):
        pairwise_l2(Q, X[:, :8].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        pairwise_l2(Q, torch.empty((16, 8)).T)
    with pytest.raises(ValueError, match="matrices"):
        pairwise_l2(Q[None], X)
    with pytest.raises(ValueError, match="devices"):
        pairwise_l2(Q, X.to("meta"))
