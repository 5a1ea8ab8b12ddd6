"""Everything ``repro`` exports, ``repro_torch`` exports.

For each module the port has, the reference's ``__all__`` is compared
with the port's (through ``_torch_parity``, which imports the
reference).  A name the port lacks must be listed below as waiting, by
the ROADMAP item that ports it; the port may export more (its launch
counters, ``from_arrays``, device helpers).  The two hashing helpers
that closed the gap are held against the reference at rtol 1e-6, and the
data helpers by shape and value.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
R = pytest.importorskip("_torch_parity")

from repro_torch.core import normal_pdf, normal_sf  # noqa: E402
from repro_torch.data import make_uniform, paper_dataset_specs  # noqa: E402

# names of modules not yet ported, by the ROADMAP item that ports them
WAITING = {}

PORTED = (
    "core", "core.baselines", "core.hashing", "core.index", "core.params",
    "core.query", "core.serve_search", "core.updates", "core.distributed",
    "data", "data.vectors",
    "kernels", "kernels.ref", "checkpoint", "checkpoint.checkpointer",
    "resilience", "resilience.faults", "resilience.stragglers", "resilience.degrade",
    "tune", "tune.adaptive", "tune.planner", "tune.policy",
    "obs", "obs.explain", "obs.metrics", "obs.slo", "obs.trace",
    "store", "store.cache", "store.collection", "store.lifecycle", "store.router",
    "store.service",
    "configs", "data.pipeline", "models.ffn", "serve", "serve.engine", "serve.retrieval",
)
# modules without ``__all__`` in the reference, whose imports are helpers:
# the functions and classes they define
DEFINED = (
    "models.attention", "models.transformer", "models.ssm", "models.registry",
    "models.encdec", "models.vlm",
)


@pytest.mark.parametrize("module", PORTED + DEFINED)
def test_port_exports_what_the_reference_exports(module):
    port = importlib.import_module("repro_torch" + (f".{module}" if module else ""))
    ref_all = set(R.ref_exports(module, defined=module in DEFINED))
    port_all = set(port.__all__)
    missing = ref_all - port_all
    assert missing == WAITING.get(module, set()), sorted(missing)
    assert all(hasattr(port, name) for name in port_all)


# normal_sf is 0.5 * (1 - erf(x / sqrt 2)) in both packages: past x ~ 1 the
# difference cancels, and a few float32 ulps of erf near 1.0 (2^-24 each,
# halved by the 0.5) are all that is left of the tail, so there it is held
# to 4 such ulps
SF_TAIL_ATOL = 4 * 2.0 ** -25


def test_normal_pdf_and_sf_match_reference():
    x = np.linspace(-6.0, 6.0, 241).astype(np.float32)
    H = R.ref_modules().hashing
    np.testing.assert_allclose(normal_pdf(torch.from_numpy(x)).numpy(),
                               np.asarray(H.normal_pdf(x)), rtol=1e-6)
    got = normal_sf(torch.from_numpy(x)).numpy()
    want = np.asarray(H.normal_sf(x))
    body = x <= 1.0
    np.testing.assert_allclose(got[body], want[body], rtol=1e-6)
    np.testing.assert_allclose(got[~body], want[~body], rtol=1e-6, atol=SF_TAIL_ATOL)


def test_data_helpers():
    assert paper_dataset_specs == R.ref_modules().data.paper_dataset_specs
    u = make_uniform(torch.Generator().manual_seed(0), 500, 7, device="cpu")
    assert u.shape == (500, 7) and u.dtype == torch.float32
    assert float(u.min()) >= -1.0 and float(u.max()) < 1.0
