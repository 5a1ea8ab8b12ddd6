"""The quantized serving path (kernel B3, ``search_batch_fixed(dtype=...)``)
held against the reference on the same numpy inputs.

* ``quantize_blocks`` and ``_quantize_query`` bit-equal (bf16 compared
  through its 16-bit pattern);
* the B3 twins against the reference's Pallas kernels in interpret mode,
  at the shapes of tests/test_kernels.py:280-357 (int8: bins equal, bf16:
  bins within the reference's own bf16 rounding);
* the quantized search on every engine against the reference's quantized
  ``jnp`` search on the fixture of tests/test_onepass_search.py:228-240,
  stats exactly equal;
* the re-rank contract against a float64 diff-form oracle, and recall
  against the port's own float32 search on the same index (not the
  reference's 1e-3 distance band, which fails on this tree: ROADMAP C).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
R = pytest.importorskip("_torch_parity")

from repro_torch.core import (  # noqa: E402
    ENGINES,
    Termination,
    from_arrays,
    quantize_blocks,
    search_batch_fixed,
    search_batch_fixed_dispatch,
)
from repro_torch.kernels import fused_cand_search, fused_window_search  # noqa: E402
from repro_torch.kernels.ops import _quantize_query  # noqa: E402

K_TEST = 8
DTYPES = ("bf16", "int8")
SKW = dict(k=K_TEST, r0=0.5, steps=8)


def _torch(a: np.ndarray) -> torch.Tensor:
    """numpy -> torch, bf16 (``ml_dtypes.bfloat16``) through its bits."""
    if str(a.dtype) == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _bits(t: torch.Tensor) -> np.ndarray:
    """A port tensor as comparable numpy: bf16 as its 16-bit pattern."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _ref_bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint16) if str(a.dtype) == "bfloat16" else a


# ------------------------------------------------------------ quantization

@pytest.mark.parametrize("dtype", DTYPES)
def test_quantize_blocks_bit_equal(dtype):
    """Per-slot quantization of real-valued rows, an all-zero row (scale
    1.0), padded ids (n and larger: zero rows) — bit-equal."""
    rng = np.random.default_rng(11)
    n, d = 300, 24
    data = (rng.standard_normal((n, d)) * 3.0).astype(np.float32)
    data[17] = 0.0
    data[18, :] = 0.5  # every element on a rounding tie after scaling: 63.5
    data[18, 0] = 1.0
    ids = rng.permutation(2 * 8 * 20).reshape(2, 8, 20).astype(np.int32)  # ids >= n padded
    rq, rs = R.quantize_blocks(data, ids, dtype)
    gq, gs = quantize_blocks(torch.from_numpy(data), torch.from_numpy(ids), dtype)
    assert gq.dtype == (torch.bfloat16 if dtype == "bf16" else torch.int8)
    np.testing.assert_array_equal(_bits(gq), _ref_bits(rq))
    np.testing.assert_array_equal(gs.numpy(), rs)
    assert (gq[torch.from_numpy(ids >= n)].float() == 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_quantize_query_bit_equal(dtype):
    """bf16 rounds to nearest even; int8 rounds half to even on the ties
    of row 2 (q / qs = k + 0.5 exactly); an all-zero row gets scale 1."""
    rng = np.random.default_rng(12)
    q = rng.standard_normal((5, 33)).astype(np.float32)
    q[1] = 0.0
    q[2] = np.float32(0.5) * (np.arange(33) % 7 - 3)
    q[2, 0] = 127.0  # qs = 1: q / qs hits every half-integer of row 2 exactly
    rv, rs = R.quantize_query(q, dtype)
    gv, gs = _quantize_query(torch.from_numpy(q), dtype)
    np.testing.assert_array_equal(_bits(gv), _ref_bits(rv))
    np.testing.assert_array_equal(gs.numpy(), rs)
    assert gs.shape == (5, 1) and gs.dtype == torch.float32


# ------------------------------------------------------------- B3 twins

def _window_case(seed, d, Q=2, L=2, M=4, nb=8, B=32, K=4, steps=6):
    """tests/test_kernels.py::_mk_window from numpy: the vectors behind
    the blocks, each id once per table, ids >= n padded, block ids with
    the invalid sentinel L*nb."""
    rng = np.random.default_rng(seed)
    lnb = L * nb
    n = lnb * B - 3
    data = rng.standard_normal((n, d)).astype(np.float32)
    ids = rng.permutation(lnb * B).reshape(lnb, B).astype(np.int32)
    vec = np.where((ids < n)[..., None], data[np.minimum(ids, n - 1)], 0.0).astype(np.float32)
    nrm = np.where(ids < n, np.sum(vec * vec, axis=-1), np.inf).astype(np.float32)
    proj = np.where((ids < n)[..., None], rng.standard_normal((lnb, B, K)) * 2.0,
                    np.inf).astype(np.float32)
    blk = rng.integers(0, lnb + 1, (Q, L * M)).astype(np.int32)
    g = rng.standard_normal((Q, L, K)).astype(np.float32)
    q = rng.standard_normal((Q, d)).astype(np.float32)
    halves = np.asarray([0.4 * 1.5 ** j for j in range(steps)], np.float32)
    return data, (blk, halves, proj, vec, nrm, ids, g, q), n


def _cand_case(seed, dtype, Q=1, L=2, Ct=300, K=12, d=96, steps=6, n=4096):
    """tests/test_kernels.py's gathered inputs, ragged Ct (not a multiple
    of the reference's tile), every 7th slot invalid (+inf projection and
    norm), quantized per slot as the reference's quantize_blocks does."""
    rng = np.random.default_rng(seed)
    cp = (rng.standard_normal((Q, L, Ct, K)) * 2.0).astype(np.float32)
    cx = rng.standard_normal((Q, L, Ct, d)).astype(np.float32)
    cn = np.sum(cx * cx, axis=-1).astype(np.float32)
    ci = rng.integers(0, n, (Q, L, Ct)).astype(np.int32)
    cp[:, :, ::7, :] = np.inf
    cn[:, :, ::7] = np.inf
    g = rng.standard_normal((Q, L, K)).astype(np.float32)
    q = rng.standard_normal((Q, d)).astype(np.float32)
    halves = np.asarray([0.4 * 1.5 ** j for j in range(steps)], np.float32)
    flat = cx.reshape(-1, d)
    qx, qs = R.quantize_blocks(flat, np.arange(flat.shape[0], dtype=np.int32), dtype)
    return (cp, qx.reshape(cx.shape), cn, ci, halves, g, q), qs.reshape(cn.shape), n


def _assert_quant_bins(got, ref, dtype):
    """int8: counts, ids (per bin, as sets) and distances (rtol = atol =
    1e-5) equal — the integer dot is exact.  bf16: counts equal, per-bin
    id overlap >= 0.98 (the two frameworks sum the bf16 products in other
    orders, so near-ties at the ks cut may swap), distances rtol = atol =
    1e-5 on the shared ids."""
    gd, gi, gc = (x.numpy() for x in got)
    rd, ri, rc = ref
    np.testing.assert_array_equal(gc, rc)
    hits = total = 0
    Qn, steps, _ = gd.shape
    for qq in range(Qn):
        for j in range(steps):
            rf, gf = np.isfinite(rd[qq, j]), np.isfinite(gd[qq, j])
            rmap = dict(zip(ri[qq, j][rf].tolist(), rd[qq, j][rf].tolist()))
            gmap = dict(zip(gi[qq, j][gf].tolist(), gd[qq, j][gf].tolist()))
            if dtype == "int8":
                assert set(gmap) == set(rmap), (qq, j)
            shared = sorted(set(gmap) & set(rmap))
            hits += len(shared)
            total += len(rmap)
            np.testing.assert_allclose([gmap[i] for i in shared], [rmap[i] for i in shared],
                                       rtol=1e-5, atol=1e-5)
    assert total > 0 and hits / total >= 0.98, hits / total


@pytest.mark.parametrize("dtype,d,ks", [("int8", 16, 8), ("bf16", 24, 10), ("int8", 24, 40)])
def test_b3_window_twin_matches_reference(dtype, d, ks):
    data, (blk, halves, proj, vec, nrm, ids, g, q), n = _window_case(77 + d, d)
    qx, qs = R.quantize_blocks(data, ids, dtype)
    ref, _ = R.fused_window(blk, halves, proj, qx, nrm, ids, g, q, M=4, ks=ks, n=n,
                            mode=dtype, x_scale=qs)
    args = [torch.from_numpy(a) for a in (blk, halves, proj)] + [_torch(qx)] + [
        torch.from_numpy(a) for a in (nrm, ids, g, q)]
    got = fused_window_search(*args, M=4, ks=ks, n=n, mode=dtype, x_scale=_torch(qs))
    _assert_quant_bins(got, ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_b3_cand_twin_matches_reference(dtype):
    (cp, cx, cn, ci, halves, g, q), cs, n = _cand_case(5, dtype)
    ref, _ = R.fused_cand(cp, cx, cn, ci, halves, g, q, ks=20, n=n, mode=dtype, cand_scale=cs)
    args = [torch.from_numpy(cp), _torch(cx)] + [
        torch.from_numpy(a) for a in (cn, ci, halves, g, q)]
    got = fused_cand_search(*args, ks=20, n=n, mode=dtype, cand_scale=_torch(cs))
    _assert_quant_bins(got, ref, dtype)


# ------------------------------------------------------- the search path

@pytest.fixture(scope="module")
def quant_setup():
    """Per dtype: the reference's quantized fixture index, the port's index
    from its arrays (quantized blocks re-derived, as a restore does), and
    the reference's quantized jnp search with explain."""
    out = {}
    for dt in DTYPES:
        data, queries, ref = R.onepass_quant_fixture(dt)
        index = from_arrays(R.index_arrays(ref), R.index_params(ref), device="cpu")
        rd, ri, rs, rex = R.search_batch_fixed(ref, queries, dtype=dt, engine="jnp",
                                               with_explain=True, **SKW)
        out[dt] = dict(data=data, queries=queries, ref=ref, index=index,
                       result=tuple(map(np.asarray, (rd, ri))), stats=rs, explain=rex)
    return out


@pytest.mark.parametrize("dtype", DTYPES)
def test_quantized_index_matches_reference(quant_setup, dtype):
    """``from_arrays`` re-derives the quantized blocks bit-equal to the
    reference's build, and ``memory_bytes`` counts them as it does."""
    s = quant_setup[dtype]
    want = R.quant_arrays(s["ref"])
    np.testing.assert_array_equal(_bits(s["index"].qvec_blocks), _ref_bits(want["qvec_blocks"]))
    np.testing.assert_array_equal(s["index"].qvec_scale.numpy(), want["qvec_scale"])
    assert s["index"].memory_bytes() == s["ref"].memory_bytes()


def _agreement(a_i, a_d, b_i, b_d):
    """Mean per-query id-set agreement |A & B| / |B| over finite entries."""
    out = []
    for q in range(b_i.shape[0]):
        a = set(a_i[q][np.isfinite(a_d[q])].tolist())
        b = set(b_i[q][np.isfinite(b_d[q])].tolist())
        out.append(len(a & b) / max(len(b), 1))
    return float(np.mean(out))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_quant_search_matches_reference(quant_setup, dtype, engine):
    """Against the reference's quantized jnp search: mean id-set
    agreement >= 0.99 (the norm-form q2 differs by ulps between the
    frameworks and may swap near-ties), distances within the norm form's
    rtol = atol = 1e-2, stats and explain exactly equal."""
    s = quant_setup[dtype]
    gd, gi, gs, gex = search_batch_fixed(s["index"], s["queries"], engine=engine, dtype=dtype,
                                         with_explain=True, device="cpu", **SKW)
    rd, ri = s["result"]
    assert _agreement(gi.numpy(), gd.numpy(), ri, rd) >= 0.99
    both = np.isfinite(rd) & np.isfinite(gd.numpy()) & (gi.numpy() == ri)
    np.testing.assert_allclose(gd.numpy()[both], rd[both], rtol=1e-2, atol=1e-2)
    for key in ("radius_steps", "candidates"):
        np.testing.assert_array_equal(gs[key].numpy(), np.asarray(s["stats"][key]), err_msg=key)
    for key in ("step_half", "step_slots", "term_cause", "final_radius"):
        np.testing.assert_array_equal(gex[key].numpy(), np.asarray(s["explain"][key]),
                                      err_msg=key)
    pending = search_batch_fixed_dispatch(s["index"], s["queries"], engine=engine, dtype=dtype,
                                          device="cpu", **SKW)
    pd_, pi_ = pending.result()
    assert torch.equal(pd_, gd) and torch.equal(pi_, gi)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_quant_rerank_and_recall(quant_setup, dtype, engine):
    """The re-rank contract: every returned distance is its id's float32
    distance, held against a float64 diff-form oracle with an atol
    scaled by the norms (the norm form cancels: its error scales with
    ||x||^2 + ||q||^2, not with d^2).  Recall against the port's own
    float32 search on the same index >= 0.95."""
    s = quant_setup[dtype]
    data, queries = s["data"].astype(np.float64), s["queries"].astype(np.float64)
    gd, gi = search_batch_fixed(s["index"], s["queries"], engine=engine, dtype=dtype,
                                device="cpu", **SKW)
    fd, fi = search_batch_fixed(s["index"], s["queries"], engine=engine, device="cpu", **SKW)
    gd, gi = gd.numpy().astype(np.float64), gi.numpy()
    fin = np.isfinite(gd)
    assert fin[:, 0].all()
    for q in range(gd.shape[0]):
        x = data[gi[q][fin[q]]]
        true2 = np.sum((x - queries[q]) ** 2, axis=-1)
        scale = np.sum(x * x, axis=-1) + np.sum(queries[q] ** 2)
        np.testing.assert_allclose(gd[q][fin[q]] ** 2, true2, rtol=1e-5, atol=4e-6 * scale.max())
    assert _agreement(gi, gd, fi.numpy(), fd.numpy()) >= 0.95


@pytest.mark.parametrize("engine", ENGINES)
def test_quant_termination_stats_match_fp32(quant_setup, engine):
    """tests/test_onepass_search.py::test_quant_termination_stats_match_fp32:
    C1 counts float32 admissions and C2 reads re-ranked float32
    distances, so a quantized search terminates as the float32 one."""
    s = quant_setup["int8"]
    term = Termination(use_c1=True, use_c2=True)
    *_, s_fp, e_fp = search_batch_fixed(s["index"], s["queries"], engine=engine,
                                        with_explain=True, termination=term, device="cpu",
                                        **SKW)
    *_, s_q, e_q = search_batch_fixed(s["index"], s["queries"], engine=engine,
                                      with_explain=True, termination=term, dtype="int8",
                                      device="cpu", **SKW)
    assert torch.equal(s_fp["radius_steps"], s_q["radius_steps"])
    assert torch.equal(e_fp["term_cause"], e_q["term_cause"])


def test_dtype_validation(quant_setup):
    """tests/test_onepass_search.py::test_dtype_validation: unknown names,
    quantized + exact, and index/dtype mismatches raise."""
    fp32 = from_arrays(*(lambda r: (R.index_arrays(r), R.index_params(r)))(
        R.onepass_fixture()[2]), device="cpu")
    queries = quant_setup["int8"]["queries"]
    with pytest.raises(ValueError, match="dtype"):
        search_batch_fixed(fp32, queries, k=5, dtype="fp64", device="cpu")
    with pytest.raises(ValueError, match="exact"):
        search_batch_fixed(quant_setup["int8"]["index"], queries, k=5, dtype="int8",
                           exact=True, device="cpu")
    with pytest.raises(ValueError, match="quant_dtype"):
        search_batch_fixed(fp32, queries, k=5, dtype="int8", device="cpu")
    with pytest.raises(ValueError, match="quant_dtype"):
        search_batch_fixed(quant_setup["bf16"]["index"], queries, k=5, dtype="int8",
                           device="cpu")
