"""The SSD mixer (``models.ssm``): tests/test_ssm.py case for case on the
port, and the port against the reference on the same parameters.

The port's own cases draw their parameters from a ``torch.Generator`` and
hold the chunked forward against the token-by-token decode at the
reference's tolerances (2e-4; 3e-4 for the prefill-then-decode handoff).
The parity cases carry the reference's drawn parameters across as numpy
arrays and run ``ssm_forward`` and ``ssm_decode`` of both packages on the
same inputs, in float32, at rtol = atol = 1e-4.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
R = pytest.importorskip("_torch_parity")

from repro_torch.models import ssm  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


@dataclasses.dataclass(frozen=True)
class TinyCfg:
    d_model: int = 32
    ssm_state: int = 8
    ssm_heads: int = 4
    ssm_head_dim: int = 8
    norm_eps: float = 1e-5


def _params(seed, cfg=TinyCfg()):
    return ssm.ssm_params(torch.Generator().manual_seed(seed), cfg, device="cpu")


def _x(seed, shape, scale=0.5):
    return torch.from_numpy(
        (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32))


def _naive_ssd(x, p, cfg):
    """Sequential reference: run ssm_decode token by token."""
    B, T, D = x.shape
    d_inner, H, P, N, conv_dim, _ = ssm.ssm_dims(cfg)
    state = torch.zeros((B, H, N, P), dtype=x.dtype)
    conv = torch.zeros((B, ssm.CONV_W - 1, conv_dim), dtype=x.dtype)
    ys = []
    for t in range(T):
        y, state, conv = ssm.ssm_decode(x[:, t:t + 1], p, cfg, state, conv)
        ys.append(y)
    return torch.cat(ys, dim=1), state


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(tol or TOL))


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_chunked_matches_sequential(chunk):
    cfg = TinyCfg()
    p = _params(1)
    x = _x(0, (2, 16, cfg.d_model))
    y_seq, s_seq = _naive_ssd(x, p, cfg)
    y_chk, s_chk, _ = ssm.ssm_forward(x, p, cfg, chunk=chunk)
    _close(y_chk, y_seq, rtol=2e-4, atol=2e-4)
    _close(s_chk, s_seq, rtol=2e-4, atol=2e-4)


def test_prefill_then_decode_continuity():
    """State handoff: prefill T tokens, then decode more — must equal the
    full-sequence forward."""
    cfg = TinyCfg()
    p = _params(2)
    x = _x(3, (1, 12, cfg.d_model))
    y_full, s_full, _ = ssm.ssm_forward(x, p, cfg, chunk=4)
    _, state, conv = ssm.ssm_forward(x[:, :8], p, cfg, chunk=4)
    ys = []
    for t in range(8, 12):
        y1, state, conv = ssm.ssm_decode(x[:, t:t + 1], p, cfg, state, conv)
        ys.append(y1)
    _close(torch.cat(ys, dim=1), y_full[:, 8:], rtol=3e-4, atol=3e-4)
    _close(state, s_full, rtol=3e-4, atol=3e-4)


def test_no_nans_long():
    cfg = TinyCfg()
    p = _params(4)
    y, s, _ = ssm.ssm_forward(_x(5, (1, 256, cfg.d_model), 1.0), p, cfg, chunk=64)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())


def test_padded_tail_and_short_prompt():
    """T not a multiple of the chunk: the padded steps leave the state as
    it was, and the conv tail is taken from the unpadded positions (left-
    padded with zeros below CONV_W - 1 tokens)."""
    cfg = TinyCfg()
    p = _params(6)
    x = _x(7, (2, 11, cfg.d_model))
    y_seq, s_seq = _naive_ssd(x, p, cfg)
    y, s, tail = ssm.ssm_forward(x, p, cfg, chunk=4)
    _close(y, y_seq, rtol=2e-4, atol=2e-4)
    _close(s, s_seq, rtol=2e-4, atol=2e-4)
    d_inner = ssm.ssm_dims(cfg)[0]
    x_raw = x @ p["w_zx"][:, d_inner:]
    assert torch.equal(tail[..., :d_inner], x_raw[:, 8:11])
    _, _, short = ssm.ssm_forward(x[:, :2], p, cfg, chunk=4)
    assert short.shape[1] == ssm.CONV_W - 1
    assert not short[:, 0].any() and torch.equal(short[:, 1:, :d_inner], x_raw[:, :2])


@pytest.mark.parametrize("chunk,T", [(4, 16), (8, 13), (16, 5)])
def test_forward_matches_reference(chunk, T):
    """ssm_forward of both packages on the reference's parameters: the
    output, final state and conv tail."""
    cfg = TinyCfg()
    tree = R.ref_ssm_params(cfg, 1)
    p = {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
    x = _x(8 + T, (2, T, cfg.d_model)).numpy()
    want = R.ref_ssm_forward(x, tree, cfg, chunk)
    got = ssm.ssm_forward(torch.from_numpy(x), p, cfg, chunk=chunk)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close(g, w)


def test_decode_matches_reference():
    """ssm_decode of both packages, step by step from the reference's
    prefill state: outputs, states and conv rings."""
    cfg = TinyCfg()
    tree = R.ref_ssm_params(cfg, 2)
    p = {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
    x = _x(9, (2, 10, cfg.d_model)).numpy()
    _, state, conv = R.ref_ssm_forward(x[:, :6], tree, cfg, 4)
    s_t, c_t = torch.from_numpy(state), torch.from_numpy(conv)
    for t in range(6, 10):
        y, state, conv = R.ref_ssm_decode(x[:, t:t + 1], tree, cfg, state, conv)
        y_t, s_t, c_t = ssm.ssm_decode(torch.from_numpy(x[:, t:t + 1]), p, cfg, s_t, c_t)
        _close(y_t, y)
        _close(s_t, state)
        _close(c_t, conv)


def test_params_follow_the_reference_rules():
    """Shapes and dtypes of the reference's tree; A_log = log U(1, 16),
    dt_bias = log(expm1(U(1e-3, 0.1))), zero norms and biases, unit skip."""
    cfg = TinyCfg()
    tree = R.ref_ssm_params(cfg, 3)
    p = _params(3)
    assert set(p) == set(tree)
    for k, v in tree.items():
        assert tuple(p[k].shape) == v.shape and p[k].dtype == torch.float32, k
    a = torch.exp(p["A_log"])
    assert bool(((a >= 1.0) & (a <= 16.0)).all())
    dt = torch.log1p(torch.exp(p["dt_bias"]))
    assert bool(((dt >= 1e-3 - 1e-6) & (dt <= 0.1 + 1e-6)).all())
    assert not p["norm_scale"].any() and not p["conv_bx"].any()
    assert bool((p["D_skip"] == 1).all())
