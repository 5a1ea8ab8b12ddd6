"""Mamba-2 SSD (state-space duality) mixer [arXiv:2405.21060].

Chunked SSD algorithm: within chunks of length Qc the recurrence is
evaluated in its dual quadratic "attention" form (batched matrix
products), across chunks the per-chunk end-states are propagated by a
loop over the chunks.  A single-token O(1) decode step maintains (SSM
state, conv ring).

Layout: x (B, T, D); SSM state (B, H, N, P) with H heads, state dim N,
head dim P; depthwise conv window W=4 over (x, B, C) channels.  The input
projection is three segment matrices (``w_zx`` -> (z, x heads), ``w_bc``
-> (B, C), ``w_dt``), as the reference stores it.

The dtypes are the reference's at each step: dt, the log decays and
their exponentials in float32, the O(T * Qc * H) decay tensors and the
state in the activation dtype, and ``softplus`` as ``logaddexp(x, 0)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import dense_init, einsum, matmul, rmsnorm

__all__ = ["CONV_W", "ssm_dims", "ssm_params", "ssm_forward", "ssm_decode"]

CONV_W = 4


def ssm_dims(cfg):
    P = cfg.ssm_head_dim or 64
    H = cfg.ssm_heads or (2 * cfg.d_model) // P
    d_inner = H * P
    N = cfg.ssm_state
    conv_dim = d_inner + 2 * N  # ngroups = 1
    d_proj = 2 * d_inner + 2 * N + H
    return d_inner, H, P, N, conv_dim, d_proj


def _uniform(generator, shape, lo, hi, device):
    out = torch.empty(shape, dtype=torch.float32, device=generator.device)
    out.uniform_(lo, hi, generator=generator)
    return out.to(device=device if device is not None else generator.device)


def ssm_params(generator, cfg, dtype=torch.float32, device=None) -> dict:
    """The mixer's weights; ``dtype`` is that of the >=2-D ones (the
    per-channel vectors stay float32)."""
    d_inner, H, P, N, conv_dim, d_proj = ssm_dims(cfg)
    dev = device if device is not None else generator.device
    D = cfg.d_model
    return {
        "w_zx": dense_init(generator, (D, 2 * d_inner), D, dtype, device),
        "w_bc": dense_init(generator, (D, 2 * N), D, dtype, device),
        "w_dt": dense_init(generator, (D, H), D, dtype, device),
        "conv_wx": dense_init(generator, (CONV_W, d_inner), CONV_W, dtype, device),
        "conv_bx": torch.zeros((d_inner,), dtype=torch.float32, device=dev),
        "conv_wbc": dense_init(generator, (CONV_W, 2 * N), CONV_W, dtype, device),
        "conv_bbc": torch.zeros((2 * N,), dtype=torch.float32, device=dev),
        "A_log": torch.log(_uniform(generator, (H,), 1.0, 16.0, device)),
        "D_skip": torch.ones((H,), dtype=torch.float32, device=dev),
        "dt_bias": torch.log(torch.expm1(_uniform(generator, (H,), 1e-3, 0.1, device))),
        "norm_scale": torch.zeros((d_inner,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(generator, (d_inner, D), d_inner, dtype, device),
    }


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))  # jax.nn.softplus


def _project(x, p, cfg):
    """x -> (z, x_raw, bc_raw, dt_raw) via the segment matrices."""
    d_inner = ssm_dims(cfg)[0]
    zx = matmul(x, p["w_zx"])  # (B,T,2*d_inner)
    return zx[..., :d_inner], zx[..., d_inner:], matmul(x, p["w_bc"]), matmul(x, p["w_dt"])


def _causal_conv(xBC, w, b):
    """Depthwise causal conv, width CONV_W. xBC: (B, T, C)."""
    T = xBC.shape[1]
    pad = F.pad(xBC, (0, 0, CONV_W - 1, 0))
    out = pad[:, 0:T, :] * w[0][None, None, :]
    for i in range(1, CONV_W):
        out = out + pad[:, i:i + T, :] * w[i][None, None, :]
    return F.silu(out + b)


def ssm_forward(x, p, cfg, chunk: int = 128, init_state=None):
    """Full-sequence SSD. Returns (y (B,T,D), final_state (B,H,N,P),
    conv_tail (B, CONV_W-1, conv_dim))."""
    B, T0, D = x.shape
    d_inner, H, P, N, conv_dim, _ = ssm_dims(cfg)
    Qc = min(chunk, T0)
    pad = (-T0) % Qc
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    T = T0 + pad
    nc = T // Qc
    dt_ = x.dtype

    z, x_raw, bc_raw, dt = _project(x, p, cfg)
    xconv = _causal_conv(x_raw, p["conv_wx"], p["conv_bx"]).to(dt_)
    bcconv = _causal_conv(bc_raw, p["conv_wbc"], p["conv_bbc"]).to(dt_)
    xh = xconv.reshape(B, T, H, P)
    Bm = bcconv[..., :N]  # (B,T,N)
    Cm = bcconv[..., N:]  # (B,T,N)

    dt = _softplus(dt.float() + p["dt_bias"])  # (B,T,H)
    if pad:
        # padded steps become identity state updates (decay 1, input 0)
        valid = (torch.arange(T, device=x.device) < T0).float()
        dt = dt * valid[None, :, None]
    A = -torch.exp(p["A_log"])  # (H,)
    dA = dt * A  # (B,T,H) negative

    # chunk views
    dA_c = dA.reshape(B, nc, Qc, H)
    dt_c = dt.reshape(B, nc, Qc, H)
    x_c = xh.reshape(B, nc, Qc, H, P)
    B_c = Bm.reshape(B, nc, Qc, N)
    C_c = Cm.reshape(B, nc, Qc, N)

    cs = torch.cumsum(dA_c, dim=2)  # (B,nc,Qc,H) within-chunk log decay

    # intra-chunk (dual quadratic form)
    CB = torch.einsum("bcin,bcjn->bcij", C_c, B_c)  # (B,nc,Qc,Qc)
    i_idx = torch.arange(Qc, device=x.device)
    causal = (i_idx[:, None] >= i_idx[None, :])[None, None, :, :, None]
    # mask inside the exponent: cs_i - cs_j > 0 for i < j would overflow
    delta = torch.where(causal, cs[:, :, :, None, :] - cs[:, :, None, :, :], -torch.inf)
    # exp in fp32 for range, then the O(T*Qc*H) tensors in the activation dtype
    decay = torch.exp(delta).to(dt_)  # (B,nc,i,j,H)
    att = CB[..., None] * decay * dt_c[:, :, None, :, :].to(dt_)
    del delta, decay
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", att, x_c)
    del att

    # per-chunk end states
    seg = torch.exp(cs[:, :, -1:, :] - cs) * dt_c  # (B,nc,Qc,H)
    S_chunk = torch.einsum("bcjh,bcjn,bcjhp->bchnp", seg.to(dt_), B_c, x_c)

    # inter-chunk recurrence (the reference's lax.scan over chunks)
    chunk_decay = torch.exp(cs[:, :, -1, :])  # (B,nc,H)
    S = init_state if init_state is not None else torch.zeros((B, H, N, P), dtype=dt_,
                                                              device=x.device)
    S_prevs = []
    for c in range(nc):
        S_prevs.append(S)
        S = S * chunk_decay[:, c, :, None, None].to(S.dtype) + S_chunk[:, c]
    S_prevs = torch.stack(S_prevs, dim=1)  # (B,nc,H,N,P) state entering chunk

    y_inter = einsum("bcin,bchnp->bcihp", C_c, S_prevs) * torch.exp(cs)[..., None].to(dt_)

    y = (y_intra + y_inter).reshape(B, T, H, P)
    y = y + p["D_skip"][None, None, :, None].to(dt_) * xh
    y = y.reshape(B, T, d_inner)

    y = rmsnorm(y * F.silu(z), p["norm_scale"], cfg.norm_eps)
    out = matmul(y, p["out_proj"])[:, :T0]
    xBC_raw = torch.cat([x_raw, bc_raw], dim=-1)  # cache layout
    if T0 >= CONV_W - 1:
        conv_tail = xBC_raw[:, T0 - (CONV_W - 1):T0, :]
    else:
        conv_tail = F.pad(xBC_raw[:, :T0, :], (0, 0, CONV_W - 1 - T0, 0))
    return out, S, conv_tail


def ssm_decode(x1, p, cfg, state, conv_state):
    """Single-token decode. x1: (B,1,D); state: (B,H,N,P);
    conv_state: (B, CONV_W-1, conv_dim). Returns (y, state, conv_state)."""
    B = x1.shape[0]
    d_inner, H, P, N, conv_dim, _ = ssm_dims(cfg)

    z, x_raw, bc_raw, dt = _project(x1, p, cfg)
    xBC_raw = torch.cat([x_raw, bc_raw], dim=-1)
    window = torch.cat([conv_state, xBC_raw], dim=1)  # (B, CONV_W, C)
    conv_w = torch.cat([p["conv_wx"], p["conv_wbc"]], dim=-1)
    conv_b = torch.cat([p["conv_bx"], p["conv_bbc"]], dim=-1)
    xBC = F.silu(einsum("bwc,wc->bc", window, conv_w) + conv_b)[:, None, :].to(x1.dtype)
    new_conv = window[:, 1:, :]

    xh = xBC[..., :d_inner].reshape(B, H, P)
    Bm = xBC[..., d_inner:d_inner + N].reshape(B, N)
    Cm = xBC[..., d_inner + N:].reshape(B, N)
    dt = _softplus(dt[:, 0].float() + p["dt_bias"])  # (B,H)
    dA = torch.exp(dt * -torch.exp(p["A_log"]))  # (B,H)

    upd = torch.einsum("bh,bn,bhp->bhnp", dt.to(x1.dtype), Bm, xh)
    state = state * dA[:, :, None, None].to(state.dtype) + upd
    y = einsum("bn,bhnp->bhp", Cm, state)
    y = y + p["D_skip"][None, :, None].to(x1.dtype) * xh
    y = y.reshape(B, 1, d_inner)
    y = rmsnorm(y * F.silu(z), p["norm_scale"], cfg.norm_eps)
    return matmul(y, p["out_proj"]), state, new_conv
