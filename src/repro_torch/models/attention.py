"""GQA / MHA / sliding-window / cross attention with KV caches.

Layouts:
  activations  (B, T, D)
  q/k/v        (B, T, H|KV, hd)
  KV cache     (B, S, KV, hd)  — ring buffer of size `window` for SWA

Softmax runs in fp32 regardless of activation dtype.  On one device the
reference's tensor-parallel layouts have no counterpart: the scores are
always in the grouped (B, KV, G, T, S) layout, and ``mesh`` is accepted
and ignored.  Cross attention (the encoder-decoder and VLM families)
takes its keys and values from another sequence, with no RoPE and no
mask, and never the KV-chunked path, as the reference's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from .common import apply_rope, dense_init, einsum, matmul

__all__ = [
    "NEG",
    "CHUNKED_THRESHOLD",
    "attn_params",
    "attention",
    "cross_attention",
    "decode_attention",
    "decode_cross_attention",
    "CacheSpec",
    "init_cache",
]

NEG = -1e30
CHUNKED_THRESHOLD = 16384  # use online-softmax KV chunking past this S


def _inv_sqrt(hd: int) -> float:
    """1 / sqrt(hd) as float32 computes it (sqrt, then the reciprocal)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def _sqrt(hd: int) -> float:
    return float(np.sqrt(np.float32(hd)))


def attn_params(generator, d_model, n_heads, n_kv, head_dim, d_out=None,
                dtype=torch.float32, device=None) -> dict:
    d_out = d_out or d_model
    return {
        "wq": dense_init(generator, (d_model, n_heads, head_dim), d_model, dtype, device),
        "wk": dense_init(generator, (d_model, n_kv, head_dim), d_model, dtype, device),
        "wv": dense_init(generator, (d_model, n_kv, head_dim), d_model, dtype, device),
        "wo": dense_init(generator, (n_heads, head_dim, d_out), n_heads * head_dim, dtype,
                         device),
    }


def _proj(x, w):
    """(B, T, D) x (D, H, hd) -> (B, T, H, hd), as one matrix product."""
    D, H, hd = w.shape
    return matmul(x, w.reshape(D, H * hd)).reshape(*x.shape[:-1], H, hd)


def _out(ctx, wo):
    """(B, T, H, hd) x (H, hd, D) -> (B, T, D)."""
    H, hd, D = wo.shape
    return matmul(ctx.reshape(*ctx.shape[:-2], H * hd), wo.reshape(H * hd, D))


def _qkv(x, p, kv_src=None):
    kv_src = x if kv_src is None else kv_src
    return _proj(x, p["wq"]), _proj(kv_src, p["wk"]), _proj(kv_src, p["wv"])


def _gqa_scores(q, k):
    """q: (B,T,H,hd), k: (B,S,KV,hd) -> scores (B,KV,G,T,S), G = H/KV."""
    B, T, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, T, KV, G, hd)
    return einsum("btkgh,bskh->bkgts", qg, k) / _sqrt(hd)


def _gqa_out(scores, v, wo):
    """scores (B,KV,G,T,S), v (B,S,KV,hd) -> (B,T,D)."""
    B, KV, G, T, S = scores.shape
    probs = torch.softmax(scores.float(), dim=-1).to(v.dtype)
    ctx = torch.einsum("bkgts,bskh->btkgh", probs, v)
    ctx = ctx.reshape(B, T, KV * G, v.shape[-1])
    return _out(ctx, wo)


def _kv_chunked_context(q, k, v, *, causal, window, ck=1024):
    """Flash-style online-softmax attention: a loop over KV chunks.

    Memory O(T * ck) instead of O(T * S).  q: (B,T,H,hd) (RoPE applied);
    k/v: (B,S,KV,hd).  Returns ctx (B,T,H,hd).  fp32 running (max, denom,
    acc)."""
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    ck = min(ck, S)
    pad = (-S) % ck
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    nk = (S + pad) // ck
    dev = q.device
    qpos = torch.arange(T, device=dev)[:, None]
    scale = _inv_sqrt(hd)

    m = torch.full((B, H, T), -torch.inf, device=dev)
    l = torch.zeros((B, H, T), device=dev)  # noqa: E741 (the reference's name)
    acc = torch.zeros((B, T, H, hd), device=dev)
    for kj in range(nk):
        kb = k[:, kj * ck:(kj + 1) * ck]  # (B,ck,KV,hd)
        vb = v[:, kj * ck:(kj + 1) * ck]
        krep = kb[:, :, :, None, :].expand(B, ck, KV, G, hd).reshape(B, ck, H, hd)
        vrep = vb[:, :, :, None, :].expand(B, ck, KV, G, hd).reshape(B, ck, H, hd)
        s = einsum("bthd,bshd->bhts", q, krep).float() * scale
        kpos = kj * ck + torch.arange(ck, device=dev)[None, :]
        ok = (kpos < S).expand(T, ck)  # padding
        if causal:
            ok = ok & (qpos >= kpos)
        if window:
            ok = ok & ((qpos - kpos) < window)
        s = torch.where(ok[None, None], s, -torch.inf)
        mnew = torch.maximum(m, torch.amax(s, dim=-1))
        # guard: fully-masked rows keep m = -inf; exp(-inf - -inf) -> nan
        safe_m = torch.where(torch.isfinite(mnew), mnew, 0.0)
        pexp = torch.exp(s - safe_m[..., None])
        pexp = torch.where(ok[None, None], pexp, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m), 0.0)
        l = l * corr + torch.sum(pexp, dim=-1)  # noqa: E741
        upd = torch.einsum("bhts,bshd->bthd", pexp.to(v.dtype), vrep)
        acc = acc * torch.movedim(corr, 1, 2)[..., None] + upd.float()
        m = mnew
    denom = torch.clamp(torch.movedim(l, 1, 2), min=1e-30)[..., None]
    return (acc / denom).to(q.dtype)


def attention(x, p, positions, *, causal=True, window=0, rope_theta=1e4,
              kv_positions=None, use_rope=True, mesh=None):
    """Full-sequence attention (train / prefill).

    x: (B, T, D); positions: (B, T) integers.  Returns (B, T, D) plus the
    (k, v) tensors for cache seeding."""
    q, k, v = _qkv(x, p)
    if use_rope:
        kv_pos = positions if kv_positions is None else kv_positions
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, kv_pos, rope_theta)
    T = q.shape[1]
    S = k.shape[1]

    if S >= CHUNKED_THRESHOLD:
        # long-context path: O(T*ck) online-softmax loop over KV chunks
        ctx = _kv_chunked_context(q, k, v, causal=causal, window=window)
        return _out(ctx, p["wo"]), (k, v)

    i = torch.arange(T, device=x.device)[:, None]
    j = torch.arange(S, device=x.device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=x.device)
    if causal:
        mask = mask & (i >= j)
    if window:
        mask = mask & ((i - j) < window)
    scores = _gqa_scores(q, k)  # (B,KV,G,T,S)
    scores = torch.where(mask, scores, NEG)
    return _gqa_out(scores, v, p["wo"]), (k, v)


def cross_attention(x, p, kv_src, mesh=None):
    """Cross attention (decoder -> encoder states / image embeddings).
    x: (B, T, D), kv_src: (B, S, D).  No RoPE on the cross projections
    (the Whisper / Llama-Vision convention).  Returns (B, T, D) and the
    (k, v) of kv_src, the decode caches."""
    q, k, v = _qkv(x, p, kv_src=kv_src)
    return _gqa_out(_gqa_scores(q, k), v, p["wo"]), (k, v)


# ---------------------------------------------------------------------------
# decode with KV cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    batch: int
    size: int  # cache slots (= seq len, or window for SWA)
    n_kv: int
    head_dim: int
    window: int  # 0 = full


def init_cache(spec: CacheSpec, dtype, device=None) -> dict:
    shape = (spec.batch, spec.size, spec.n_kv, spec.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(x1, p, cache, pos, *, window=0, rope_theta=1e4, use_rope=True):
    """Single-token decode. x1: (B, 1, D); pos: a scalar or (B,) integers
    (per-slot positions — continuous batching); cache k/v: (B, S, KV, hd)
    (ring buffer when SWA).

    Returns (out (B,1,D), new_cache); the given cache is not modified."""
    B = x1.shape[0]
    S = cache["k"].shape[1]
    q = _proj(x1, p["wq"])
    k1 = _proj(x1, p["wk"])
    v1 = _proj(x1, p["wv"])
    posv = torch.as_tensor(pos, device=x1.device).to(torch.int64).reshape(-1).expand(B)
    posb = posv[:, None]
    if use_rope:
        q = apply_rope(q, posb, rope_theta)
        k1 = apply_rope(k1, posb, rope_theta)
    # the write slot; like a dynamic update slice, a start past the cache
    # clamps to its last slot
    slot = torch.remainder(posv, S) if window else torch.clamp(posv, 0, S - 1)
    rows = torch.arange(B, device=x1.device)
    ck = cache["k"].index_put((rows, slot), k1[:, 0].to(cache["k"].dtype))
    cv = cache["v"].index_put((rows, slot), v1[:, 0].to(cache["v"].dtype))

    scores = _gqa_scores(q, ck)  # (B,KV,G,1,S)
    j = torch.arange(S, device=x1.device)[None, :]  # (1,S)
    if window:
        # Ring buffer: slot j holds the most recent position p ≡ j (mod S)
        # with p <= pos, i.e. p_j = pos - ((slot - j) mod S). Valid iff it
        # was ever written (p_j >= 0); S == window bounds the lookback.
        p_j = posv[:, None] - torch.remainder(slot[:, None] - j, S)  # (B,S)
        mask = p_j >= 0
    else:
        mask = j <= posv[:, None]  # (B,S)
    scores = torch.where(mask[:, None, None, None, :], scores, NEG)
    out = _gqa_out(scores, cv, p["wo"])
    return out, {"k": ck, "v": cv}


def decode_cross_attention(x1, p, cache):
    """Decode-time cross attention against a precomputed (k, v) cache."""
    q = _proj(x1, p["wq"])
    return _gqa_out(_gqa_scores(q, cache["k"]), cache["v"], p["wo"])
