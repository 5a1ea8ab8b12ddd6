"""Encoder-decoder transformer (Whisper-medium backbone).

The audio frontend (mel + conv downsampling) is a stub: the encoder
consumes precomputed frame embeddings (B, enc_seq, d_model), as numpy
arrays or tensors (moved to the parameters' device).  Whisper uses
absolute sinusoidal positions (no RoPE) and GELU FFNs; the embeddings are
tied with the LM head.

Decoder layers: self-attn (causal, cached) -> cross-attn (to the encoder
output; during decode the cross K/V are precomputed once) -> FFN.

The parameters are an :class:`EncDec` module whose names follow the
reference's key paths (``embed``, ``enc_blocks.<i>.attn.wq``,
``enc_norm``, ``dec_blocks.<i>.xattn.wk``, ``final_norm``).  Each layer
casts its >=2-D float32 weights to the compute dtype as it runs, as the
reference's scanned layers do.  Caches are stacked: ``k``/``v`` (L, B, S,
KV, hd) and the cross ``xk``/``xv`` (L, B, enc_seq, KV, hd), which decode
passes on unchanged.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from . import attention as attn
from . import ffn as ffn_mod
from .common import DTYPES, compute_dtype, cross_entropy, embed_init, matmul, rmsnorm
from .transformer import Block, _layer_params, _stack, _tokens, _zeros

__all__ = ["EncDec", "sinusoid", "sinusoid_at", "init_params", "encode", "dec_forward",
           "loss_fn", "cache_spec", "decode", "prefill"]


class EncDec(nn.Module):
    """``embed`` (V, D), ``enc_blocks`` and ``dec_blocks`` (lists of
    :class:`~repro_torch.models.transformer.Block`), ``enc_norm`` and
    ``final_norm`` (D,)."""

    def __init__(self, embed, enc_blocks, enc_norm, dec_blocks, final_norm):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.enc_blocks = nn.ModuleList(enc_blocks)
        self.enc_norm = nn.Parameter(enc_norm, requires_grad=False)
        self.dec_blocks = nn.ModuleList(dec_blocks)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)


def _angles(pos: torch.Tensor, D: int) -> torch.Tensor:
    """(P,) positions -> (P, D): the sin half, then the cos half, in float32."""
    dim = torch.arange(0, D, 2, dtype=torch.float32, device=pos.device)[None, :]
    angle = pos[:, None].float() / torch.pow(10000.0, dim / D)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def sinusoid(T: int, D: int, offset: int = 0, device=None) -> torch.Tensor:
    """(T, D) sinusoids at positions offset .. offset + T - 1."""
    return _angles(torch.arange(offset, offset + T, dtype=torch.float32, device=device), D)


def sinusoid_at(pos, D: int, device=None) -> torch.Tensor:
    """Sinusoid at position(s): a scalar or (B,) -> (B, 1, D)."""
    return _angles(torch.as_tensor(pos, device=device).reshape(-1), D)[:, None, :]


def _enc_block_init(generator, cfg, device, dtype) -> Block:
    D = cfg.d_model
    return Block(_zeros((D,), device),
                 attn=attn.attn_params(generator, D, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                       dtype=dtype, device=device),
                 norm2=_zeros((D,), device),
                 ffn=ffn_mod.dense_ffn_params(generator, D, cfg.d_ff, cfg.ffn_kind, dtype,
                                              device))


def _dec_block_init(generator, cfg, device, dtype) -> Block:
    D = cfg.d_model
    return Block(_zeros((D,), device),
                 attn=attn.attn_params(generator, D, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                       dtype=dtype, device=device),
                 norm_x=_zeros((D,), device),
                 xattn=attn.attn_params(generator, D, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                        dtype=dtype, device=device),
                 norm2=_zeros((D,), device),
                 ffn=ffn_mod.dense_ffn_params(generator, D, cfg.d_ff, cfg.ffn_kind, dtype,
                                              device))


def init_params(generator, cfg, device=None) -> EncDec:
    """Random weights by the reference's rules, drawn in order (embedding,
    encoder, decoder), each >=2-D weight stored in ``cfg.param_dtype`` as
    it is drawn."""
    device = device if device is not None else generator.device
    pd = DTYPES[cfg.param_dtype]
    embed = embed_init(generator, (cfg.padded_vocab, cfg.d_model), pd, device)
    enc = [_enc_block_init(generator, cfg, device, pd) for _ in range(cfg.n_enc_layers)]
    dec = [_dec_block_init(generator, cfg, device, pd) for _ in range(cfg.n_layers)]
    return EncDec(embed, enc, _zeros((cfg.d_model,), device), dec,
                  _zeros((cfg.d_model,), device))


def _logits(params: EncDec, hidden):
    """The tied head: hidden @ embed.T in the hidden states' dtype."""
    return matmul(hidden, params.embed.T.to(hidden.dtype))


def encode(params: EncDec, frames, cfg, mesh=None):
    """frames: (B, S_enc, D) stub embeddings -> encoder states."""
    dt = compute_dtype(cfg)
    frames = torch.as_tensor(frames, device=params.embed.device)
    B, S, D = frames.shape
    x = frames.to(dt) + sinusoid(S, D, device=frames.device).to(dt)[None]
    positions = torch.arange(S, device=x.device).expand(B, S)
    for block in params.enc_blocks:
        bp = _layer_params(block, dt)
        h = rmsnorm(x, bp["norm1"], cfg.norm_eps)
        a, _ = attn.attention(h, bp["attn"], positions, causal=False, use_rope=False)
        x = x + a
        h2 = rmsnorm(x, bp["norm2"], cfg.norm_eps)
        x = x + ffn_mod.dense_ffn(h2, bp["ffn"], cfg.ffn_kind)
    return rmsnorm(x, params.enc_norm, cfg.norm_eps)


def dec_forward(params: EncDec, tokens, enc_out, cfg, mesh=None, want_cache=False):
    """Decoder train/prefill.  Returns (hidden, caches): ``k``/``v`` of the
    self attention and ``xk``/``xv`` of the cross attention, stacked (L,
    ...) when ``want_cache``, else {}."""
    dt = compute_dtype(cfg)
    tokens = _tokens(tokens, params)
    B, T = tokens.shape
    x = params.embed[tokens].to(dt)
    x = x + sinusoid(T, cfg.d_model, device=x.device).to(dt)[None]
    positions = torch.arange(T, device=x.device).expand(B, T)
    caches = []
    for block in params.dec_blocks:
        bp = _layer_params(block, dt)
        h = rmsnorm(x, bp["norm1"], cfg.norm_eps)
        a, (k, v) = attn.attention(h, bp["attn"], positions, causal=True, use_rope=False)
        x = x + a
        hx = rmsnorm(x, bp["norm_x"], cfg.norm_eps)
        c, (xk, xv) = attn.cross_attention(hx, bp["xattn"], enc_out)
        x = x + c
        h2 = rmsnorm(x, bp["norm2"], cfg.norm_eps)
        x = x + ffn_mod.dense_ffn(h2, bp["ffn"], cfg.ffn_kind)
        if want_cache:
            caches.append({"k": k, "v": v, "xk": xk, "xv": xv})
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    return x, (_stack(caches) if want_cache else {})


def loss_fn(params: EncDec, batch, cfg, mesh=None):
    """Next-token CE.  batch: {'tokens', 'labels': (B, T), 'frames': (B,
    S_enc, D)}."""
    enc_out = encode(params, batch["frames"], cfg, mesh)
    hidden, _ = dec_forward(params, batch["tokens"], enc_out, cfg, mesh)
    logits = _logits(params, hidden)
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    loss = cross_entropy(logits, labels, cfg.vocab_size)
    return loss, {"ce": loss, "hidden": hidden}


def cache_spec(cfg, batch: int, seq_len: int) -> dict:
    """The caches as ``device="meta"`` tensors."""
    dt = compute_dtype(cfg)
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    self_kv = (L, batch, seq_len, KV, hd)
    cross_kv = (L, batch, cfg.enc_seq, KV, hd)
    return {name: torch.empty(shape, dtype=dt, device="meta")
            for name, shape in (("k", self_kv), ("v", self_kv), ("xk", cross_kv),
                                ("xv", cross_kv))}


def decode(params: EncDec, token, caches, pos, cfg, mesh=None):
    """One decoder step against the cached self K/V and the precomputed
    cross K/V.  token: (B,) integers; pos: a scalar or (B,).  Returns
    (logits (B, V), hidden (B, D), new caches); ``xk``/``xv`` are passed
    on as they are."""
    dt = compute_dtype(cfg)
    x = params.embed[_tokens(token, params)[:, None]].to(dt)
    pos = torch.as_tensor(pos, device=x.device)
    x = x + sinusoid_at(pos, cfg.d_model).to(dt)
    ks, vs = [], []
    for li, block in enumerate(params.dec_blocks):
        bp = _layer_params(block, dt)
        h = rmsnorm(x, bp["norm1"], cfg.norm_eps)
        a, kv = attn.decode_attention(h, bp["attn"], {"k": caches["k"][li],
                                                      "v": caches["v"][li]}, pos,
                                      use_rope=False)
        x = x + a
        hx = rmsnorm(x, bp["norm_x"], cfg.norm_eps)
        x = x + attn.decode_cross_attention(hx, bp["xattn"], {"k": caches["xk"][li],
                                                              "v": caches["xv"][li]})
        h2 = rmsnorm(x, bp["norm2"], cfg.norm_eps)
        x = x + ffn_mod.dense_ffn(h2, bp["ffn"], cfg.ffn_kind)
        ks.append(kv["k"])
        vs.append(kv["v"])
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    new = {**caches, "k": torch.stack(ks), "v": torch.stack(vs)}
    return _logits(params, x)[:, 0], x[:, 0], new


def prefill(params: EncDec, batch, cfg, mesh=None, cache_len=None):
    """Encode the frames, run the decoder over the tokens with cache
    capture and pad the self caches to ``cache_len`` slots.  Returns
    (logits of the last position (B, V), hidden (B, T, D), caches)."""
    enc_out = encode(params, batch["frames"], cfg, mesh)
    hidden, caches = dec_forward(params, batch["tokens"], enc_out, cfg, mesh, want_cache=True)
    T = hidden.shape[1]
    pad = (cache_len or T) - T
    if pad > 0:
        caches = {**caches, "k": F.pad(caches["k"], (0, 0, 0, 0, 0, pad)),
                  "v": F.pad(caches["v"], (0, 0, 0, 0, 0, pad))}
    return _logits(params, hidden[:, -1:])[:, 0], hidden, caches
