"""Vision-language decoder (Llama-3.2-Vision-11B backbone).

The vision encoder is a stub: the model consumes precomputed patch
embeddings (B, n_img_tokens, d_vision), as numpy arrays or tensors (moved
to the parameters' device), projects them to d_model, and cross-attends
to them from gated cross-attention layers inserted after every
``cross_every``-th self-attention layer (Llama-3.2: 8 cross layers among
40 self layers).

Structure: n_groups = n_layers // cross_every groups, each ``cross_every``
self layers (the dense family's blocks, RoPE at ``cfg.rope_theta``) and
then one gated cross block: ``x + tanh(gate_attn) * xattn(x)``, then ``x +
tanh(gate_ffn) * ffn(x)``, the gates 0-d float32.  Self layer ``g *
cross_every + e`` is layer ``e`` of group ``g``.  The reference draws the
gates as zeros, so a freshly drawn model ignores its images.

The parameters are a :class:`VLM` module with the reference's key paths
(``embed``, ``blocks.<i>.attn.wq``, ``cross_blocks.<g>.xattn.wq``,
``cross_blocks.<g>.gate_attn``, ``img_proj``, ``final_norm``,
``lm_head``); each layer casts its >=2-D float32 weights to the compute
dtype as it runs.  Caches: ``{"self": {"k", "v": (G, cross_every, B, S,
KV, hd)}, "cross": {"xk", "xv": (G, B, n_img, KV, hd)}}``; decode passes
the cross caches on unchanged.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from . import attention as attn
from . import ffn as ffn_mod
from .common import DTYPES, compute_dtype, cross_entropy, dense_init, embed_init, matmul, rmsnorm
from .transformer import Block, _layer_params, _stack, _tokens, _zeros, init_block, logits_fn

__all__ = ["VLM", "n_groups", "init_params", "forward", "loss_fn", "cache_spec", "prefill",
           "decode"]


class VLM(nn.Module):
    """``embed`` (V, D), ``blocks`` (n_layers self blocks), ``cross_blocks``
    (G gated cross blocks), ``img_proj`` (d_vision, D), ``final_norm`` (D,)
    and ``lm_head`` (D, V)."""

    def __init__(self, embed, blocks, cross_blocks, img_proj, final_norm, lm_head):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.blocks = nn.ModuleList(blocks)
        self.cross_blocks = nn.ModuleList(cross_blocks)
        self.img_proj = nn.Parameter(img_proj, requires_grad=False)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.lm_head = nn.Parameter(lm_head, requires_grad=False)


def n_groups(cfg) -> int:
    assert cfg.n_layers % cfg.cross_every == 0, (cfg.n_layers, cfg.cross_every)
    return cfg.n_layers // cfg.cross_every


def _cross_block_init(generator, cfg, device, dtype) -> Block:
    D = cfg.d_model
    return Block(_zeros((D,), device),
                 xattn=attn.attn_params(generator, D, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                        dtype=dtype, device=device),
                 norm2=_zeros((D,), device),
                 ffn=ffn_mod.dense_ffn_params(generator, D, cfg.d_ff, cfg.ffn_kind, dtype,
                                              device),
                 gate_attn=_zeros((), device),
                 gate_ffn=_zeros((), device))


def init_params(generator, cfg, device=None) -> VLM:
    """Random weights by the reference's rules, drawn in order (embedding,
    self blocks, cross blocks, image projection, head), each >=2-D weight
    stored in ``cfg.param_dtype`` as it is drawn; the gates are zeros."""
    device = device if device is not None else generator.device
    pd = DTYPES[cfg.param_dtype]
    D, V = cfg.d_model, cfg.padded_vocab
    embed = embed_init(generator, (V, D), pd, device)
    blocks = [init_block(generator, cfg, kind="dense", device=device, dtype=pd)
              for _ in range(cfg.n_layers)]
    cross = [_cross_block_init(generator, cfg, device, pd) for _ in range(n_groups(cfg))]
    img_proj = dense_init(generator, (cfg.d_vision, D), cfg.d_vision, pd, device)
    head = dense_init(generator, (D, V), D, pd, device)
    return VLM(embed, blocks, cross, img_proj, _zeros((D,), device), head)


def _ffn(x, bp, cfg):
    return ffn_mod.dense_ffn(rmsnorm(x, bp["norm2"], cfg.norm_eps), bp["ffn"], cfg.ffn_kind)


def _gated(x, cp, cfg, c):
    """The cross block after its attention ``c``: both gated residuals."""
    x = x + torch.tanh(cp["gate_attn"]).to(x.dtype) * c
    return x + torch.tanh(cp["gate_ffn"]).to(x.dtype) * _ffn(x, cp, cfg)


def _group_layers(params: VLM, cfg, dt):
    """(group, its self layers' weights, its cross block's weights), in
    order; a self layer's weights are cast as the loop reaches it."""
    E = cfg.cross_every
    for g, cross in enumerate(params.cross_blocks):
        yield g, (_layer_params(b, dt) for b in params.blocks[g * E:(g + 1) * E]), \
            _layer_params(cross, dt)


def _grouped(caches: list, G: int) -> dict:
    """Per-layer self caches as (G, cross_every, ...) tensors."""
    return {name: t.reshape(G, t.shape[0] // G, *t.shape[1:])
            for name, t in _stack(caches).items()}


def forward(params: VLM, tokens, images, cfg, mesh=None, want_cache=False):
    """tokens (B, T), images (B, n_img, d_vision) -> (hidden, (self caches,
    cross caches)), the caches {} unless ``want_cache``."""
    dt = compute_dtype(cfg)
    tokens = _tokens(tokens, params)
    B, T = tokens.shape
    x = params.embed[tokens].to(dt)
    positions = torch.arange(T, device=x.device).expand(B, T)
    images = torch.as_tensor(images, device=x.device)
    img_e = matmul(images.to(dt), params.img_proj.to(dt))
    self_caches, cross_caches = [], []
    for _, selfs, cp in _group_layers(params, cfg, dt):
        for bp in selfs:
            h = rmsnorm(x, bp["norm1"], cfg.norm_eps)
            a, (k, v) = attn.attention(h, bp["attn"], positions, causal=True,
                                       rope_theta=cfg.rope_theta)
            x = x + a
            x = x + _ffn(x, bp, cfg)
            if want_cache:
                self_caches.append({"k": k, "v": v})
        c, (xk, xv) = attn.cross_attention(rmsnorm(x, cp["norm1"], cfg.norm_eps), cp["xattn"],
                                           img_e)
        x = _gated(x, cp, cfg, c)
        if want_cache:
            cross_caches.append({"xk": xk, "xv": xv})
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    if not want_cache:
        return x, ({}, {})
    return x, (_grouped(self_caches, len(params.cross_blocks)), _stack(cross_caches))


def loss_fn(params: VLM, batch, cfg, mesh=None):
    """Next-token CE.  batch: {'tokens', 'labels': (B, T), 'images': (B,
    n_img, d_vision)}."""
    hidden, _ = forward(params, batch["tokens"], batch["images"], cfg, mesh)
    logits = logits_fn(params, hidden, cfg, mesh)
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    loss = cross_entropy(logits, labels, cfg.vocab_size)
    return loss, {"ce": loss, "hidden": hidden}


def cache_spec(cfg, batch: int, seq_len: int) -> dict:
    """The nested caches as ``device="meta"`` tensors."""
    dt = compute_dtype(cfg)
    G, E, KV, hd = n_groups(cfg), cfg.cross_every, cfg.n_kv_heads, cfg.hd

    def sds(shape):
        return torch.empty(shape, dtype=dt, device="meta")

    self_kv, cross_kv = (G, E, batch, seq_len, KV, hd), (G, batch, cfg.n_img_tokens, KV, hd)
    return {"self": {"k": sds(self_kv), "v": sds(self_kv)},
            "cross": {"xk": sds(cross_kv), "xv": sds(cross_kv)}}


def prefill(params: VLM, batch, cfg, mesh=None, cache_len=None):
    """Forward with cache capture, the self caches padded to ``cache_len``
    slots.  Returns (logits of the last position (B, V), hidden, caches)."""
    hidden, (self_caches, cross_caches) = forward(params, batch["tokens"], batch["images"],
                                                  cfg, mesh, want_cache=True)
    T = hidden.shape[1]
    pad = (cache_len or T) - T
    if pad > 0:
        self_caches = {name: F.pad(t, (0, 0, 0, 0, 0, pad)) for name, t in self_caches.items()}
    logits = logits_fn(params, hidden[:, -1:], cfg, mesh)
    return logits[:, 0], hidden, {"self": self_caches, "cross": cross_caches}


def decode(params: VLM, token, caches, pos, cfg, mesh=None):
    """One step.  token: (B,) integers; pos: a scalar or (B,); caches in the
    nested layout (left unmodified).  Returns (logits (B, V), hidden (B,
    D), new caches), the cross caches passed on as they are."""
    dt = compute_dtype(cfg)
    x = params.embed[_tokens(token, params)[:, None]].to(dt)
    pos = torch.as_tensor(pos, device=x.device)
    sk, sv = caches["self"]["k"], caches["self"]["v"]
    xk, xv = caches["cross"]["xk"], caches["cross"]["xv"]
    new = []
    for g, selfs, cp in _group_layers(params, cfg, dt):
        for e, bp in enumerate(selfs):
            h = rmsnorm(x, bp["norm1"], cfg.norm_eps)
            a, kv = attn.decode_attention(h, bp["attn"], {"k": sk[g, e], "v": sv[g, e]}, pos,
                                          rope_theta=cfg.rope_theta)
            x = x + a
            x = x + _ffn(x, bp, cfg)
            new.append(kv)
        h = rmsnorm(x, cp["norm1"], cfg.norm_eps)
        x = _gated(x, cp, cfg, attn.decode_cross_attention(h, cp["xattn"],
                                                           {"k": xk[g], "v": xv[g]}))
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    logits = logits_fn(params, x, cfg, mesh)
    return logits[:, 0], x[:, 0], {"self": _grouped(new, len(params.cross_blocks)),
                                   "cross": caches["cross"]}
